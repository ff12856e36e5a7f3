"""Mixture-of-Experts FFN: top-k router + capacity-based sorted dispatch.

The reference's ``repro.models.moe`` in PyTorch, with its three structural
choices:

  * gather-only dispatch and combine (``torch.gather``), with the
    reference's ``in_use`` mask and its clamps on ``take`` and ``slot``;
  * group-local routing: the tokens are cut into ``dp``-size groups aligned
    with the data shards when a mesh is active and each group holds at
    least ``num_experts`` tokens (``dist.ctx.moe_groups``);
  * the heavy ``[G, E, C, ·]`` tensors pinned by the sharding context (G
    over the data dims, E over "model" when it divides), the identity
    without a mesh.

The router runs in float32 (its weight is a float32 leaf in every model),
the top-k gates are renormalised, the capacity is the reference's
``C = ceil(T_group·k/E · capacity_factor)`` computed as it does, and the
tokens over an expert's capacity are dropped.  Shared experts (DeepSeek)
are a SwiGLU of ``d_ff_expert · num_shared`` added densely.

``lax.top_k`` breaks ties to the lower index and ``torch.topk`` promises
no order, so the top k come from a stable descending sort, which keeps the
lower index first; the dispatch order is a stable argsort, as the
reference's.  The expert products stay ``torch.einsum``: the reference
computes them in XLA, outside any Pallas kernel.

Two entry points.  :func:`moe_apply` runs on DTensors (the steps with a
cache); under a mesh every reshape of the token or expert tensors is
pinned on both sides (``_reshape``).  :func:`moe_local` is the cache-free
forward on one rank's share (``dist/local.py``): the rank routes the
groups its rows hold and computes its columns of every expert.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.dist import ctx as shard_ctx

from .config import ModelConfig, MoEConfig
from .layers import MLP, _param, dense_init


class MoE(nn.Module):
    """Parameters ``router`` [D, E] (float32), ``w_gate``/``w_up`` [E, D, F],
    ``w_down`` [E, F, D] and, with shared experts, ``shared`` (a SwiGLU of
    width F · num_shared): the reference's tree."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        m: MoEConfig = cfg.moe
        d, e, f = cfg.d_model, m.num_experts, m.d_ff_expert
        self.router = _param((d, e), torch.float32, device)
        self.w_gate = _param((e, d, f), dtype, device)
        self.w_up = _param((e, d, f), dtype, device)
        self.w_down = _param((e, f, d), dtype, device)
        if m.num_shared:
            self.shared = MLP("swiglu", d, f * m.num_shared, dtype, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        # the shared SwiGLU is an MLP and resets itself
        d = self.router.shape[0]
        self.router.data.copy_(dense_init(gen, d, self.router.shape[1], torch.float32))
        for w in (self.w_gate, self.w_up, self.w_down):
            # every bank is scaled by 1/sqrt(d_model), w_down too, as the
            # reference's; drawn an expert at a time (a float32 bank of
            # llama4's is 21.5 GB)
            for e in range(w.shape[0]):
                draw = torch.randn(w.shape[1:], generator=gen, dtype=torch.float32,
                                   device=gen.device)
                w.data[e].copy_(draw.mul_(1.0 / math.sqrt(d)))


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.bfloat16, device="cuda") -> MoE:
    """An ``MoE`` with random weights drawn from ``gen``."""
    mod = MoE(cfg, dtype, device)
    for sub in mod.modules():  # the MoE's own leaves, then the shared SwiGLU's
        sub.reset_parameters(gen)
    return mod


def _route(params: MoE, xg: torch.Tensor, m: MoEConfig, capacity: int):
    """Per-group routing indices (cheap int and float32 ops, batched over G).

    xg: [G, Tg, D] ->
      take  [G, E, C]   positions into the expert-sorted token axis
      in_use[G, E, C]   capacity mask
      slot  [G, Tg*k]   result row per (token, slot) in sorted order
      inv   [G, Tg*k]   inverse sort permutation
      sgate [G, Tg*k]   gate per sorted entry (0 when dropped)
      stok  [G, Tg*k]   token index per sorted entry
    Index tensors are int64 (what ``torch.gather`` takes).
    """
    logits = torch.einsum("gtd,de->gte", xg.float(), params.router.float())
    return _route_logits(logits, m, capacity)


def _route_logits(logits: torch.Tensor, m: MoEConfig, capacity: int):
    """:func:`_route` from the router's float32 logits [G, Tg, E]."""
    g, tg, _ = logits.shape
    k, n_exp = m.top_k, m.num_experts
    tk = tg * k
    dev = logits.device
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k: the k largest, ties to the lower index (module docstring)
    sorted_probs, sorted_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = sorted_probs[..., :k], sorted_idx[..., :k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    flat_expert = expert_idx.reshape(g, tk)
    flat_token = torch.arange(tg, device=dev).repeat_interleave(k).expand(g, tk)
    flat_gate = gate_vals.reshape(g, tk)
    order = torch.argsort(flat_expert, dim=-1, stable=True)
    se = torch.gather(flat_expert, 1, order)
    stok = torch.gather(flat_token, 1, order)
    sgate = torch.gather(flat_gate, 1, order)
    # first[e]: where expert e's run starts in the sorted entries, the
    # reference's searchsorted of 0..E in se, as running sums of the counts
    # (the same integers; DTensor has no sharding rule for searchsorted)
    counts_all = (se[..., None] == torch.arange(n_exp, device=dev)).sum(dim=1)
    first = torch.cat([torch.zeros_like(counts_all[:, :1]), counts_all.cumsum(dim=1)], dim=1)
    pos = torch.arange(tk, device=dev) - torch.gather(first, 1, se)
    kept = pos < capacity
    cpos = torch.arange(capacity, device=dev)
    take = first[:, :-1, None] + cpos
    counts = first[:, 1:] - first[:, :-1]
    in_use = cpos < counts.clamp(max=capacity)[..., None]
    slot = (se * capacity + pos).clamp(max=n_exp * capacity - 1)
    inv = torch.argsort(order, dim=-1)
    return take.clamp(max=tk - 1), in_use, slot, inv, sgate * kept.float(), stok


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[g, idx[g, i], :]``: a gather of whole rows, [G, N, D]."""
    return torch.gather(x, 1, idx[..., None].expand(*idx.shape, x.shape[-1]))


def capacity_of(tg: int, m: MoEConfig) -> int:
    """The reference's expression, in its order of operations (numpy's
    float64 ceil of ``tg * k / E * capacity_factor``)."""
    return int(np.ceil(tg * m.top_k / m.num_experts * m.capacity_factor))


def _reshape(x: torch.Tensor, *shape) -> torch.Tensor:
    """``x.reshape(shape)`` with axis 0 over the data dims and the rest whole
    on both sides, forward and backward (``dist.ctx.constrain_groups``; the
    identity without a mesh)."""
    return shard_ctx.constrain_groups(shard_ctx.constrain_groups(x).reshape(shape))


def moe_apply(params: MoE, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D]."""
    m: MoEConfig = cfg.moe
    b, s, d = x.shape
    groups = shard_ctx.moe_groups(b * s, m.num_experts)
    tg = b * s // groups
    xg = _reshape(x, groups, tg, d)

    capacity = capacity_of(tg, m)
    take, in_use, slot, inv, sgate, stok = _route(params, xg, m, capacity)

    # heavy tensors: explicit G-indexed products, pinned G x data / E x model
    xs_sorted = _rows(xg, stok)  # [G, Tk, D]
    h = _reshape(_rows(xs_sorted, take.reshape(groups, -1)), groups, m.num_experts, capacity, d)
    h = h * in_use[..., None].to(h.dtype)
    h = shard_ctx.constrain_experts(h)

    gated = F.silu(torch.einsum("gecd,edf->gecf", h, params.w_gate))
    up = torch.einsum("gecd,edf->gecf", h, params.w_up)
    out_e = torch.einsum("gecf,efd->gecd", gated * up, params.w_down)
    out_e = shard_ctx.constrain_experts(out_e)
    out_flat = _reshape(out_e, groups, m.num_experts * capacity, d)

    contrib = _rows(out_flat, slot)
    contrib = contrib * sgate[..., None].to(contrib.dtype)
    y = _rows(contrib, inv)
    y = _reshape(y, groups, tg, m.top_k, d).sum(dim=2)
    y = shard_ctx.constrain_groups(y)

    if m.num_shared:
        y = y + _reshape(params.shared(_reshape(xg, groups * tg, d)), groups, tg, d)
    return _reshape(y, b, s, d)


def moe_local(params: MoE, x: torch.Tensor, cfg: ModelConfig, lay) -> torch.Tensor:
    """:func:`moe_apply` of a normed input on one rank's share, ``lay`` a
    ``dist.local.Local`` (x [b, S, D] the rank's rows, whole over "model").

    The routing is the reference's: ``dist.ctx.moe_groups`` of the whole
    microbatch's tokens, the capacity of a group and the float32 router.
    Groups are runs of whole rows, one per data shard, so the rank routes
    the groups its rows hold; where its rows hold no whole group (one group
    over rows split across ranks), it routes every row and keeps its own.
    The expert banks [E, D, F] are split over "model" on F, as the dense MLP
    (``mlp_local``): each rank computes its columns of every expert's gate
    and up and the matching rows of ``w_down``, the shared experts the same
    way, and one all-reduce adds the output.  The router's logits are
    computed for this rank's part of the tokens and all-gathered, so each
    rank computes its share of them too.  Every gradient into ``x`` is a
    partial sum over "model" (``lay.enter`` adds them)."""
    m: MoEConfig = cfg.moe
    if params.w_up.shape[-1] % lay.m or (m.num_shared and params.shared.w_up.shape[-1] % lay.m):
        lay = lay.whole()
    b, s, _ = x.shape
    groups = shard_ctx.moe_groups(b * lay.pieces * s, m.num_experts)
    if groups % lay.pieces:
        return _moe_groups(params, lay.all_rows(x), cfg, lay, groups)[lay.rows]
    return _moe_groups(params, x, cfg, lay, groups // lay.pieces)


def _moe_groups(params: MoE, x, cfg: ModelConfig, lay, groups: int):
    """:func:`moe_local` of rows ``x`` cut into ``groups`` routing groups."""
    m: MoEConfig = cfg.moe
    b, s, d = x.shape
    tg = b * s // groups
    x = lay.enter(x)
    xg = x.reshape(groups, tg, d)
    capacity = capacity_of(tg, m)

    # the router on this rank's part of the tokens, its logits gathered
    router = lay.weight(params.router, partial=True).float()
    flat = xg.reshape(groups * tg, d)
    part = flat.shape[0] // lay.m
    if lay.m > 1 and flat.shape[0] % lay.m == 0:
        logits = flat[lay.r * part:(lay.r + 1) * part].float() @ router
        logits = lay.gather(logits, 0, partial=True)
    else:
        logits = flat.float() @ router
    take, in_use, slot, inv, sgate, stok = _route_logits(
        logits.reshape(groups, tg, m.num_experts), m, capacity)

    h = _rows(_rows(xg, stok), take.reshape(groups, -1))
    h = h.reshape(groups, m.num_experts, capacity, d) * in_use[..., None].to(x.dtype)
    gated = F.silu(torch.einsum("gecd,edf->gecf", h, lay.weight(params.w_gate, 2)))
    up = torch.einsum("gecd,edf->gecf", h, lay.weight(params.w_up, 2))
    out_e = torch.einsum("gecf,efd->gecd", gated * up, lay.weight(params.w_down, 1))
    contrib = _rows(out_e.reshape(groups, m.num_experts * capacity, d), slot)
    contrib = contrib * sgate[..., None].to(contrib.dtype)
    y = _rows(contrib, inv).reshape(groups, tg, m.top_k, d).sum(dim=2)
    if m.num_shared:
        sh = params.shared
        y = y + sh.apply_with(flat, lay.weight(sh.w_up, 1), lay.weight(sh.w_down, 0),
                              lay.weight(sh.w_gate, 1)).reshape(groups, tg, d)
    return lay.leave(y.reshape(b, s, d))
