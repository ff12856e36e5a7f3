"""Optimizers written out (no ``torch.optim``): AdamW and Adafactor.

The reference's ``repro.train.optimizer`` on the port's parameters.  Both
keep float32 state, compute in float32 and cast the new parameter to its
own dtype (``torch.optim.AdamW`` would keep bfloat16 moments for bfloat16
parameters).  The parameters are updated in place, where the reference's
jitted step donates its state.

``params`` is a ``Model`` (its named parameters) or a flat dict of tensors;
``grads`` a dict with the same names.  The state's leaves are keyed by
those names, so ``dist.sharding.param_specs`` places them as it places the
parameters, as the reference shards its optimizer state like its params.

Adafactor's statistics depend on how leaves are grouped: it factors every
leaf of rank 2 or more and clips each leaf's update by its RMS.  The
reference stacks each scan-unit position's layers on a leading axis, so a
layer's ``[D]`` norm scale is one row of a ``[L, D]`` leaf there, factored,
and every update RMS is taken over all layers of the leaf.  The port's
Adafactor keeps the stats of those same stacked groups
(``convert.reference_groups``), keyed by the reference's leaf paths
(``blocks/<u>/mixer/wq``), each layer's own (``convert.reference_tree``
stacks them), and computes them layer by layer: a layer's rows and columns
from its own gradient (the columns of a stack of vectors from all of
them), the update clip's RMS from the layers' sums of squares, so no rank
stacks a group's parameters, gradients or stats.  AdamW is elementwise, so its moments are kept
per parameter.
"""
from __future__ import annotations

import functools
import math

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.models.convert import per_layer_stat, reference_groups
from repro_torch.tree import tree_leaves, tree_map


def _leaves(params) -> dict[str, torch.Tensor]:
    return dict(params.named_parameters()) if isinstance(params, nn.Module) else params


def _device(leaves: dict[str, torch.Tensor]) -> torch.device:
    return next(iter(leaves.values())).device


def global_norm(tree) -> torch.Tensor:
    leaves = [x.float().square().sum() for x in tree_leaves(tree)]
    return torch.stack(leaves).sum().sqrt()


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


# --------------------------------------------------------------------------- #
# AdamW
# --------------------------------------------------------------------------- #


def adamw_init(params) -> dict:
    leaves = _leaves(params)

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {
        "m": {n: zeros(p) for n, p in leaves.items()},
        "v": {n: zeros(p) for n, p in leaves.items()},
        "count": torch.zeros((), dtype=torch.int32, device=_device(leaves)),
    }


@torch.no_grad()
def adamw_update(
    params,
    grads,
    state: dict,
    lr: float | torch.Tensor = 1e-3,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
):
    """One step; ``params`` and the state's tensors change in place.
    Returns (params, state), as the reference returns its new ones."""
    count = state["count"] + 1
    c1 = 1.0 - b1 ** count.float()
    c2 = 1.0 - b2 ** count.float()
    for name, p in _leaves(params).items():
        g32 = grads[name].float()
        m, v = state["m"][name], state["v"][name]
        m.copy_(b1 * m + (1 - b1) * g32)
        v.copy_(b2 * v + (1 - b2) * g32.square())
        step = (m / c1) / ((v / c2).sqrt() + eps)
        p32 = p.float()
        p.copy_(p32 - lr * (step + weight_decay * p32))
    state["count"] = count
    return params, state


# --------------------------------------------------------------------------- #
# Adafactor (factored second moments; memory ~ params/row+col)
# --------------------------------------------------------------------------- #


def _groups(params) -> dict[str, str | list[str]]:
    """The optimizer's leaves: the reference's stacked groups for a model
    (``convert.reference_groups``), else every tensor its own leaf."""
    if isinstance(params, nn.Module):
        return reference_groups(params)
    return {n: n for n in params}


def adafactor_init(params) -> dict:
    """Zero stats for the reference's leaves: a leaf of rank 2 or more (a
    stacked group counts its layer axis) factored into rows ``vr`` and
    columns ``vc``, else ``v``.  A stacked group's stats are lists of each
    layer's own (``convert.reference_tree`` stacks them), but for the
    columns of a stack of vectors, one tensor."""
    leaves = _leaves(params)

    def zeros(shape, device):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    out = {}
    for key, names in _groups(params).items():
        stacked = not isinstance(names, str)
        first = leaves[names[0] if stacked else names]
        shape, dev = tuple(first.shape), first.device
        if len(shape) + stacked < 2:
            shapes = {"v": shape}
        elif stacked and len(shape) == 1:
            shapes = {"vr": (), "vc": shape}
        else:
            shapes = {"vr": shape[:-1], "vc": shape[:-2] + shape[-1:]}
        out[key] = {
            stat: [zeros(sh, dev) for _ in names]
            if stacked and per_layer_stat(stat, len(shape)) else zeros(sh, dev)
            for stat, sh in shapes.items()}
    return {"stats": out, "count": torch.zeros((), dtype=torch.int32, device=_device(leaves))}


def _in_layout_of(stat, g, axis: int):
    """``stat``, ``g`` reduced over ``axis``, in ``g``'s layout less that
    axis (a DTensor redistributed; a small one), so that its product with
    ``g`` moves nothing of ``g``'s size."""
    if not isinstance(g, DTensor):
        return stat
    want = [Shard(p.dim - (p.dim > axis)) if isinstance(p, Shard) and p.dim != axis
            else Replicate() for p in g.placements]
    return stat.redistribute(stat.device_mesh, want)


def _factored(gs: list, s: dict, beta, eps: float) -> list:
    """Each layer's update ``g / sqrt(v)`` of one leaf (``gs``, a layer's
    gradient each), its stats ``s`` updated in place (``adafactor_init``):
    the reference's factored rows and columns, or the whole second moment."""
    g2s = [g.square() + eps for g in gs]

    def rows(stat):  # the stat's tensor for each layer
        t = s[stat]
        return t if isinstance(t, list) else [t]

    if "v" in s:
        vs = rows("v")
        for v, g2 in zip(vs, g2s):
            v.copy_(beta * v + (1 - beta) * g2)
        return [g * torch.rsqrt(v + eps) for g, v in zip(gs, vs)]
    vrs = rows("vr")
    if isinstance(s["vr"], list) and not isinstance(s["vc"], list):
        # a stack of vectors: a row per layer, the columns over the layers
        for vr, g2 in zip(vrs, g2s):
            vr.copy_(beta * vr + (1 - beta) * g2.mean())
        vc = s["vc"]
        vc.copy_(beta * vc + (1 - beta) * functools.reduce(torch.add, g2s) / len(g2s))
        denom = torch.clamp(functools.reduce(torch.add, vrs) / len(vrs), min=eps)
        return [g * torch.rsqrt(vr / denom * vc + eps) for g, vr in zip(gs, vrs)]
    out = []
    for g, g2, vr, vc in zip(gs, g2s, vrs, rows("vc")):
        vr.copy_(beta * vr + (1 - beta) * g2.mean(dim=-1))
        vc.copy_(beta * vc + (1 - beta) * g2.mean(dim=-2))
        denom = torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps)
        r = _in_layout_of(vr / denom, g, g.ndim - 1)
        c = _in_layout_of(vc, g, g.ndim - 2)
        out.append(g * torch.rsqrt(r[..., None] * c[..., None, :] + eps))
    return out


@torch.no_grad()
def adafactor_update(
    params,
    grads,
    state: dict,
    lr: float | torch.Tensor = 1e-2,
    decay: float = 0.8,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    weight_decay: float = 0.0,
):
    """One step over the reference's leaves, layer by layer on each layer's
    own tensor (its local shard under a mesh; no group is stacked);
    ``params`` and the stats change in place.  Returns (params, state)."""
    count = state["count"] + 1
    beta = 1.0 - count.float() ** (-decay)
    leaves = _leaves(params)
    for key, names in _groups(params).items():
        stacked = not isinstance(names, str)
        layers = names if stacked else [names]
        updates = _factored([grads[n].float() for n in layers], state["stats"][key], beta, eps)
        # update clipping (RMS <= clip_threshold) over the whole leaf: the
        # layers' sums of squares added (under a mesh, one scalar all-reduce)
        sq = functools.reduce(torch.add, [u.square().sum() for u in updates])
        rms = (sq / sum(u.numel() for u in updates) + eps).sqrt()
        scale = torch.clamp(rms / clip_threshold, min=1.0)
        for name, update in zip(layers, updates):
            p = leaves[name]
            p32 = p.float()
            p.copy_(p32 - lr * (update / scale + weight_decay * p32))
    state["count"] = count
    return params, state


# --------------------------------------------------------------------------- #
# Schedules
# --------------------------------------------------------------------------- #


def cosine_schedule(step, base_lr: float, warmup: int, total: int, min_frac: float = 0.1):
    step = step.float() if isinstance(step, torch.Tensor) else torch.tensor(float(step))
    warm = base_lr * step / max(1.0, warmup)
    progress = torch.clamp((step - warmup) / max(1.0, total - warmup), 0.0, 1.0)
    cos = base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * progress)))
    return torch.where(step < warmup, warm, cos)


OPTIMIZERS = {
    "adamw": (adamw_init, adamw_update),
    "adafactor": (adafactor_init, adafactor_update),
}


def pick_optimizer(cfg) -> str:
    """Adafactor for >=100B-param configs, else AdamW."""
    return "adafactor" if cfg.param_count() >= 100e9 else "adamw"
