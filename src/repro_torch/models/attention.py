"""GQA attention (RoPE, optional sliding window) with a KV cache.

The reference's ``repro.models.attention`` GQA part, in PyTorch.  Three
entry modes, as there:

  * train/prefill without a cache: full sequence, causal (or bidirectional
    for encoders), plain ``_sdpa`` (einsum, float32 softmax);
  * prefill against a cache (``s > 1``): the new rows are written at
    ``cache["len"]`` and ``_sdpa`` runs over the whole cache under the
    reference's mask;
  * decode (a cache, ``s == 1``, no sliding window): the new row is
    written, then the hand-written kernel ``kernels.decode_attention``
    attends over the valid prefix.

The reference computes all three in XLA (its Pallas decode kernel is
reached only from its tests); ``_sdpa`` here stays plain PyTorch for the
same reason, and never calls ``scaled_dot_product_attention``.  MLA comes
with its own port (ROADMAP §1).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.dist import ctx as shard_ctx
from repro_torch.kernels import decode_attention as decode_kernel

from .config import ModelConfig
from .layers import _param, apply_rope, dense_init

NEG_INF = -1e30


class GQA(nn.Module):
    """Parameters ``wq`` [D, H, hd], ``wk``/``wv`` [D, Hk, hd], ``wo``
    [H, hd, D], the reference's layout."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, h, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.wq = _param((d, h, hd), dtype, device)
        self.wk = _param((d, hk, hd), dtype, device)
        self.wv = _param((d, hk, hd), dtype, device)
        self.wo = _param((h, hd, d), dtype, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv):
            w.data.copy_(dense_init(gen, w.shape[0], w.shape[1] * w.shape[2],
                                    w.dtype).reshape(w.shape))
        wo = self.wo
        wo.data.copy_(dense_init(gen, wo.shape[0] * wo.shape[1], wo.shape[2],
                                 wo.dtype).reshape(wo.shape))


def _sdpa(q, k, v, mask, n_rep: int):
    """q:[B,S,H,hd] k,v:[B,T,Hk,hd] mask:[B,1,S,T] or None -> [B,S,H,hd].

    K/V are repeated up to the full head count, as the reference does.
    Scores come out of the einsum in the activation dtype, the softmax runs
    in float32 and the probabilities go back to v's dtype.
    """
    hd = q.shape[-1]
    if n_rep > 1:
        k = k.repeat_interleave(n_rep, dim=2)
        v = v.repeat_interleave(n_rep, dim=2)
    logits = torch.einsum("bshd,bthd->bhst", q, k).float()
    logits = logits / math.sqrt(hd)
    if mask is not None:
        logits = logits + torch.where(mask, 0.0, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def causal_mask(s: int, t: int, window: int = 0, offset: int = 0, device=None):
    """[1, 1, s, t] True=keep. offset = position of query 0 within the keys."""
    qpos = torch.arange(s, device=device)[:, None] + offset
    kpos = torch.arange(t, device=device)[None, :]
    m = kpos <= qpos
    if window > 0:
        m &= kpos > qpos - window
    return m[None, None]


def _sdpa_qchunked(q, k, v, n_rep: int, causal: bool, window: int, chunk: int):
    """Query-chunked attention: the [B,H,S,T] scores shrink to [B,H,chunk,T]."""
    s = q.shape[1]
    outs = []
    for i in range(0, s, chunk):
        m = (causal_mask(chunk, k.shape[1], window, offset=i, device=q.device)
             if causal else None)
        outs.append(_sdpa(q[:, i:i + chunk], k, v, m, n_rep))
    return torch.cat(outs, dim=1)


def decode_lengths(positions: torch.Tensor, start: int, causal: bool = True) -> torch.Tensor:
    """The [B] int32 valid lengths of one decode step's cache.

    The reference keeps key t where ``t < start + 1`` and, when causal,
    ``t <= positions[b, 0]``: that is ``t < min(positions[b, 0], start) + 1``
    (exact even when a caller's position disagrees with the cache length).
    ``start`` is a host int, so nothing syncs.
    """
    if not causal:
        return torch.full((positions.shape[0],), start + 1, dtype=torch.int32,
                          device=positions.device)
    return (positions[:, 0].clamp(max=start) + 1).clamp(min=0).to(torch.int32)


def gqa_apply(
    params: GQA,
    x,  # [B, S, D]
    cfg: ModelConfig,
    positions,  # [B, S] int32
    cache: dict | None = None,  # {"k":[B,T,Hk,hd], "v":..., "len": int}
    causal: bool = True,
    decode_len: torch.Tensor | None = None,  # [B] int32, decode_lengths()
):
    b, s, _ = x.shape
    n_rep = cfg.n_heads // cfg.n_kv_heads
    q = torch.einsum("bsd,dhk->bshk", x, params.wq)
    k = torch.einsum("bsd,dhk->bshk", x, params.wk)
    v = torch.einsum("bsd,dhk->bshk", x, params.wv)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    # heads over "model" when a mesh is active (the identity otherwise)
    q = shard_ctx.constrain_heads(q)

    if cache is not None:
        start = cache["len"]
        ck, cv = cache["k"], cache["v"]
        t = ck.shape[1]
        if start + s > t:
            raise ValueError(f"cache of {t} positions holds {start}; {s} more do not fit")
        # the reference's cache is immutable (dynamic_update_slice); the port
        # writes the new rows into the caller's cache tensors in place
        ck[:, start:start + s] = k.to(ck.dtype)
        cv[:, start:start + s] = v.to(cv.dtype)
        if s == 1 and cfg.attn_window == 0:
            if decode_len is None:
                decode_len = decode_lengths(positions, start, causal)
            out = decode_kernel.decode_attention(q[:, 0], ck, cv, decode_len)[:, None]
        else:
            kpos = torch.arange(t, device=x.device)[None, :]
            valid = kpos < (start + s)
            if causal:
                m = (kpos[None] <= positions[:, :, None]) & valid[:, None]
            else:
                m = valid[:, None].expand(b, s, t)
            if cfg.attn_window > 0:
                m = m & (kpos[None] > (positions[:, :, None] - cfg.attn_window))
            out = _sdpa(q, ck, cv, m[:, None], n_rep)
        new_cache = {"k": ck, "v": cv, "len": start + s}
    else:
        chunk = cfg.attn_q_chunk
        if chunk and s > chunk and s % chunk == 0:
            out = _sdpa_qchunked(q, k, v, n_rep, causal, cfg.attn_window, chunk)
        else:
            m = causal_mask(s, s, cfg.attn_window, device=x.device) if causal else None
            out = _sdpa(q, k, v, m, n_rep)
        new_cache = None
    y = torch.einsum("bshk,hkd->bsd", out, params.wo)
    return y, new_cache


def gqa_cache_init(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, device="cuda"):
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "len": 0,
    }
