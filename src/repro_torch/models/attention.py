"""Attention mixers: GQA (RoPE, optional sliding window) and MLA (DeepSeek).

The reference's ``repro.models.attention`` in PyTorch.  GQA has three
entry modes, as there:

  * train/prefill without a cache: full sequence, causal (or bidirectional
    for encoders), plain ``_sdpa`` (einsum, float32 softmax), on one
    rank's share under a mesh (:func:`gqa_local`, ``dist/local.py``);
  * prefill against a cache (``s > 1``): the new rows are written at
    ``cache["len"]`` and ``_sdpa`` runs over the whole cache under the
    reference's mask;
  * decode (a cache, ``s == 1``, no sliding window): the new row is
    written, then the hand-written kernel ``kernels.decode_attention``
    attends over the valid prefix.

The reference computes all three in XLA (its Pallas decode kernel is
reached only from its tests); ``_sdpa`` here stays plain PyTorch for the
same reason, and never calls ``scaled_dot_product_attention``.

MLA caches the compressed latent and the shared rope key (its whole
point) and attends with the absorbed scores: ``q_nope·W_uk`` against the
latent plus ``q_rope·k_rope``, each product in the activation dtype, added
in float32, the softmax in float32; the values come from the latent and
``W_uv``.  Its decode step runs the same code over the cache (the
reference's MLA does not reach its decode kernel either).  Both mixers
write a prefill's or decode step's new rows into the caller's cache
tensors in place.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.dist import ctx as shard_ctx
from repro_torch.kernels import decode_attention as decode_kernel

from .config import MLAConfig, ModelConfig
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


def _attend(q, k, v, n_rep: int, causal: bool, window: int, chunk: int, start: int = 0):
    """Cache-free attention of the queries at positions ``start`` on over
    every key: in query chunks of ``chunk`` where they divide (the
    [B,H,S,T] scores shrink to [B,H,chunk,T]), else at once."""
    s, t = q.shape[1], k.shape[1]
    if not (chunk and s > chunk and s % chunk == 0):
        chunk = s
    outs = []
    for i in range(0, s, chunk):
        m = causal_mask(chunk, t, window, offset=start + i, device=q.device) if causal else None
        outs.append(_sdpa(q[:, i:i + chunk], k, v, m, n_rep))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


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


def gqa_local(params: GQA, x, cfg: ModelConfig, positions, causal: bool, lay):
    """Cache-free GQA (training, an encoder's forward) of a normed input on
    one rank's share, ``lay`` a ``dist.local.Local`` (x [b, S, D] the rank's
    rows, whole; ``positions`` [b, S]).  Two routes:

      * heads, where "model" divides the heads and the KV heads or the head
        dim: the rank's query heads, ``wo``'s rows of those heads and one
        all-reduce of the output; its KV heads, or where "model" does not
        divide them its columns of every KV head's projection, all-gathered;
      * positions, where it does not: the rank's query positions against
        every key, K and V projected for its positions and all-gathered,
        the output all-gathered; the weights whole.

    Masked scores are computed as on one device, so each rank's products
    are its share.  Where "model" divides neither the heads nor the
    positions, every rank computes the whole."""
    h, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rep, s, m = h // hk, x.shape[1], lay.m
    heads = h % m == 0 and (hk % m == 0 or hd % m == 0)
    if not heads and s % m:
        lay, m, heads = lay.whole(), 1, True
    if heads:
        hl = h // m
        x = lay.enter(x)
        q = apply_rope(torch.einsum("bsd,dhk->bshk", x, lay.weight(params.wq, 1)),
                       positions, cfg.rope_theta)
        by_heads = hk % m == 0  # this rank's KV heads, else its columns of each
        k, v = (torch.einsum("bsd,dhk->bshk", x, lay.weight(w, 1 if by_heads else 2))
                for w in (params.wk, params.wv))
        if not by_heads:
            k, v = (lay.gather(t, 3, partial=True) for t in (k, v))
        k = apply_rope(k, positions, cfg.rope_theta)
        if not by_heads:  # the KV head of each of this rank's query heads
            kv = torch.div(torch.arange(lay.r * hl, (lay.r + 1) * hl, device=x.device), rep,
                           rounding_mode="floor")
            k, v, rep = k.index_select(2, kv), v.index_select(2, kv), 1
        out = _attend(q, k, v, rep, causal, cfg.attn_window, cfg.attn_q_chunk)
        return lay.leave(torch.einsum("bshk,hkd->bsd", out, lay.weight(params.wo, 0)))
    # positions
    sl = s // m
    p0 = lay.r * sl
    x = lay.split(x, 1)
    positions = positions[:, p0:p0 + sl]
    wq, wk, wv, wo = (lay.weight(w, partial=True)
                      for w in (params.wq, params.wk, params.wv, params.wo))
    q = apply_rope(torch.einsum("bsd,dhk->bshk", x, wq), positions, cfg.rope_theta)
    k = apply_rope(torch.einsum("bsd,dhk->bshk", x, wk), positions, cfg.rope_theta)
    k = lay.gather(k, 1, partial=True)
    v = lay.gather(torch.einsum("bsd,dhk->bshk", x, wv), 1, partial=True)
    out = _attend(q, k, v, rep, causal, cfg.attn_window, cfg.attn_q_chunk, start=p0)
    return lay.gather(torch.einsum("bshk,hkd->bsd", out, wo), 1, partial=False)


def gqa_apply(
    params: GQA,
    x,  # [B, S, D]
    cfg: ModelConfig,
    positions,  # [B, S] int32
    cache: dict,  # {"k":[B,T,Hk,hd], "v":..., "len": int}
    causal: bool = True,
    decode_len: torch.Tensor | None = None,  # [B] int32, decode_lengths()
):
    """GQA against a cache (prefill and decode; the cache-free path is
    :func:`gqa_local`).  Returns (y, the cache with its new length)."""
    b, s, _ = x.shape
    n_rep = cfg.n_heads // cfg.n_kv_heads
    q = torch.einsum("bsd,dhk->bshk", x, params.wq)
    k = torch.einsum("bsd,dhk->bshk", x, params.wk)
    v = torch.einsum("bsd,dhk->bshk", x, params.wv)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    # heads over "model" when a mesh is active (the identity otherwise)
    q = shard_ctx.constrain_heads(q)

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
    y = torch.einsum("bshk,hkd->bsd", out, params.wo)
    return y, {"k": ck, "v": cv, "len": start + s}


def gqa_cache_init(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, device="cuda"):
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "len": 0,
    }


# --------------------------------------------------------------------------- #
# MLA (multi-head latent attention, DeepSeek-V2)
# --------------------------------------------------------------------------- #


class MLA(nn.Module):
    """Parameters ``wq`` [D, H, nope+rope] (full-rank q: V2-Lite has no q
    LoRA), ``w_dkv`` [D, R], ``w_krope`` [D, rd], ``w_uk`` [R, H, nope],
    ``w_uv`` [R, H, vd] and ``wo`` [H, vd, D], the reference's layout."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        m: MLAConfig = cfg.mla
        d, h = cfg.d_model, cfg.n_heads
        self.wq = _param((d, h, m.qk_nope_head_dim + m.qk_rope_head_dim), dtype, device)
        self.w_dkv = _param((d, m.kv_lora_rank), dtype, device)
        self.w_krope = _param((d, m.qk_rope_head_dim), dtype, device)
        self.w_uk = _param((m.kv_lora_rank, h, m.qk_nope_head_dim), dtype, device)
        self.w_uv = _param((m.kv_lora_rank, h, m.v_head_dim), dtype, device)
        self.wo = _param((h, m.v_head_dim, d), dtype, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        # each is the reference's dense_init of its first axis against the rest
        # (wo: the first two against the last), reshaped
        for w in (self.wq, self.w_dkv, self.w_krope, self.w_uk, self.w_uv, self.wo):
            d_in = w.shape[0] * (w.shape[1] if w is self.wo else 1)
            w.data.copy_(dense_init(gen, d_in, w.numel() // d_in, w.dtype).reshape(w.shape))


def mla_apply(
    params: MLA,
    x,  # [B, S, D]
    cfg: ModelConfig,
    positions,  # [B, S] int32
    cache: dict | None = None,  # {"latent":[B,T,R], "krope":[B,T,rd], "len": int}
    causal: bool = True,
):
    m: MLAConfig = cfg.mla
    b, s, _ = x.shape
    q = torch.einsum("bsd,dhk->bshk", x, params.wq)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    latent = torch.einsum("bsd,dr->bsr", x, params.w_dkv)  # [B,S,R]
    krope = torch.einsum("bsd,dr->bsr", x, params.w_krope)[:, :, None, :]
    krope = apply_rope(krope, positions, cfg.rope_theta)[:, :, 0]  # [B,S,rd]

    if cache is not None:
        start = cache["len"]
        latent_all, krope_all = cache["latent"], cache["krope"]
        t = latent_all.shape[1]
        if start + s > t:
            raise ValueError(f"cache of {t} positions holds {start}; {s} more do not fit")
        latent_all[:, start:start + s] = latent.to(latent_all.dtype)
        krope_all[:, start:start + s] = krope.to(krope_all.dtype)
        new_cache = {"latent": latent_all, "krope": krope_all, "len": start + s}
        kpos = torch.arange(t, device=x.device)[None, None, :]
        mask = kpos < (start + s)
        if causal:
            mask = mask & (kpos <= positions[:, :, None])
    else:
        latent_all, krope_all = latent, krope
        new_cache = None
        if causal:
            mask = torch.arange(s, device=x.device)[None, None, :] <= positions[:, :, None]
        else:
            mask = torch.ones((b, s, s), dtype=torch.bool, device=x.device)

    # absorbed attention: score = q_nope·(W_uk·latent) + q_rope·k_rope,
    # W_uk folded into q (q_lat [B,S,H,R])
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, params.w_uk)
    logits = torch.einsum("bshr,btr->bhst", q_lat, latent_all).float()
    logits = logits + torch.einsum("bshk,btk->bhst", q_rope, krope_all).float()
    logits = logits / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    logits = logits + torch.where(mask[:, None], 0.0, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    # values from the latent, W_uv on the output side
    ctx = torch.einsum("bhst,btr->bshr", probs, latent_all)  # [B,S,H,R]
    v_ctx = torch.einsum("bshr,rhk->bshk", ctx, params.w_uv)  # [B,S,H,vd]
    y = torch.einsum("bshk,hkd->bsd", v_ctx, params.wo)
    return y, new_cache


def mla_cache_init(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, device="cuda"):
    m: MLAConfig = cfg.mla
    return {
        "latent": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype, device=device),
        "krope": torch.zeros((batch, max_len, m.qk_rope_head_dim), dtype=dtype, device=device),
        "len": 0,
    }
