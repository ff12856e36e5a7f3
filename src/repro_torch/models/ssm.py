"""State-space / linear-attention mixers: Mamba (S6) and RWKV-6 "Finch".

The reference's ``repro.models.ssm`` in PyTorch.  Both are O(S) in
sequence length.  Prefill and training run a Python loop over time where
the reference runs ``lax.scan``; decode is one recurrent step against a
fixed-size state, no KV growth.  The state stays float32 in every model.

Mamba follows the S6 selective-scan recurrence (discretised zero-order hold):
    h_t = exp(Δ_t ⊙ A) h_{t-1} + Δ_t B_t x_t ;   y_t = C_t h_t + D x_t
RWKV-6 has a data-dependent decay:
    S_t = diag(w_t) S_{t-1} + k_tᵀ v_t ;  y_t = r_t (S_{t-1} + diag(u) k_tᵀ v_t)
with per-channel w_t from a low-rank adapter of the shifted input.

The reference's roundings are copied: Mamba's Δ is computed in float32,
cast to the stream dtype before the scan and upcast in each step; its
causal depthwise conv is a sum of ``d_conv`` shifted products in order plus
the bias, in the stream dtype (no ``conv1d``).  ``ssm.time_chunk`` > 0
checkpoints the recurrence chunk by chunk while gradients are recorded
(the reference's ``jax.checkpoint`` over chunks).

A cache's states are written in place, as the attention caches are, and
the cache is returned too.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.dist import ctx as shard_ctx

from .config import ModelConfig, SSMConfig
from .layers import RMSNorm, _param, dense_init

# --------------------------------------------------------------------------- #
# Mamba (S6)
# --------------------------------------------------------------------------- #


def _dt_rank(cfg: ModelConfig) -> int:
    s: SSMConfig = cfg.ssm
    return s.dt_rank if s.dt_rank else max(1, int(np.ceil(cfg.d_model / 16)))


class Mamba(nn.Module):
    """Parameters ``w_in`` [D, 2E], ``conv_w`` [d_conv, E], ``conv_b`` [E],
    ``w_x`` [E, r + 2N], ``w_dt`` [r, E], ``w_out`` [E, D] and the float32
    leaves ``dt_bias`` [E], ``a_log`` [E, N], ``d_skip`` [E]."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        s: SSMConfig = cfg.ssm
        d, e, r, n = cfg.d_model, s.expand * cfg.d_model, _dt_rank(cfg), s.d_state
        self.w_in = _param((d, 2 * e), dtype, device)
        self.conv_w = _param((s.d_conv, e), dtype, device)
        self.conv_b = _param((e,), dtype, device)
        self.w_x = _param((e, r + 2 * n), dtype, device)
        self.w_dt = _param((r, e), dtype, device)
        self.dt_bias = _param((e,), torch.float32, device)
        self.a_log = _param((e, n), torch.float32, device)
        self.d_skip = _param((e,), torch.float32, device)
        self.w_out = _param((e, d), dtype, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for w in (self.w_in, self.w_x, self.w_dt, self.w_out):
            w.data.copy_(dense_init(gen, *w.shape, w.dtype))
        conv = torch.randn(self.conv_w.shape, generator=gen, dtype=torch.float32,
                           device=gen.device)
        self.conv_w.data.copy_((conv * 0.1).to(self.conv_w.dtype))
        self.conv_b.data.zero_()
        self.dt_bias.data.zero_()
        # log(1..N) in numpy's float32 log, which rounds as the reference's
        # does (torch's differs by an ulp at 7)
        a_log = torch.from_numpy(np.log(np.arange(1, self.a_log.shape[1] + 1, dtype=np.float32)))
        self.a_log.data.copy_(a_log.expand(self.a_log.shape))
        self.d_skip.data.fill_(1.0)


def _mamba_steps(h, dt, bmat, cmat, xe, a):
    """The recurrence over the time axis of [B, S, ·] inputs from state
    ``h`` [B, E, N] (float32): (last state, y [B, S, E] float32)."""
    ys = []
    for t in range(xe.shape[1]):
        # per-step upcast; the state and its math stay float32
        dt32 = dt[:, t].float()
        da = torch.exp(dt32[..., None] * a)  # [B,E,N]
        h = da * h + (dt32 * xe[:, t].float())[..., None] * bmat[:, t].float()[:, None, :]
        ys.append(torch.einsum("ben,bn->be", h, cmat[:, t].float()))
    return h, torch.stack(ys, dim=1)


def _mamba_scan(params: Mamba, xe, cfg: ModelConfig, h0):
    """xe: [B, S, E] post-conv activations; h0: [B, E, N] initial state.
    Returns (y [B, S, E] in xe's dtype, last state)."""
    s_cfg: SSMConfig = cfg.ssm
    r = _dt_rank(cfg)
    proj = torch.einsum("bse,ef->bsf", xe, params.w_x)
    dt_in, bmat, cmat = proj.split([r, s_cfg.d_state, s_cfg.d_state], dim=-1)
    dt = F.softplus(torch.einsum("bsr,re->bse", dt_in, params.w_dt).float() + params.dt_bias)
    a = -torch.exp(params.a_log)  # [E,N]
    dt = dt.to(xe.dtype)  # streamed in the activation dtype, as the reference's
    chunk = s_cfg.time_chunk
    s_len = xe.shape[1]
    if chunk and s_len > chunk and s_len % chunk == 0 and torch.is_grad_enabled():
        h, parts = h0, []
        for i in range(0, s_len, chunk):
            sl = slice(i, i + chunk)
            h, y = checkpoint(_mamba_steps, h, dt[:, sl], bmat[:, sl], cmat[:, sl],
                              xe[:, sl], a, use_reentrant=False)
            parts.append(y)
        h_last, y = h, torch.cat(parts, dim=1)
    else:
        h_last, y = _mamba_steps(h0, dt, bmat, cmat, xe, a)
    y = y + params.d_skip * xe.float()
    return y.to(xe.dtype), h_last


def mamba_apply(params: Mamba, x, cfg: ModelConfig, positions=None, cache=None, causal=True):
    """x: [B,S,D]; cache: {"h":[B,E,N] float32, "conv":[B,d_conv-1,E]} for decode."""
    s_cfg: SSMConfig = cfg.ssm
    b, s, _ = x.shape
    xz = torch.einsum("bsd,df->bsf", x, params.w_in)
    xe, z = xz.chunk(2, dim=-1)

    # causal depthwise conv over time
    if cache is not None:
        conv_in = torch.cat([cache["conv"], xe], dim=1)
        h0 = cache["h"]
    else:
        conv_in = F.pad(xe, (0, 0, s_cfg.d_conv - 1, 0))
        h0 = torch.zeros((b, xe.shape[-1], s_cfg.d_state), dtype=torch.float32,
                         device=x.device)
    new_conv = conv_in[:, -(s_cfg.d_conv - 1):, :]
    xc = sum(conv_in[:, i:i + s, :] * params.conv_w[i][None, None, :]
             for i in range(s_cfg.d_conv)) + params.conv_b
    xc = F.silu(xc)

    y, h_last = _mamba_scan(params, xc, cfg, h0)
    y = y * F.silu(z)
    out = torch.einsum("bse,ed->bsd", y, params.w_out)
    new_cache = None
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["h"].copy_(h_last)
        new_cache = {"h": cache["h"], "conv": cache["conv"]}
    return out, new_cache


def mamba_cache_init(cfg: ModelConfig, batch: int, dtype=torch.bfloat16, device="cuda"):
    s: SSMConfig = cfg.ssm
    e = s.expand * cfg.d_model
    return {
        "h": torch.zeros((batch, e, s.d_state), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, s.d_conv - 1, e), dtype=dtype, device=device),
    }


# --------------------------------------------------------------------------- #
# RWKV-6 (Finch): time mixing with data-dependent decay + channel mixing
# --------------------------------------------------------------------------- #

_MIX_DIM = 32
_DECAY_DIM = 64


def _normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (w * scale).to(dtype)


class RWKV6TimeMix(nn.Module):
    """Parameters ``mu`` [5, D], ``mu_x`` [D], ``lora_a`` [D, 5·32],
    ``lora_b`` [5, 32, D], ``wr``/``wk``/``wv``/``wg`` [D, H, hd],
    ``wlora_a`` [D, 64], ``wlora_b`` [64, H, hd], ``ln_out.scale`` [H·hd],
    ``wo`` [H·hd, D] and the float32 leaves ``w0`` and ``u_bonus`` [H, hd]."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
        self.mu = _param((5, d), dtype, device)
        self.mu_x = _param((d,), dtype, device)
        self.lora_a = _param((d, 5 * _MIX_DIM), dtype, device)
        self.lora_b = _param((5, _MIX_DIM, d), dtype, device)
        self.wr = _param((d, h, hd), dtype, device)
        self.wk = _param((d, h, hd), dtype, device)
        self.wv = _param((d, h, hd), dtype, device)
        self.wg = _param((d, h, hd), dtype, device)
        self.w0 = _param((h, hd), torch.float32, device)
        self.wlora_a = _param((d, _DECAY_DIM), dtype, device)
        self.wlora_b = _param((_DECAY_DIM, h, hd), dtype, device)
        self.u_bonus = _param((h, hd), torch.float32, device)
        self.ln_out = RMSNorm(h * hd, dtype, device)  # its scale; resets itself to 1
        self.wo = _param((h * hd, d), dtype, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.mu.data.copy_(_normal(gen, self.mu.shape, 0.02, self.mu.dtype))
        self.mu_x.data.copy_(_normal(gen, self.mu_x.shape, 0.02, self.mu_x.dtype))
        self.lora_b.data.copy_(_normal(gen, self.lora_b.shape, 0.02, self.lora_b.dtype))
        for w in (self.lora_a, self.wr, self.wk, self.wv, self.wg, self.wlora_a,
                  self.wlora_b, self.wo):
            w.data.copy_(dense_init(gen, w.shape[0], w.numel() // w.shape[0],
                                    w.dtype).reshape(w.shape))
        self.w0.data.fill_(-6.0)  # base decay (slow)
        self.u_bonus.data.zero_()


def _token_shift(x, last):
    """shift right by one along S; position 0 takes ``last`` ([B, D])."""
    return torch.cat([last[:, None, :], x[:, :-1, :]], dim=1)


def _rwkv6_steps(state, r, k, v, w, u):
    """The time-mix recurrence over [B, S, H, hd] float32 inputs from
    ``state`` [B, H, hd, hd]: (last state, y [B, S, H, hd])."""
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]  # [B,H,hd,hd]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t], state + u[..., None] * kv))
        state = w[:, t, :, :, None] * state + kv
    return state, torch.stack(ys, dim=1)


def rwkv6_tm_apply(params: RWKV6TimeMix, x, cfg: ModelConfig, positions=None, cache=None,
                   causal=True):
    """x: [B,S,D]; cache: {"s":[B,H,hd,hd] float32, "last":[B,D]}."""
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    last = cache["last"] if cache is not None else torch.zeros((b, d), dtype=x.dtype,
                                                                 device=x.device)
    xprev = _token_shift(x, last)
    dx = xprev - x
    # ddlerp: data-dependent interpolation weights per stream
    xx = x + dx * params.mu_x
    lora = torch.tanh(torch.einsum("bsd,df->bsf", xx, params.lora_a))
    # whole on "model" before the split into streams (DTensor cannot split a
    # dim sharded over the mesh unevenly into two)
    lora = shard_ctx.constrain_groups(lora).reshape(b, s, 5, _MIX_DIM)
    dyn = torch.einsum("bsfm,fmd->bsfd", lora, params.lora_b)  # [B,S,5,D]
    mixed = x[:, :, None, :] + dx[:, :, None, :] * (params.mu[None, None] + dyn)
    xr, xk, xv, xw, xg = mixed.unbind(dim=2)

    r = torch.einsum("bsd,dhk->bshk", xr, params.wr)
    k = torch.einsum("bsd,dhk->bshk", xk, params.wk)
    v = torch.einsum("bsd,dhk->bshk", xv, params.wv)
    g = F.silu(torch.einsum("bsd,dhk->bshk", xg, params.wg))
    # data-dependent decay (the Finch contribution), in float32
    wl = torch.tanh(torch.einsum("bsd,df->bsf", xw, params.wlora_a))
    wraw = params.w0[None, None] + torch.einsum("bsf,fhk->bshk", wl, params.wlora_b).float()
    w = torch.exp(-torch.exp(wraw))  # [B,S,H,hd] in (0,1)

    u = params.u_bonus[None]  # [1,H,hd]
    s0 = cache["s"] if cache is not None else torch.zeros((b, h, hd, hd), dtype=torch.float32,
                                                          device=x.device)
    s_last, y = _rwkv6_steps(s0, r.float(), k.float(), v.float(), w, u)
    # per-head RMS norm, then the gate
    y32 = y * torch.rsqrt(y.square().mean(dim=-1, keepdim=True) + 1e-5)
    y = (y32.reshape(b, s, h * hd) * params.ln_out.scale.float()).to(x.dtype)
    y = y * g.reshape(b, s, h * hd)
    out = torch.einsum("bsf,fd->bsd", y, params.wo)
    new_cache = None
    if cache is not None:
        cache["s"].copy_(s_last)
        cache["last"].copy_(x[:, -1, :])
        new_cache = {"s": cache["s"], "last": cache["last"]}
    return out, new_cache


class RWKV6ChannelMix(nn.Module):
    """Parameters ``mu_k``, ``mu_r`` [D], ``wk`` [D, F], ``wv`` [F, D],
    ``wr`` [D, D]."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.mu_k = _param((d,), dtype, device)
        self.mu_r = _param((d,), dtype, device)
        self.wk = _param((d, f), dtype, device)
        self.wv = _param((f, d), dtype, device)
        self.wr = _param((d, d), dtype, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for mu in (self.mu_k, self.mu_r):
            mu.data.copy_(_normal(gen, mu.shape, 0.02, mu.dtype))
        for w in (self.wk, self.wv, self.wr):
            w.data.copy_(dense_init(gen, *w.shape, w.dtype))


def rwkv6_cm_apply(params: RWKV6ChannelMix, x, cfg: ModelConfig, cache=None):
    """Channel mixing; cache: {"last": [B, D]}."""
    b, _, d = x.shape
    last = cache["last"] if cache is not None else torch.zeros((b, d), dtype=x.dtype,
                                                                 device=x.device)
    xprev = _token_shift(x, last)
    dx = xprev - x
    xk = x + dx * params.mu_k
    xr = x + dx * params.mu_r
    k = F.relu(torch.einsum("bsd,df->bsf", xk, params.wk)).square()
    kv = torch.einsum("bsf,fd->bsd", k, params.wv)
    out = torch.sigmoid(torch.einsum("bsd,de->bse", xr, params.wr)) * kv
    new_cache = None
    if cache is not None:
        cache["last"].copy_(x[:, -1, :])
        new_cache = {"last": cache["last"]}
    return out, new_cache


def rwkv6_tm_cache_init(cfg: ModelConfig, batch: int, dtype=torch.bfloat16, device="cuda"):
    return {
        "s": torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.head_dim),
                         dtype=torch.float32, device=device),
        "last": torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
    }


def rwkv6_cm_cache_init(cfg: ModelConfig, batch: int, dtype=torch.bfloat16, device="cuda"):
    return {"last": torch.zeros((batch, cfg.d_model), dtype=dtype, device=device)}
