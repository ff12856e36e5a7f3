"""Core layers in plain PyTorch: norms, rotary embeddings, MLPs, embeddings.

The functions take tensors and compute what the reference's
``repro.models.layers`` computes, in the same dtypes: ``rmsnorm`` and
``apply_rope`` work in float32 inside and cast back, matrix products stay in
the activation dtype.  The ``nn.Module``s own the parameters, named and laid
out as the reference's parameter tree (``{"scale"}``, ``{"w_gate", "w_up",
"w_down"}``, ``{"table"}``, ``{"w"}``), so a reference tree loads leaf for
leaf (``convert.params_from_numpy``).

Parameters are made with an explicit ``torch.Generator`` (``dense_init``);
the reference's ``jax.random`` keys give other numbers from the same seed.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def torch_dtype(cfg_dtype: str) -> torch.dtype:
    return torch.bfloat16 if cfg_dtype == "bfloat16" else torch.float32


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.bfloat16, scale: float | None = None) -> torch.Tensor:
    """A [d_in, d_out] matrix of normals times ``scale`` (1/sqrt(d_in) by
    default), drawn in float32 on the generator's device, then cast."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * scale).to(dtype)


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


# --------------------------------------------------------------------------- #
# RMSNorm
# --------------------------------------------------------------------------- #


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype, device):
        super().__init__()
        self.scale = _param((d,), dtype, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.scale.data.fill_(1.0)

    def forward(self, x, eps: float):
        return rmsnorm(x, self.scale, eps)


# --------------------------------------------------------------------------- #
# Rotary position embeddings (split halves, not interleaved)
# --------------------------------------------------------------------------- #


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: [..., S] int.  Angles in float32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # [hd/2]
    ang = positions[..., :, None].float() * freqs  # [..., S, hd/2]
    cos = torch.cos(ang)[..., :, None, :]  # [..., S, 1, hd/2]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------- #
# Feed-forward blocks
# --------------------------------------------------------------------------- #


def swiglu(x, w_gate, w_up, w_down):
    g = F.silu(x @ w_gate)
    return (g * (x @ w_up)) @ w_down


def relu2(x, w_up, w_down):
    """Squared-ReLU MLP (Nemotron-4)."""
    return F.relu(x @ w_up).square() @ w_down


def gelu_mlp(x, w_up, w_down):
    """GELU MLP (HuBERT); ``jax.nn.gelu`` defaults to the tanh approximation."""
    return F.gelu(x @ w_up, approximate="tanh") @ w_down


class MLP(nn.Module):
    """``kind`` "swiglu" (gate, up, down) or "relu2" / "gelu" (up, down)."""

    def __init__(self, kind: str, d_model: int, d_ff: int, dtype, device):
        super().__init__()
        self.kind = kind
        if kind == "swiglu":
            self.w_gate = _param((d_model, d_ff), dtype, device)
        self.w_up = _param((d_model, d_ff), dtype, device)
        self.w_down = _param((d_ff, d_model), dtype, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for p in self.parameters():  # gate, up, down, in the reference's order
            p.data.copy_(dense_init(gen, *p.shape, p.dtype))

    def forward(self, x):
        return self.apply_with(x, self.w_up, self.w_down,
                               self.w_gate if self.kind == "swiglu" else None)

    def apply_with(self, x, w_up, w_down, w_gate=None):
        """The MLP of this kind with the weights given (pieces of its own)."""
        if self.kind == "swiglu":
            return swiglu(x, w_gate, w_up, w_down)
        if self.kind == "relu2":
            return relu2(x, w_up, w_down)
        return gelu_mlp(x, w_up, w_down)


def mlp_local(mlp: MLP, h, lay):
    """``mlp(h)`` for a normed input ``h`` on one rank's share, ``lay`` a
    ``dist.local.Local``: the up (and gate) columns split over "model", the
    down rows, one all-reduce of the output and one of the input's
    gradient; no weight is gathered.  Where "model" does not divide d_ff,
    every "model" rank computes the whole MLP."""
    if mlp.w_up.shape[-1] % lay.m:
        lay = lay.whole()
    h = lay.enter(h)
    gate = lay.weight(mlp.w_gate, 1) if mlp.kind == "swiglu" else None
    y = mlp.apply_with(h, lay.weight(mlp.w_up, 1), lay.weight(mlp.w_down, 0), gate)
    return lay.leave(y)


# --------------------------------------------------------------------------- #
# Embedding / head
# --------------------------------------------------------------------------- #


class Embedding(nn.Module):
    def __init__(self, vocab: int, d_model: int, dtype, device):
        super().__init__()
        self.table = _param((vocab, d_model), dtype, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.table.data.copy_(dense_init(gen, *self.table.shape, self.table.dtype, 1.0))


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of ``table`` at ``tokens`` (``F.embedding``: a DTensor table
    sharded over the vocabulary takes it without a gather of the table)."""
    return F.embedding(tokens, table)


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return x @ table.T


class Head(nn.Module):
    def __init__(self, d_model: int, vocab: int, dtype, device):
        super().__init__()
        self.w = _param((d_model, vocab), dtype, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.w.data.copy_(dense_init(gen, *self.w.shape, self.w.dtype))


def head(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return x @ w
