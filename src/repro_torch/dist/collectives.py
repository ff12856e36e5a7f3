"""Gradient compression for cross-host reduction (int8 + error feedback).

``compress_grads_with_feedback`` quantizes each gradient leaf to int8 with a
per-leaf max-abs scale and returns (dequantized, residual).  The residual is
the exact quantization error and is added back into the *next* step's
gradient before quantizing (error feedback), so the transmitted signal
converges to the true gradient sum instead of accumulating bias.  Rounding
is half to even (``torch.round``), as ``jnp.round``'s.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_map


def _compress_leaf(g: torch.Tensor, r: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    acc = g.float() + r.float()
    scale = acc.abs().max() / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(acc / safe), -127, 127).to(torch.int8)
    deq = q.float() * safe
    return deq, acc - deq


def compress_grads_with_feedback(grads, residual=None):
    """Returns (dequantized_grads, new_residual); both trees match ``grads``."""
    if residual is None:
        residual = tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32), grads)
    pairs = tree_map(_compress_leaf, grads, residual)
    deq = tree_map(lambda _g, pair: pair[0], grads, pairs)
    new_residual = tree_map(lambda _g, pair: pair[1], grads, pairs)
    return deq, new_residual
