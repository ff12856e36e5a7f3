"""Batched searchsorted: ``out[b, i] = #{a[b, :] < q[b, i]}``.

The membership step of the batched search under ``backend="chained"``
(``ops.membership_chained``, registered with ``search_vec``).  For CUDA
tensors :func:`searchsorted` launches the hand-written kernel in
``csrc/searchsorted.cu`` (one thread per query, binary search); for CPU
tensors it runs :func:`searchsorted_plain`, the same function in plain
PyTorch.  There is no fallback between the two: a CUDA tensor reaches the
kernel or raises.

``LAUNCHES`` counts kernel launches (plain-version calls do not count).
"""
from __future__ import annotations

import ctypes

import torch

from ._build import CSRC, check_int32, launch

_SOURCE = CSRC / "searchsorted.cu"
_FUNCTIONS = {
    "searchsorted_launch": (
        [ctypes.c_void_p] * 2  # a q
        + [ctypes.c_int] * 3  # rows m nq
        + [ctypes.c_void_p] * 2  # out stream
    ),
}

LAUNCHES = 0  # kernel launches in this process (see module docstring)


def searchsorted_plain(a: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch."""
    return torch.searchsorted(a, q, side="left").to(torch.int32)


def searchsorted(a: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``a`` [B, M] int32 ascending rows (an INT32_MAX tail is never counted),
    ``q`` [B, Q] int32 in any order -> [B, Q] int32 counts of ``a < q``.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream, without synchronising.
    """
    global LAUNCHES
    dev = check_int32(a=a, q=q)
    if a.dim() != 2 or q.dim() != 2 or q.shape[0] != a.shape[0]:
        raise ValueError(
            f"want a [B, M] and q [B, Q], got {tuple(a.shape)} and {tuple(q.shape)}"
        )
    if dev.type == "cpu":
        return searchsorted_plain(a, q)
    out = torch.empty(q.shape, dtype=torch.int32, device=dev)
    launch(_SOURCE, _FUNCTIONS, "searchsorted_launch", dev,
           a, q, *a.shape, q.shape[1], out)
    LAUNCHES += 1
    return out
