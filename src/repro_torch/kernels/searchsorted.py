"""Batched searchsorted: ``out[b, i] = #{a[b, :] < q[b, i]}``.

The membership step of the batched search under ``backend="chained"``
(``ops.membership_chained``, registered with ``search_vec``).  For CUDA
tensors :func:`searchsorted` launches the hand-written kernel in
``csrc/searchsorted.cu`` (a block per tile of queries of one row; the
tile's window of the row staged in shared memory, whole or sampled); for CPU
tensors it runs :func:`searchsorted_plain`, the same function in plain
PyTorch.  There is no fallback between the two: a CUDA tensor reaches the
kernel or raises.

``LAUNCHES`` counts kernel launches (plain-version calls do not count).
"""
from __future__ import annotations

import torch

from ._build import CSRC, Entry, int32_device

_SOURCE = CSRC / "searchsorted.cu"
_LAUNCH = Entry(_SOURCE, "searchsorted_launch")  # a q rows m nq out

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
    index = int32_device(a, q)
    sa, sq = a.shape, q.shape
    if len(sa) != 2 or len(sq) != 2 or sq[0] != sa[0]:
        raise ValueError(f"want a [B, M] and q [B, Q], got {tuple(sa)} and {tuple(sq)}")
    if index < 0:
        return searchsorted_plain(a, q)
    out = torch.empty_like(q)  # [B, Q] int32, as q
    _LAUNCH(index, a.data_ptr(), q.data_ptr(), sa[0], sa[1], sq[1], out.data_ptr())
    LAUNCHES += 1
    return out
