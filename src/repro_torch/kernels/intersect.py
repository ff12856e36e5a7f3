"""Sorted-set membership: found/pos of each query in a sorted unique array.

The CA intersection of the chained query path (``ops.run_query_chained``):
each other list is probed with every entry of the shortest list.  For CUDA
tensors :func:`intersect_membership` launches the hand-written kernel in
``csrc/intersect.cu`` (one thread per query, binary search, exact lengths);
for CPU tensors it runs :func:`intersect_membership_plain`, the same
function in plain PyTorch.  There is no fallback between the two: a CUDA
tensor reaches the kernel or raises.

``LAUNCHES`` counts kernel launches (plain-version calls do not count).
"""
from __future__ import annotations

import ctypes

import torch

from ._build import CSRC, check_int32, launch

_SOURCE = CSRC / "intersect.cu"
_FUNCTIONS = {
    "intersect_launch": [
        ctypes.c_void_p, ctypes.c_int,  # a na
        ctypes.c_void_p, ctypes.c_int,  # q nq
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # found pos stream
    ],
}

LAUNCHES = 0  # kernel launches in this process (see module docstring)


def intersect_membership_plain(
    a: torch.Tensor, q: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch."""
    if a.numel() == 0:
        return (
            torch.zeros(q.shape, dtype=torch.bool, device=q.device),
            torch.zeros(q.shape, dtype=torch.int32, device=q.device),
        )
    pos = torch.searchsorted(a, q, side="left").clamp(max=a.numel() - 1)
    found = a[pos] == q
    return found, torch.where(found, pos, 0).to(torch.int32)


def intersect_membership(
    a: torch.Tensor, q: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """``a`` [NA] int32 ascending and unique, ``q`` [NQ] int32 ->
    (found [NQ] bool, pos [NQ] int32): ``pos`` is the index of ``q`` in
    ``a`` on a hit and 0 on a miss, as the reference kernel writes it.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream, without synchronising.
    """
    global LAUNCHES
    dev = check_int32(a=a, q=q)
    if a.dim() != 1 or q.dim() != 1:
        raise ValueError(
            f"want 1-D a and q, got {tuple(a.shape)} and {tuple(q.shape)}"
        )
    if dev.type == "cpu":
        return intersect_membership_plain(a, q)
    found = torch.empty(q.shape, dtype=torch.bool, device=dev)
    pos = torch.empty(q.shape, dtype=torch.int32, device=dev)
    launch(_SOURCE, _FUNCTIONS, "intersect_launch", dev,
           a, a.numel(), q, q.numel(), found, pos)
    LAUNCHES += 1
    return found, pos
