"""Sorted-set membership: the CA intersection of a chained query.

:func:`intersect_lists` is the whole intersection of one chained query
(``ops.run_query_chained``): the shortest list L0 probed against every other
list, giving the CA mask and each list's NDesc at L0's entries, in one
launch of the kernel in ``csrc/intersect.cu`` (a block per tile of L0, each
list's window staged in shared memory).  :func:`intersect_membership` is the
reference kernel's own function, found/pos of each query in one list (one
thread per query).  For CUDA tensors each launches its kernel; for CPU
tensors each runs its plain PyTorch version (:func:`intersect_lists_plain`,
:func:`intersect_membership_plain`).  There is no fallback between the two:
a CUDA tensor reaches the kernel or raises.

``LAUNCHES`` counts kernel launches of both (plain-version calls do not
count).
"""
from __future__ import annotations

import ctypes

import torch

from ._build import CSRC, Entry, int32_device

_SOURCE = CSRC / "intersect.cu"
_LAUNCH = Entry(_SOURCE, "intersect_launch", [
    ctypes.c_void_p, ctypes.c_int,  # a na
    ctypes.c_void_p, ctypes.c_int,  # q nq
    ctypes.c_void_p, ctypes.c_void_p,  # found pos
])

_LISTS = Entry(_SOURCE, "intersect_lists_launch", [
    ctypes.c_void_p, ctypes.c_void_p,  # buf table
    ctypes.c_int, ctypes.c_int,  # k n
    ctypes.c_void_p, ctypes.c_void_p,  # ca nd
])

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
    index = int32_device(a, q)
    if a.dim() != 1 or q.dim() != 1:
        raise ValueError(
            f"want 1-D a and q, got {tuple(a.shape)} and {tuple(q.shape)}"
        )
    if index < 0:
        return intersect_membership_plain(a, q)
    found = torch.empty_like(q, dtype=torch.bool)
    pos = torch.empty_like(q)
    _LAUNCH(index, a.data_ptr(), a.numel(), q.data_ptr(), q.numel(),
            found.data_ptr(), pos.data_ptr())
    LAUNCHES += 1
    return found, pos


def intersect_lists_plain(
    buf: torch.Tensor, table: torch.Tensor, n: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`intersect_lists`'s function in plain PyTorch: one
    :func:`intersect_membership_plain` per other list and its NDesc gather."""
    (ids_at, nd_at, _), *others = table.tolist()
    ids0 = buf[ids_at : ids_at + n]
    ca = torch.ones(n, dtype=torch.bool, device=buf.device)
    nd = [buf[nd_at : nd_at + n]]
    for ids_at, nd_at, length in others:
        found, pos = intersect_membership_plain(buf[ids_at : ids_at + length], ids0)
        ca &= found
        nd.append(buf[nd_at : nd_at + length].index_select(0, pos))  # pos 0 on a miss
    return ca, torch.stack(nd)


def intersect_lists(
    buf: torch.Tensor, table: torch.Tensor, n: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The CA intersection of one chained query.

    ``buf`` [N] int32 holds the lists; ``table`` [k, 3] int32, on the same
    device (a view of ``buf`` itself in ``run_query_chained``, so one copy
    brings both), gives for list j its ids' offset in ``buf``, its NDesc's
    offset and its length; list 0 is L0, ascending, of length ``n``, and
    every other list is ascending, unique and not empty.  Returns (ca [n]
    bool: L0[i] is in every other list, nd [k, n] int32: list j's NDesc at
    L0[i]'s position in it, at position 0 on a miss; row 0 is L0's NDesc).

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream, without synchronising.  The kernel reads the table
    on the card, so its offsets are not checked there: the caller packs it.
    """
    global LAUNCHES
    index = int32_device(buf, table)
    if buf.dim() != 1 or table.dim() != 2 or table.shape[1] != 3 or not table.shape[0]:
        raise ValueError(
            f"want a 1-D buf and a [k, 3] table, got {tuple(buf.shape)} and "
            f"{tuple(table.shape)}"
        )
    if index < 0:
        return intersect_lists_plain(buf, table, n)
    k = table.shape[0]
    ca = buf.new_empty(n, dtype=torch.bool)
    nd = buf.new_empty((k, n))
    if n:
        _LISTS(index, buf.data_ptr(), table.data_ptr(), k, n, ca.data_ptr(), nd.data_ptr())
        LAUNCHES += 1
    return ca, nd
