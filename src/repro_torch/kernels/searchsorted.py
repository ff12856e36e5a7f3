"""Batched searchsorted: ``out[b, i] = #{a[b, :] < q[b, i]}``.

The membership step of the batched search under ``backend="chained"``
(``ops.membership_chained``, registered with ``search_vec``).  For CUDA
tensors :func:`searchsorted` launches the hand-written kernel in
``csrc/searchsorted.cu`` (a block per tile of queries of one row; the
tile's window of the row staged in shared memory, whole or sampled); for CPU
tensors it runs :func:`searchsorted_plain`, the same function in plain
PyTorch.  There is no fallback between the two: a CUDA tensor reaches the
kernel or raises.

The function is the registered op ``repro_torch::searchsorted``
(``torch.ops.repro_torch.searchsorted``): its CUDA implementation is the
launch (:func:`_launch`), its CPU implementation the plain version, and its
fake implementation gives the output's shape and dtype and touches no
pointer, so the dry-run (``launch/dryrun.py --search``) traces it on fake
tensors.  Its FLOP formula (for ``torch.utils.flop_counter``)
counts the compares of a binary search: ``B * Q * ceil(log2 M)``.  Each
implementation checks the tensors it is given (:func:`_check`): under
DTensor those are a rank's local pieces.

``LAUNCHES`` counts kernel launches (plain-version calls do not count).
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from ._build import CSRC, Entry, int32_device

_SOURCE = CSRC / "searchsorted.cu"
_LAUNCH = Entry(_SOURCE, "searchsorted_launch")  # a q rows m nq out

LAUNCHES = 0  # kernel launches in this process (see module docstring)


def searchsorted_plain(a: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch."""
    return torch.searchsorted(a, q, side="left").to(torch.int32)


def _check(a: torch.Tensor, q: torch.Tensor) -> int:
    """What the kernel takes; returns the CUDA index, -1 on the CPU."""
    index = int32_device(a, q)
    sa, sq = a.shape, q.shape
    if len(sa) != 2 or len(sq) != 2 or sq[0] != sa[0]:
        raise ValueError(f"want a [B, M] and q [B, Q], got {tuple(sa)} and {tuple(sq)}")
    return index


def _launch(a: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The op's CUDA implementation: the kernel on the current stream,
    without synchronising."""
    global LAUNCHES
    index = _check(a, q)
    out = torch.empty_like(q)  # [B, Q] int32, as q
    _LAUNCH(index, a.data_ptr(), q.data_ptr(), a.shape[0], a.shape[1], q.shape[1],
            out.data_ptr())
    LAUNCHES += 1
    return out


def _plain(a: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The op's CPU implementation."""
    _check(a, q)
    return searchsorted_plain(a, q)


_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("searchsorted(Tensor a, Tensor q) -> Tensor")
_LIB.impl("searchsorted", _launch, "CUDA")
_LIB.impl("searchsorted", _plain, "CPU")


@torch.library.register_fake("repro_torch::searchsorted", lib=_LIB)
def _fake(a, q):
    _check(a, q)
    return torch.empty_like(q)


OP = torch.ops.repro_torch.searchsorted.default


@register_flop_formula(torch.ops.repro_torch.searchsorted)
def _flops(a_shape, q_shape, *args, **kwargs) -> int:
    """A binary search's compares: ceil(log2 M) for each of B * Q queries."""
    return q_shape[0] * q_shape[1] * (a_shape[1] - 1).bit_length()


def searchsorted(a: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``a`` [B, M] int32 ascending rows (an INT32_MAX tail is never counted),
    ``q`` [B, Q] int32 in any order -> [B, Q] int32 counts of ``a < q``.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream, without synchronising.
    """
    return OP(a, q)
