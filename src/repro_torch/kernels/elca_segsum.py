"""ELCA child sums: ``out[k, i] = sum of nd[k, j] over j with par[j] == ca[i]``.

The ELCA step of the chained query path (``ops.run_query_chained``): each
CA's NDesc per keyword is added onto its parent CA.  For CUDA tensors
:func:`elca_child_sums` launches the hand-written kernel in
``csrc/elca_segsum.cu`` (one thread per child, binary search of its parent,
integer atomics); for CPU tensors it runs :func:`elca_child_sums_plain`,
the same function in plain PyTorch (``searchsorted`` + ``index_add_``, not
the dense mask contraction of ``ref.elca_segsum_ref``, which needs
``mi * mj`` memory).  There is no fallback between the two: a CUDA tensor
reaches the kernel or raises.

``LAUNCHES`` counts kernel launches (plain-version calls do not count).
"""
from __future__ import annotations

import ctypes

import torch

from ._build import CSRC, Entry, int32_device

_SOURCE = CSRC / "elca_segsum.cu"
_LAUNCH = Entry(_SOURCE, "elca_segsum_launch", [
    ctypes.c_void_p, ctypes.c_int,  # ca mi
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # par nd mj k
    ctypes.c_void_p,  # out
])

LAUNCHES = 0  # kernel launches in this process (see module docstring)


def elca_child_sums_plain(
    ca: torch.Tensor, par: torch.Tensor, nd: torch.Tensor
) -> torch.Tensor:
    """The kernel's function in plain PyTorch."""
    mi = ca.numel()
    out = torch.zeros((nd.shape[0], mi + 1), dtype=torch.int32, device=ca.device)
    if mi:
        pos = torch.searchsorted(ca, par, side="left").clamp(max=mi - 1)
        hit = (par >= 0) & (ca[pos] == par)
        out.index_add_(1, torch.where(hit, pos, mi), nd)  # slot mi: no parent
    return out[:, :mi]


def elca_child_sums(
    ca: torch.Tensor, par: torch.Tensor, nd: torch.Tensor
) -> torch.Tensor:
    """``ca`` [MI] int32 CA ids, ascending, real ids unique (an INT32_MAX
    tail may repeat); ``par`` [MJ] int32 parent ids, -1 for none; ``nd``
    [K, MJ] int32 -> [K, MI] int32 child sums.

    The precondition on ``ca`` is the caller's: ``run_query_chained`` passes
    the CA ids in ascending preorder.  CPU tensors take the plain version;
    CUDA tensors launch the kernel on the current stream, without
    synchronising.
    """
    global LAUNCHES
    index = int32_device(ca, par, nd)
    if ca.dim() != 1 or par.dim() != 1 or nd.dim() != 2 or nd.shape[1] != len(par):
        raise ValueError(
            f"want ca [MI], par [MJ], nd [K, MJ]; got {tuple(ca.shape)}, "
            f"{tuple(par.shape)}, {tuple(nd.shape)}"
        )
    if index < 0:
        return elca_child_sums_plain(ca, par, nd)
    k, mj = nd.shape
    out = torch.empty((k, ca.numel()), dtype=torch.int32, device=ca.device)
    _LAUNCH(index, ca.data_ptr(), ca.numel(), par.data_ptr(), nd.data_ptr(), mj, k,
            out.data_ptr())
    LAUNCHES += 1
    return out
