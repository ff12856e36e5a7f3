"""ELCA child sums: ``out[k, i] = sum of nd[k, j] over j with par[j] == ca[i]``.

The ELCA step of the chained query path (``ops.run_query_chained``): each
CA's NDesc per keyword is added onto its parent CA.  For CUDA tensors
:func:`elca_child_sums` launches the hand-written kernel in
``csrc/elca_segsum.cu`` (a thread per child finds its parent in ``ca``
staged in shared memory, and the children of one parent add up in the warp;
a small call adds up in one block's shared memory and writes the output
once, a large one adds each block's sums into the output once a parent);
for CPU tensors it runs :func:`elca_child_sums_plain`, the same function in
plain PyTorch (``searchsorted`` + ``index_add_``, not the dense mask
contraction of ``ref.elca_segsum_ref``, which needs ``mi * mj`` memory).
There is no fallback between the two: a CUDA tensor reaches the kernel or
raises.

``LAUNCHES`` counts kernel launches (plain-version calls do not count).
"""
from __future__ import annotations

import torch

from ._build import CSRC, Entry, int32_device

_SOURCE = CSRC / "elca_segsum.cu"
_SOURCES = (_SOURCE,)
_LAUNCH = Entry(_SOURCE, "elca_segsum_launch")  # ca mi par nd mj k out

# the kernel's dense route (one block, no memset) takes a call of at most
# ONE_BLOCK children whose output has at most DENSE_INTS ints (kOneBlock and
# kDenseInts in the source); larger calls take the tiles route
ONE_BLOCK = 1024
DENSE_INTS = 16384


def route(mi: int, mj: int, k: int) -> str:
    """The kernel's route for these shapes: ``"dense"`` or ``"tiles"``."""
    return "dense" if mj <= ONE_BLOCK and k * mi <= DENSE_INTS else "tiles"

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
    sc, sp, sn = ca.shape, par.shape, nd.shape
    if len(sc) != 1 or len(sp) != 1 or len(sn) != 2 or sn[1] != sp[0]:
        raise ValueError(
            f"want ca [MI], par [MJ], nd [K, MJ]; got {tuple(sc)}, {tuple(sp)}, {tuple(sn)}"
        )
    if index < 0:
        return elca_child_sums_plain(ca, par, nd)
    out = nd.new_empty((sn[0], sc[0]))  # [K, MI] int32, as nd
    _LAUNCH(index, ca.data_ptr(), sc[0], par.data_ptr(), nd.data_ptr(), sn[1], sn[0],
            out.data_ptr())
    LAUNCHES += 1
    return out
