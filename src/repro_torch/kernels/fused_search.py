"""Fused multi-query search: membership -> CA mask -> SLCA/ELCA in one call.

``fused_search_batch`` takes one PlanCache-packed batch (R rows of query x
redundancy component, each with its shortest list L0 and the k-1 other
posting lists) and returns, per row and per L0 slot, the kept id (INT_PAD
where dropped) and the keep mask.  L0 order is preserved, so each row's
results come out ascending with no sort.

For CUDA tensors it launches the hand-written kernel in
``csrc/fused_search.cu`` (built with ``nvcc`` at first use and imported,
``_build``); for CPU tensors it runs :func:`fused_search_batch_plain`, the
same function in plain PyTorch.  There is no fallback between the two: a
CUDA tensor either reaches the kernel or raises.  No shape is capped, so
every ``m0`` bucket the PlanCache produces runs here.  :func:`route` picks
the kernel's route from the batch's shape alone: ``"rows"`` (one block per
row, the row's state in shared memory, one launch, no scratch) or
``"tiles"`` (longer rows spread over blocks, three launches, scratch in
device memory).

``LAUNCHES`` counts wrapper calls that launch the kernel, one per call
whatever the route (plain-version calls do not count).
"""
from __future__ import annotations

import numpy as np
import torch

from ._build import BUILD_DIR, CSRC, Entry, int32_device  # noqa: F401  (BUILD_DIR re-exported)
from .shapes import INT_PAD

_SEMANTICS = {"slca": 0, "elca": 1, "ca": 2}

_SOURCE = CSRC / "fused_search.cu"
_SOURCES = (_SOURCE,)
# ids0 pid0 nd0 other_ids other_nd n0 other_n, rows m0 k1 mo semantics route,
# keep_ids keep_mask ca ndo cnt sums ppos
_LAUNCH = Entry(_SOURCE, "fused_search_launch")

ROUTES = ("rows", "tiles")  # the C entry point's route numbers, in order
# the rows route's shared memory, as csrc/fused_search.cu lays it out
_STAGE_INTS = 4096  # search.cuh kStage: two staging buffers of this many ints
_ROW_THREADS = 512
_ROW_MAX_M0 = 2048  # the longest row the wrapper sends the rows route
_SMEM_MAX = 232_448  # shared memory one block can have on Hopper (227 KB)

LAUNCHES = 0  # kernel launches in this process (see module docstring)


# --------------------------------------------------------------------------- #
# Plain PyTorch version (CPU path, and the kernel's yardstick on the card)
# --------------------------------------------------------------------------- #


def fused_search_batch_plain(
    ids0: torch.Tensor,
    pid0: torch.Tensor,
    ndesc0: torch.Tensor,
    other_ids: torch.Tensor,
    other_ndesc: torch.Tensor,
    n0: torch.Tensor,
    semantics: str = "slca",
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: searchsorted, gather, scatter."""
    rows, m0 = ids0.shape
    k1 = other_ids.shape[1]
    dev = ids0.device
    zeros = torch.zeros_like(ids0)
    ca = torch.arange(m0, device=dev)[None, :] < n0[:, None]
    nd = [ndesc0]
    if k1:
        mo = other_ids.shape[2]
        flat = other_ids.reshape(rows * k1, mo)
        q = ids0[:, None, :].expand(rows, k1, m0).reshape(rows * k1, m0).contiguous()
        pos = torch.searchsorted(flat, q).clamp(max=mo - 1)
        hit = torch.gather(flat, 1, pos) == q
        ndo = torch.gather(other_ndesc.reshape(rows * k1, mo), 1, pos)
        ndo = torch.where(hit, ndo, torch.zeros_like(ndo)).reshape(rows, k1, m0)
        ca = ca & hit.reshape(rows, k1, m0).all(dim=1)
        nd += list(ndo.unbind(dim=1))
    # each CA's parent position in L0 (pid0 holds ids, -1 at a root)
    ppos = torch.searchsorted(ids0, pid0).clamp(max=m0 - 1)
    edge = ca & (pid0 >= 0) & (torch.gather(ids0, 1, ppos) == pid0)
    edge = edge & torch.gather(ca, 1, ppos)
    seg = torch.where(edge, ppos, torch.full_like(ppos, m0))  # m0: no parent
    if semantics == "slca":
        cnt = torch.zeros((rows, m0 + 1), dtype=torch.int32, device=dev)
        cnt.scatter_add_(1, seg, edge.to(torch.int32))
        keep = ca & (cnt[:, :m0] == 0)
    elif semantics == "elca":
        keep = ca
        for row in nd:
            sums = torch.zeros((rows, m0 + 1), dtype=torch.int32, device=dev)
            sums.scatter_add_(1, seg, torch.where(edge, row, zeros))
            keep = keep & (row - sums[:, :m0] >= 1)
    elif semantics == "ca":
        keep = ca
    else:
        raise ValueError(f"unknown semantics {semantics!r}")
    keep_ids = torch.where(keep, ids0, torch.full_like(ids0, int(INT_PAD)))
    return keep_ids, keep


# --------------------------------------------------------------------------- #
# Wrapper
# --------------------------------------------------------------------------- #


def _check(ids0, pid0, ndesc0, other_ids, other_ndesc, n0, other_n) -> int:
    """The packed batch's shapes; returns ``int32_device``'s index."""
    tensors = (ids0, pid0, ndesc0, other_ids, other_ndesc, n0)
    index = int32_device(*tensors, *(() if other_n is None else (other_n,)))
    if ids0.dim() != 2:
        raise ValueError(f"ids0 must be [R, m0], got shape {tuple(ids0.shape)}")
    if other_ids.dim() != 3:
        raise ValueError(f"other_ids must be [R, k-1, mo], got shape {tuple(other_ids.shape)}")
    rows, m0 = ids0.shape
    k1, mo = other_ids.shape[1], other_ids.shape[2]
    for name, t, want in (
        ("pid0", pid0, (rows, m0)),
        ("ndesc0", ndesc0, (rows, m0)),
        ("other_ids", other_ids, (rows, k1, mo)),
        ("other_ndesc", other_ndesc, (rows, k1, mo)),
        ("n0", n0, (rows,)),
        ("other_n", other_n, (rows, k1)),
    ):
        if t is not None and t.shape != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {want}")
    return index


def row_threads(m0: int) -> int:
    """Threads of the rows route's block for rows of ``m0`` slots (whole
    warps, at least two): ``csrc/fused_search.cu::row_threads``."""
    return _ROW_THREADS if m0 >= _ROW_THREADS else max(64, -(-m0 // 32) * 32)


def rows_fit(m0: int, k: int, semantics: str) -> bool:
    """Whether the rows route's shared memory for rows of ``m0`` slots and
    ``k`` lists fits in one block: what ``csrc/fused_search.cu::row_smem``
    computes, two staging buffers, the windows of each (tile, list), the
    ids, the count (SLCA) or the k-1 gathered NDesc and k sums (ELCA), and a
    CA byte per slot."""
    k1 = k - 1
    jobs = -(-m0 // row_threads(m0)) * k1
    ints = 2 * _STAGE_INTS + 2 * jobs + m0
    ints += {"slca": m0, "elca": (2 * k1 + 1) * m0, "ca": 0}[semantics]
    return 4 * ints + m0 <= _SMEM_MAX


def route(m0: int, k: int, semantics: str) -> str:
    """The kernel's route for a batch of rows of ``m0`` slots and ``k``
    lists: ``"rows"`` when one block does a row quickly (``m0`` at most
    2,048: four tiles of 512) and its state fits (:func:`rows_fit`), else
    ``"tiles"``."""
    return "rows" if m0 <= _ROW_MAX_M0 and rows_fit(m0, k, semantics) else "tiles"


def fused_search_batch(
    ids0: torch.Tensor,  # [R, m0] int32 ascending, INT_PAD tail
    pid0: torch.Tensor,  # [R, m0] int32 parent ids (-1 pad / root)
    ndesc0: torch.Tensor,  # [R, m0] int32 (0 pad)
    other_ids: torch.Tensor,  # [R, k-1, mo] int32 ascending rows, INT_PAD tail
    other_ndesc: torch.Tensor,  # [R, k-1, mo] int32 (0 pad)
    n0: torch.Tensor,  # [R] int32 valid lengths of L0
    other_n: torch.Tensor | None = None,  # [R, k-1] int32 valid lengths of the
    # other lists; the kernel searches only these (the whole bucket when None)
    *,
    semantics: str = "slca",
) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused search over a PlanCache-packed batch.

    Returns (keep_ids [R, m0] int32, keep_mask [R, m0] bool) on the inputs'
    device.  CPU tensors take the plain version; CUDA tensors launch the
    kernel on the current stream, without synchronising, by :func:`route`.
    """
    global LAUNCHES
    if semantics not in _SEMANTICS:
        raise ValueError(f"unknown semantics {semantics!r}")
    index = _check(ids0, pid0, ndesc0, other_ids, other_ndesc, n0, other_n)
    if index < 0:
        return fused_search_batch_plain(
            ids0, pid0, ndesc0, other_ids, other_ndesc, n0, semantics
        )
    out = _launch(index, ids0, pid0, ndesc0, other_ids, other_ndesc, n0, other_n,
                  semantics, route(ids0.shape[1], other_ids.shape[1] + 1, semantics))
    LAUNCHES += 1
    return out


def scratch_of(ids0: torch.Tensor, k1: int, semantics: str):
    """The tiles route's scratch: one buffer of [R, m0] int32 planes, all
    initialised by the kernel (the CA mask, the CA-child count, each CA's
    parent position, and for ELCA the k-1 gathered other-list NDesc rows and
    the k parent sums); returns (the pointers of ca, ndo, cnt, sums and
    ppos, the buffer)."""
    elca = semantics == "elca"
    planes = ids0.new_empty((3 + (2 * k1 + 1 if elca else 0)) * ids0.numel())
    at, plane = planes.data_ptr(), 4 * ids0.numel()
    return (at, at + 3 * plane, at + plane, at + (3 + k1 if elca else 3) * plane,
            at + 2 * plane), planes


def _launch(index, ids0, pid0, ndesc0, other_ids, other_ndesc, n0, other_n,
            semantics, which):
    """Launch route ``which`` of the kernel on checked CUDA inputs."""
    rows, m0 = ids0.shape
    k1, mo = other_ids.shape[1], other_ids.shape[2]
    keep_ids = torch.empty_like(ids0)
    keep_mask = torch.empty_like(ids0, dtype=torch.bool)
    if which == "rows":
        scratch = (0, 0, 0, 0, 0)
    else:  # planes, the buffer, is held until the launch is queued
        scratch, planes = scratch_of(ids0, k1, semantics)
    _LAUNCH(
        index,
        ids0.data_ptr(), pid0.data_ptr(), ndesc0.data_ptr(), other_ids.data_ptr(),
        other_ndesc.data_ptr(), n0.data_ptr(),
        0 if other_n is None else other_n.data_ptr(),
        rows, m0, k1, mo, _SEMANTICS[semantics], ROUTES.index(which),
        keep_ids.data_ptr(), keep_mask.data_ptr(), *scratch,
    )
    return keep_ids, keep_mask


def run_query_fused(
    lists, semantics: str = "slca", device: str | torch.device = "cuda"
) -> np.ndarray:
    """Single-query convenience over the fused search (engine tree path).

    Packs one work item (R bucket 1) through a PlanCache on ``device``.
    """
    from repro_torch.core.plan_cache import PlanCache  # late: avoid cycle

    plan = PlanCache(backend="fused", device=device)
    return plan.run([list(lists)], [0], semantics, backend="fused")[0]
