"""Fused multi-query search: membership -> CA mask -> SLCA/ELCA in one call.

``fused_search_batch`` takes one PlanCache-packed batch (R rows of query x
redundancy component, each with its shortest list L0 and the k-1 other
posting lists) and returns, per row and per L0 slot, the kept id (INT_PAD
where dropped) and the keep mask.  L0 order is preserved, so each row's
results come out ascending with no sort.

For CUDA tensors it launches the hand-written kernel in
``csrc/fused_search.cu`` (built with ``nvcc`` at first use, loaded with
``ctypes``); for CPU tensors it runs :func:`fused_search_batch_plain`, the
same function in plain PyTorch.  There is no fallback between the two: a
CUDA tensor either reaches the kernel or raises.  No shape is capped, so
every ``m0`` bucket the PlanCache produces runs here.

``LAUNCHES`` counts kernel launches (plain-version calls do not count).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._build import BUILD_DIR, CSRC, launch  # noqa: F401  (BUILD_DIR re-exported)
from .shapes import INT_PAD

_SEMANTICS = {"slca": 0, "elca": 1, "ca": 2}

_SOURCE = CSRC / "fused_search.cu"
_FUNCTIONS = {
    "fused_search_launch": (
        [ctypes.c_void_p] * 6  # ids0 pid0 nd0 other_ids other_nd n0
        + [ctypes.c_int] * 5  # rows m0 k1 mo semantics
        + [ctypes.c_void_p] * 6  # keep_ids keep_mask ca ndo cnt sums
        + [ctypes.c_void_p]  # stream
    ),
}

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


def _check(ids0, pid0, ndesc0, other_ids, other_ndesc, n0) -> None:
    if ids0.dim() != 2 or ids0.dtype != torch.int32 or not ids0.is_contiguous():
        raise ValueError("ids0 must be a contiguous [R, m0] int32 tensor")
    if other_ids.dim() != 3:
        raise ValueError(f"other_ids must be [R, k-1, mo], got {tuple(other_ids.shape)}")
    rows, m0 = ids0.shape
    k1, mo = other_ids.shape[1], other_ids.shape[2]
    shapes = {
        "pid0": (pid0, (rows, m0)),
        "ndesc0": (ndesc0, (rows, m0)),
        "other_ids": (other_ids, (rows, k1, mo)),
        "other_ndesc": (other_ndesc, (rows, k1, mo)),
        "n0": (n0, (rows,)),
    }
    for name, (t, want) in shapes.items():
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
        if tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {want}")
        if t.device != ids0.device:
            raise ValueError(f"{name} is on {t.device}, ids0 on {ids0.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fused_search_batch(
    ids0: torch.Tensor,  # [R, m0] int32 ascending, INT_PAD tail
    pid0: torch.Tensor,  # [R, m0] int32 parent ids (-1 pad / root)
    ndesc0: torch.Tensor,  # [R, m0] int32 (0 pad)
    other_ids: torch.Tensor,  # [R, k-1, mo] int32 ascending rows, INT_PAD tail
    other_ndesc: torch.Tensor,  # [R, k-1, mo] int32 (0 pad)
    n0: torch.Tensor,  # [R] int32 valid lengths of L0
    other_n: torch.Tensor | None = None,  # [R, k-1]: part of a packed batch;
    # not read, since INT_PAD tails keep each row sorted and i < n0 masks pads
    *,
    semantics: str = "slca",
) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused search over a PlanCache-packed batch.

    Returns (keep_ids [R, m0] int32, keep_mask [R, m0] bool) on the inputs'
    device.  CPU tensors take the plain version; CUDA tensors launch the
    kernel on the current stream, without synchronising.
    """
    global LAUNCHES
    if semantics not in _SEMANTICS:
        raise ValueError(f"unknown semantics {semantics!r}")
    _check(ids0, pid0, ndesc0, other_ids, other_ndesc, n0)
    rows, m0 = ids0.shape
    k1, mo = other_ids.shape[1], other_ids.shape[2]
    if ids0.device.type == "cpu":
        return fused_search_batch_plain(
            ids0, pid0, ndesc0, other_ids, other_ndesc, n0, semantics
        )
    if ids0.device.type != "cuda":
        raise ValueError(f"fused_search_batch runs on cpu or cuda, not {ids0.device}")
    dev = ids0.device
    elca = semantics == "elca"
    keep_ids = torch.empty((rows, m0), dtype=torch.int32, device=dev)
    keep_mask = torch.empty((rows, m0), dtype=torch.bool, device=dev)
    # scratch, one buffer of [R, m0] planes, initialised by the kernel:
    # CA mask, CA-child count, and for ELCA the k-1 gathered other-list
    # NDesc rows and the k parent sums
    planes = 2 + (2 * k1 + 1 if elca else 0)
    scratch = torch.empty((planes, rows * m0), dtype=torch.int32, device=dev)
    ca, cnt, ndo = scratch[0], scratch[1], scratch[2:]
    sums = scratch[2 + k1 :] if elca else scratch[2:]
    launch(
        _SOURCE, _FUNCTIONS, "fused_search_launch", dev,
        ids0, pid0, ndesc0, other_ids, other_ndesc, n0,
        rows, m0, k1, mo, _SEMANTICS[semantics],
        keep_ids, keep_mask, ca, ndo, cnt, sums,
    )
    LAUNCHES += 1
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
