"""The chained query path: one hand-written CUDA kernel per phase.

The port's counterpart of the reference's Pallas wrappers and its
``run_query_pallas`` (engine ``backend="pallas"`` there, ``"chained"``
here).  Every function takes tensors and runs on their device: CUDA tensors
launch the kernels, CPU tensors run each kernel's plain PyTorch version.
The reference's TPU tiling (window starts on the host, block sizes, padding
to block multiples, the interpret-mode switch) has no counterpart: the
kernels search exact lengths.

Importing this module registers :func:`membership_chained` as the
``"chained"`` membership backend of :mod:`repro_torch.core.search_vec`, so
the batched search (PlanCache, QueryService) runs its intersection on the
searchsorted kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.idlist import IDList
from repro_torch.core.search_vec import register_membership_backend

from .elca_segsum import elca_child_sums
from .intersect import intersect_lists, intersect_membership
from .searchsorted import searchsorted

__all__ = [
    "elca_child_sums",
    "intersect_lists",
    "intersect_membership",
    "membership_chained",
    "run_query_chained",
    "searchsorted_positions",
]

_EMPTY = np.zeros(0, dtype=np.int64)


def searchsorted_positions(
    a_sorted: torch.Tensor, queries: torch.Tensor
) -> torch.Tensor:
    """#{a < q} for each query, one sorted array: [NQ] int32."""
    return searchsorted(a_sorted[None], queries[None])[0]


def membership_chained(
    sorted_rows: torch.Tensor, valid_len: torch.Tensor, queries: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Membership backend built on the searchsorted kernel.

    ``sorted_rows`` [B, M], ``valid_len`` [B], ``queries`` [B, m0] ->
    (found [B, m0] bool, positions [B, m0] int64), the registry contract of
    ``search_vec``: positions are clamped to the row and meaningful only
    where ``found`` holds; int64 because the batched search gathers with
    them.
    """
    m = sorted_rows.shape[-1]
    pos = searchsorted(sorted_rows, queries)
    pos_c = pos.clamp(max=m - 1).long()
    found = (pos < valid_len[:, None]) & (
        torch.gather(sorted_rows, 1, pos_c) == queries
    )
    return found, pos_c


register_membership_backend("chained", membership_chained)


def run_query_chained(
    lists: list[IDList],
    semantics: str = "slca",
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """SLCA/ELCA/CA of one set of posting lists through the chained kernels.

    The reference's order of operations: lists sorted by length, the
    shortest list L0 probed against every other list (the CA mask and each
    list's NDesc at L0's entries, one ``intersect_lists`` launch for all the
    lists), parents from ``pidpos``, then the SLCA shift-compare, the ELCA
    child sums, or the CAs.  The lists and their table reach ``device`` in
    one copy, the tensors stay there between the kernels, and the result
    comes back in one copy; the CA count is the one other read (it sizes the
    compacted CA arrays).
    Returns the sorted result ids (int64).
    """
    if semantics not in ("slca", "elca", "ca"):
        raise ValueError(f"unknown semantics {semantics!r}")
    if not lists or any(len(l) == 0 for l in lists):
        return _EMPTY
    order = np.argsort([len(l) for l in lists], kind="stable")
    lists = [lists[i] for i in order]
    l0 = lists[0]
    n, k = len(l0), len(lists)
    dev = torch.device(device)

    # one host buffer (pinned on CUDA): L0 ids, parent ids and NDesc, then
    # each other list's ids and NDesc, then the table intersect_lists reads:
    # (ids offset, NDesc offset, length) of L0 and of each other list
    pid0 = np.where(l0.pidpos >= 0, l0.ids[np.clip(l0.pidpos, 0, n - 1)], -1)
    parts = [l0.ids, pid0, l0.ndesc]
    for l in lists[1:]:
        parts += [l.ids, l.ndesc]
    starts = np.cumsum([0] + [len(p) for p in parts])
    table = [(0, starts[2], n)] + [
        (starts[2 * j + 1], starts[2 * j + 2], len(l)) for j, l in enumerate(lists[1:], 1)
    ]
    total = int(starts[-1])
    host = torch.empty(total + 3 * k, dtype=torch.int32, pin_memory=dev.type == "cuda")
    host.numpy()[:] = np.concatenate(parts + [np.ravel(table)])
    buf = host.to(dev, non_blocking=True)
    ids0, pid0_t = buf[:n], buf[n : 2 * n]

    ca_mask, nd = intersect_lists(buf, buf[total:].view(k, 3), n)

    idx = torch.nonzero(ca_mask).squeeze(1)
    if idx.numel() == 0:
        return _EMPTY
    ca = ids0.index_select(0, idx)
    if semantics == "ca":
        return ca.cpu().numpy().astype(np.int64)
    par = pid0_t.index_select(0, idx)
    if semantics == "slca":
        keep = torch.cat([par[1:], par.new_full((1,), -1)]) != ca
    else:
        nd_ca = nd.index_select(1, idx)  # [k, #CA]
        keep = (nd_ca - elca_child_sums(ca, par, nd_ca) >= 1).all(dim=0)
    out = torch.where(keep, ca, -1).cpu().numpy()  # node ids are >= 0
    return out[out >= 0].astype(np.int64)
