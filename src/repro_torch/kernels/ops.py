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
from .intersect import intersect_membership
from .searchsorted import searchsorted

__all__ = [
    "elca_child_sums",
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

    The reference's order of operations: lists sorted by length, one
    membership call per other list into the shortest list L0, the CA mask,
    parents from ``pidpos``, then the SLCA shift-compare, the ELCA child
    sums, or the CAs.  The lists reach ``device`` in one copy, the tensors
    stay there between the kernels, and the result comes back in one copy;
    the CA count is the one other read (it sizes the compacted CA arrays).
    Returns the sorted result ids (int64).
    """
    if semantics not in ("slca", "elca", "ca"):
        raise ValueError(f"unknown semantics {semantics!r}")
    if not lists or any(len(l) == 0 for l in lists):
        return _EMPTY
    order = np.argsort([len(l) for l in lists], kind="stable")
    lists = [lists[i] for i in order]
    l0 = lists[0]
    n = len(l0)
    dev = torch.device(device)

    # one host buffer (pinned on CUDA): L0 ids, parent ids and NDesc, then
    # each other list's ids and NDesc
    pid0 = np.where(l0.pidpos >= 0, l0.ids[np.clip(l0.pidpos, 0, n - 1)], -1)
    parts = [l0.ids, pid0, l0.ndesc]
    for l in lists[1:]:
        parts += [l.ids, l.ndesc]
    sizes = [len(p) for p in parts]
    host = torch.empty(sum(sizes), dtype=torch.int32, pin_memory=dev.type == "cuda")
    host.numpy()[:] = np.concatenate(parts)
    views = torch.split(host.to(dev, non_blocking=True), sizes)
    ids0, pid0_t = views[0], views[1]

    ca_mask = torch.ones(n, dtype=torch.bool, device=dev)
    nd = [views[2]]
    for ids, ndesc in zip(views[3::2], views[4::2]):
        found, pos = intersect_membership(ids, ids0)
        ca_mask &= found
        nd.append(ndesc.index_select(0, pos))  # pos is 0, a valid slot, on a miss

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
        nd_ca = torch.stack(nd).index_select(1, idx)  # [k, #CA]
        keep = (nd_ca - elca_child_sums(ca, par, nd_ca) >= 1).all(dim=0)
    out = torch.where(keep, ca, -1).cpu().numpy()  # node ids are >= 0
    return out[out >= 0].astype(np.int64)
