"""Vectorized (PyTorch) set-intersection keyword search.

Data-parallel re-derivation of FwdSLCA/FwdELCA: instead of cursor walking, we

  1. intersect by *membership*: every element of the shortest list L0 is
     binary-searched into the other lists (batched ``torch.searchsorted``);
  2. compact the CA set with a sort (pad = INT32_MAX sorts to the tail);
  3. SLCA: a CA is SLCA iff the *next* CA's parent differs (ancestor-closure
     argument) — one shift-compare;
  4. ELCA: scatter-add child NDesc onto parent CA positions (``scatter_add_``)
     and test ``NDesc - Σchild >= 1`` per keyword.

Every function works natively over a leading work-item axis R (the DAG
engine batches redundancy components and queries along it), on whatever
device its tensors live: the same code is the ``"torch"`` backend on the
CPU and on CUDA.  Callers pad to power-of-two buckets (``PlanCache``).
"""
from __future__ import annotations

from collections.abc import Callable

import numpy as np
import torch

from repro_torch.kernels.shapes import INT_PAD, bucket  # noqa: F401  (re-exported)

from .idlist import IDList

# membership backend registry: name -> fn(sorted_rows, valid_len, queries)
#   sorted_rows [B, M] ascending int32, valid_len [B], queries [B, m0] int32
#   -> (found_mask [B, m0] bool, positions [B, m0] int64)
_MEMBERSHIP_BACKENDS: dict[str, Callable] = {}


def register_membership_backend(name: str, fn: Callable) -> None:
    _MEMBERSHIP_BACKENDS[name] = fn


def membership_torch(
    sorted_rows: torch.Tensor, valid_len: torch.Tensor, queries: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Membership + position of each query row in its padded sorted row."""
    m = sorted_rows.shape[-1]
    pos = torch.searchsorted(sorted_rows, queries, side="left")
    pos_c = pos.clamp(max=m - 1)
    found = (pos < valid_len[:, None]) & (
        torch.gather(sorted_rows, 1, pos_c) == queries
    )
    return found, pos_c


register_membership_backend("torch", membership_torch)


# --------------------------------------------------------------------------- #
# Core batched search
# --------------------------------------------------------------------------- #


def membership_stage(
    ids0: torch.Tensor,  # [R, m0] int32, ascending, padded with INT_PAD
    other_ids: torch.Tensor,  # [R, k-1, M] int32 padded ascending rows
    other_ndesc: torch.Tensor,  # [R, k-1, M] int32
    other_n: torch.Tensor,  # [R, k-1] int32 valid lengths
    backend: str = "torch",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Each L0 slot's membership in each other list and that list's NDesc at
    the match: (found [R, k-1, m0] bool, nd [R, k-1, m0] int32, 0 where not
    found).  Positions stay inside: they index ``other_ids`` (a segment of
    the lists, in the distributed search) and serve only its NDesc gather."""
    rows, m0 = ids0.shape
    k1, mo = other_ids.shape[1], other_ids.shape[2]
    member_fn = _MEMBERSHIP_BACKENDS[backend]
    if k1 == 0:  # single-keyword query: no other list
        return (torch.zeros((rows, 0, m0), dtype=torch.bool, device=ids0.device),
                torch.zeros((rows, 0, m0), dtype=torch.int32, device=ids0.device))
    found, pos = member_fn(
        other_ids.reshape(rows * k1, mo),
        other_n.reshape(rows * k1),
        ids0[:, None, :].expand(rows, k1, m0).reshape(rows * k1, m0).contiguous(),
    )
    nd = torch.gather(other_ndesc.reshape(rows * k1, mo), 1, pos)
    nd = torch.where(found, nd, torch.zeros_like(nd))
    return found.reshape(rows, k1, m0), nd.reshape(rows, k1, m0)


def keep_stage(
    ids0: torch.Tensor,  # [R, m0] int32, ascending, padded with INT_PAD
    pid0: torch.Tensor,  # [R, m0] int32 parent *ids* (-1 if none)
    ndesc0: torch.Tensor,  # [R, m0] int32
    n0: torch.Tensor,  # [R] int32 valid length of list 0
    found: torch.Tensor,  # [R, k-1, m0] bool, from membership_stage
    nd_others: torch.Tensor,  # [R, k-1, m0] int32, from membership_stage
    *,
    semantics: str = "slca",
) -> tuple[torch.Tensor, torch.Tensor]:
    """The CA set from the membership, compacted, then the SLCA, ELCA or CA
    rule: (result_ids [R, m0] int32, result_mask [R, m0] bool)."""
    rows, m0 = ids0.shape
    dev = ids0.device
    idx = torch.arange(m0, dtype=torch.int32, device=dev)
    # every list entry is a CA of a single-keyword query (all() of no rows)
    ca_mask = (idx[None, :] < n0[:, None]) & found.all(dim=1)
    nd = torch.cat([ndesc0[:, None, :], nd_others], dim=1)  # [R, k, m0]

    # compact the CA set ascending via one sort (pads go to the tail)
    pad = torch.full_like(ids0, int(INT_PAD))
    ca_ids = torch.where(ca_mask, ids0, pad)
    order = torch.argsort(ca_ids, dim=1, stable=True)
    ca_sorted = torch.gather(ca_ids, 1, order)
    cnt = ca_mask.sum(dim=1, dtype=torch.int32)
    valid = idx[None, :] < cnt[:, None]

    par_sorted = torch.gather(
        torch.where(ca_mask, pid0, torch.full_like(pid0, -1)), 1, order
    )

    if semantics == "slca":
        next_par = torch.cat(
            [par_sorted[:, 1:], torch.full_like(par_sorted[:, :1], -1)], dim=1
        )
        is_last = idx[None, :] == (cnt - 1)[:, None]
        res_mask = valid & (is_last | (next_par != ca_sorted))
    elif semantics == "elca":
        k = nd.shape[1]
        nd_sorted = torch.gather(nd, 2, order[:, None, :].expand(rows, k, m0))
        # position of each CA's parent inside the compacted CA row
        pp_c = torch.searchsorted(ca_sorted, par_sorted).clamp(max=m0 - 1)
        par_is_ca = (
            valid & (par_sorted >= 0)
            & (torch.gather(ca_sorted, 1, pp_c) == par_sorted)
        )
        # overflow slot m0 for roots / invalid entries
        seg = torch.where(par_is_ca, pp_c, torch.full_like(pp_c, m0))
        child_sum = torch.zeros((rows, k, m0 + 1), dtype=nd.dtype, device=dev)
        child_sum.scatter_add_(
            2,
            seg[:, None, :].expand(rows, k, m0),
            torch.where(valid[:, None, :], nd_sorted, torch.zeros_like(nd_sorted)),
        )
        res_mask = valid & (nd_sorted - child_sum[:, :, :m0] >= 1).all(dim=1)
    elif semantics == "ca":
        res_mask = valid
    else:
        raise ValueError(f"unknown semantics {semantics!r}")

    res_ids = torch.where(res_mask, ca_sorted, pad)
    return res_ids, res_mask


def ca_search_batch(
    ids0: torch.Tensor,  # [R, m0] int32, ascending, padded with INT_PAD
    pid0: torch.Tensor,  # [R, m0] int32 parent *ids* (-1 if none)
    ndesc0: torch.Tensor,  # [R, m0] int32
    other_ids: torch.Tensor,  # [R, k-1, M] int32 padded ascending rows
    other_ndesc: torch.Tensor,  # [R, k-1, M] int32
    n0: torch.Tensor,  # [R] int32 valid length of list 0
    other_n: torch.Tensor,  # [R, k-1] int32 valid lengths
    *,
    semantics: str = "slca",
    backend: str = "torch",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Return (result_ids [R, m0] int32, result_mask [R, m0] bool).

    Per row, results are compacted ascending; invalid tail slots hold INT_PAD.
    The two stages, :func:`membership_stage` then :func:`keep_stage`; the
    distributed search runs them apart, with the membership's all-reduce
    between.
    """
    found, nd = membership_stage(ids0, other_ids, other_ndesc, other_n, backend)
    return keep_stage(ids0, pid0, ndesc0, n0, found, nd, semantics=semantics)


def ca_search(
    ids0, pid0, ndesc0, other_ids, other_ndesc, n0, other_n,
    *, semantics: str = "slca", backend: str = "torch",
) -> tuple[torch.Tensor, torch.Tensor]:
    """ca_search_batch for one work item (unbatched shapes in and out)."""
    ids, mask = ca_search_batch(
        ids0[None], pid0[None], ndesc0[None], other_ids[None],
        other_ndesc[None], n0.reshape(1), other_n[None],
        semantics=semantics, backend=backend,
    )
    return ids[0], mask[0]


# --------------------------------------------------------------------------- #
# Host-side padding / bucketing helpers
# --------------------------------------------------------------------------- #


def pad_list(lst: IDList, m: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    n = len(lst)
    ids = np.full(m, INT_PAD, dtype=np.int32)
    nd = np.zeros(m, dtype=np.int32)
    pid = np.full(m, -1, dtype=np.int32)
    ids[:n] = lst.ids
    nd[:n] = lst.ndesc
    # parent *ids* resolved from pidpos once on host
    if n:
        pp = lst.pidpos
        pid[:n] = np.where(pp >= 0, lst.ids[np.clip(pp, 0, n - 1)], -1)
    return ids, pid, nd


def pack_query(lists: list[IDList], device: torch.device) -> dict | None:
    """Order lists (shortest first), pad to buckets; None if any list empty."""
    if not lists or any(len(l) == 0 for l in lists):
        return None
    order = np.argsort([len(l) for l in lists], kind="stable")
    lists = [lists[i] for i in order]
    m0 = bucket(len(lists[0]))
    mo = bucket(max((len(l) for l in lists[1:]), default=1))
    ids0, pid0, nd0 = pad_list(lists[0], m0)
    k1 = len(lists) - 1
    other_ids = np.full((k1, mo), INT_PAD, dtype=np.int32)
    other_nd = np.zeros((k1, mo), dtype=np.int32)
    other_n = np.zeros((k1,), dtype=np.int32)
    for i, l in enumerate(lists[1:]):
        other_ids[i, : len(l)] = l.ids
        other_nd[i, : len(l)] = l.ndesc
        other_n[i] = len(l)
    arrays = dict(
        ids0=ids0, pid0=pid0, ndesc0=nd0, other_ids=other_ids,
        other_ndesc=other_nd, n0=np.asarray(len(lists[0]), dtype=np.int32),
        other_n=other_n,
    )
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def run_query(
    lists: list[IDList],
    semantics: str = "slca",
    backend: str = "torch",
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Vectorized search over one set of IDLists -> sorted result node ids."""
    packed = pack_query(lists, torch.device(device))
    if packed is None:
        return np.zeros(0, dtype=np.int64)
    ids, mask = ca_search(**packed, semantics=semantics, backend=backend)
    ids = ids.cpu().numpy()
    mask = mask.cpu().numpy()
    return ids[mask].astype(np.int64)
