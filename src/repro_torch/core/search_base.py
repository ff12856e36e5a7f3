"""Paper-faithful set-intersection keyword search (Zhou et al. + DAG variants).

These are the reference algorithms: scalar, host-side, semantically identical
to FwdSLCA / BwdSLCA(+) / FwdELCA / BwdELCA of [1][2] and to the paper's
DagFwdSLCA / DagFwdELCA (Figs. 6/7).  The vectorized torch backend and the
fused CUDA kernel are validated against these.

All functions take a list of IDLists (one per query keyword) and return a
sorted numpy array of result node ids.  An empty list for any keyword (or an
unknown keyword) yields an empty result.
"""
from __future__ import annotations

from bisect import bisect_left, bisect_right
from collections.abc import Callable
from typing import TYPE_CHECKING

import numpy as np

from .idlist import IDList

if TYPE_CHECKING:  # pragma: no cover
    from .components import IDClusterIndex

_EMPTY = np.zeros(0, dtype=np.int64)


# --------------------------------------------------------------------------- #
# CA enumeration
# --------------------------------------------------------------------------- #


def _fwd_get_ca(lists: list[IDList], cur: list[int]) -> int | None:
    """Advance cursors to the next common-ancestor node (ascending); None at EoL.

    Classic max-of-heads + forward binary search (fwdGetCA of [2]).
    On success all cursors point at the CA's entry in their list.
    """
    k = len(lists)
    while True:
        m = -1
        for i in range(k):
            if cur[i] >= len(lists[i]):
                return None
            v = int(lists[i].ids[cur[i]])
            if v > m:
                m = v
        matched = True
        for i in range(k):
            ids = lists[i].ids
            c = bisect_left(ids, m, cur[i])
            cur[i] = c
            if c >= len(ids):
                return None
            if int(ids[c]) != m:
                matched = False
        if matched:
            return m


def _bwd_get_ca(lists: list[IDList], cur: list[int]) -> int | None:
    """Mirror of fwdGetCA scanning descending (BwdSLCA/BwdELCA of [2]).

    The binary search range is inherently shrunken to [0, cursor] — the
    array-side improvement BwdSLCA+ introduces.
    """
    k = len(lists)
    while True:
        m = None
        for i in range(k):
            if cur[i] < 0:
                return None
            v = int(lists[i].ids[cur[i]])
            if m is None or v < m:
                m = v
        matched = True
        for i in range(k):
            ids = lists[i].ids
            # rightmost position with id <= m, bounded above by the cursor
            c = bisect_right(ids, m, 0, cur[i] + 1) - 1
            cur[i] = c
            if c < 0:
                return None
            if int(ids[c]) != m:
                matched = False
        if matched:
            return m


def _parent_id(lst: IDList, pos: int) -> int:
    pp = int(lst.pidpos[pos])
    return int(lst.ids[pp]) if pp >= 0 else -1


# --------------------------------------------------------------------------- #
# SLCA
# --------------------------------------------------------------------------- #


def fwd_slca(lists: list[IDList]) -> np.ndarray:
    """FwdSLCA: ascending CA scan; u is SLCA iff the next CA is not u's child."""
    if any(len(l) == 0 for l in lists) or not lists:
        return _EMPTY
    cur = [0] * len(lists)
    out: list[int] = []
    u = None
    while True:
        v = _fwd_get_ca(lists, cur)
        if v is None:
            break
        if u is not None and _parent_id(lists[0], cur[0]) != u:
            out.append(u)
        u = v
        for i in range(len(cur)):
            cur[i] += 1
    if u is not None:
        out.append(u)
    return np.asarray(out, dtype=np.int64)


def bwd_slca(lists: list[IDList]) -> np.ndarray:
    """BwdSLCA(+): descending CA scan with ancestor suppression.

    A CA found in descending order is an SLCA iff it is not an ancestor of a
    previously found SLCA; ancestor node-id chains (via PIDPos) are memoised
    so each chain segment is walked once.  The shrunken binary search of
    BwdSLCA+ is inherent to the array form (search ranges are [0, cursor]).
    """
    if any(len(l) == 0 for l in lists) or not lists:
        return _EMPTY
    cur = [len(l) - 1 for l in lists]
    anc: set[int] = set()
    out: list[int] = []
    while True:
        v = _bwd_get_ca(lists, cur)
        if v is None:
            break
        if v not in anc:
            out.append(v)
            # record v's ancestors; stop at the first already-known id —
            # everything above it was recorded by an earlier walk
            p = int(lists[0].pidpos[cur[0]])
            while p >= 0:
                pid = int(lists[0].ids[p])
                if pid in anc:
                    break
                anc.add(pid)
                p = int(lists[0].pidpos[p])
        for i in range(len(cur)):
            cur[i] -= 1
    out.reverse()
    return np.asarray(out, dtype=np.int64)


bwd_slca_plus = bwd_slca  # search-space shrinking is inherent to the array form


# --------------------------------------------------------------------------- #
# ELCA
# --------------------------------------------------------------------------- #


def fwd_elca(lists: list[IDList]) -> np.ndarray:
    """FwdELCA: ascending CA scan with a stack of (NDesc, child-accum) arrays."""
    if any(len(l) == 0 for l in lists) or not lists:
        return _EMPTY
    k = len(lists)
    cur = [0] * len(lists)
    out: list[int] = []
    # stack entries: [node_id, parent_id, ndesc vector, accum vector]
    stack: list[list] = []

    def process_top() -> None:
        node, parent, nd, acc = stack.pop()
        if all(nd[i] - acc[i] >= 1 for i in range(k)):
            out.append(node)
        if stack and stack[-1][0] == parent:
            top_acc = stack[-1][3]
            for i in range(k):
                top_acc[i] += nd[i]

    while True:
        v = _fwd_get_ca(lists, cur)
        if v is None:
            break
        parent = _parent_id(lists[0], cur[0])
        while stack and stack[-1][0] != parent:
            process_top()
        nd = [int(lists[i].ndesc[cur[i]]) for i in range(k)]
        stack.append([v, parent, nd, [0] * k])
        for i in range(len(cur)):
            cur[i] += 1
    while stack:
        process_top()
    out.sort()
    return np.asarray(out, dtype=np.int64)


def bwd_elca(lists: list[IDList]) -> np.ndarray:
    """BwdELCA: descending CA scan; children precede parents, so child NDesc
    sums are complete by the time each parent is judged."""
    if any(len(l) == 0 for l in lists) or not lists:
        return _EMPTY
    k = len(lists)
    cur = [len(l) - 1 for l in lists]
    acc: dict[int, list[int]] = {}
    out: list[int] = []
    while True:
        v = _bwd_get_ca(lists, cur)
        if v is None:
            break
        nd = [int(lists[i].ndesc[cur[i]]) for i in range(k)]
        a = acc.pop(v, None)
        if a is None or all(nd[i] - a[i] >= 1 for i in range(k)):
            out.append(v)
        parent = _parent_id(lists[0], cur[0])
        if parent >= 0:
            pa = acc.setdefault(parent, [0] * k)
            for i in range(k):
                pa[i] += nd[i]
        for i in range(len(cur)):
            cur[i] -= 1
    out.reverse()
    return np.asarray(out, dtype=np.int64)


def ca_all(lists: list[IDList]) -> np.ndarray:
    """All common ancestors, ascending (used by tests and table properties)."""
    if any(len(l) == 0 for l in lists) or not lists:
        return _EMPTY
    cur = [0] * len(lists)
    out: list[int] = []
    while True:
        v = _fwd_get_ca(lists, cur)
        if v is None:
            break
        out.append(v)
        for i in range(len(cur)):
            cur[i] += 1
    return np.asarray(out, dtype=np.int64)


BASE_ALGORITHMS: dict[str, Callable[[list[IDList]], np.ndarray]] = {
    "fwd_slca": fwd_slca,
    "bwd_slca": bwd_slca,
    "bwd_slca_plus": bwd_slca_plus,
    "fwd_elca": fwd_elca,
    "bwd_elca": bwd_elca,
}


# --------------------------------------------------------------------------- #
# DAG variants (paper Figs. 6/7): per-RC base search + RCPM splicing
# --------------------------------------------------------------------------- #


def dag_search(
    index: IDClusterIndex,
    kws: list[int],
    algorithm: str = "fwd_slca",
    collect_stats: dict | None = None,
) -> np.ndarray:
    """DagFwd/BwdSLCA/ELCA: lazily search RCs once, splice via the RCPM.

    ``algorithm`` names any entry of BASE_ALGORITHMS — the base algorithm is
    integrated as an unmodified module, exactly as the paper requires.
    """
    base = BASE_ALGORITHMS[algorithm]
    memo: dict[int, np.ndarray] = {}
    rcs = index.rcs
    dummy_ids = rcs.dummy_ids

    def solve(rc: int) -> np.ndarray:
        got = memo.get(rc)
        if got is not None:
            return got
        lists = index.idlists(rc, kws)
        res = base(lists)
        if collect_stats is not None:
            collect_stats["rcs_searched"] = collect_stats.get("rcs_searched", 0) + 1
            collect_stats["list_entries"] = collect_stats.get("list_entries", 0) + sum(
                len(l) for l in lists
            )
        root = index.rc_root_id(rc)
        # vectorized RCPM probe (the paper's O(1)-array lookup, batched):
        # category-1 queries pay one searchsorted instead of a Python loop
        if dummy_ids.size and res.size:
            pos = np.searchsorted(dummy_ids, res)
            pos_c = np.clip(pos, 0, dummy_ids.size - 1)
            is_dummy = (dummy_ids[pos_c] == res) & (res != root)
        else:
            is_dummy = np.zeros(res.shape, dtype=bool)
        if not is_dummy.any():
            memo[rc] = res
            return res
        parts = [res[~is_dummy]]
        for _x, p in zip(res[is_dummy], pos_c[is_dummy]):
            nested_rc = int(rcs.dummy_nested_rc[p])
            offset = int(rcs.dummy_offset[p])
            parts.append(solve(nested_rc) + offset)
        arr = np.sort(np.concatenate(parts)).astype(np.int64)
        memo[rc] = arr
        return arr

    return solve(0)
