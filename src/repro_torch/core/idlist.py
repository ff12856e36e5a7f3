"""IDList index (Zhou et al. [1][2]) — the substrate the paper builds on.

An IDList for keyword ``k`` is the sorted inverted list of every node that
*contains* ``k`` (directly or through any descendant).  Each entry carries

  ID      preorder id of the node
  PIDPos  position of the node's parent inside the *same* IDList (-1 at root)
  NDesc   number of nodes in the entry's subtree that contain ``k`` directly

All three live in dense int32 arrays; the index is a dict keyword-id -> IDList.

The builder is fully vectorized: direct (node, keyword) postings are
propagated to ancestors level-by-level with ``np.unique`` merges — total work
is the sum of root paths of all postings (the ``path`` column of the paper's
Table III), not #nodes × #keywords.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .xml_tree import XMLTree


@dataclass
class IDList:
    """One keyword's inverted list (sorted by ID)."""

    ids: np.ndarray  # int32[m], ascending
    pidpos: np.ndarray  # int32[m], position of parent entry, -1 if none
    ndesc: np.ndarray  # int32[m]

    def __len__(self) -> int:
        return int(self.ids.shape[0])

    def validate(self) -> None:
        m = len(self)
        assert self.pidpos.shape == (m,) and self.ndesc.shape == (m,)
        if m:
            assert np.all(np.diff(self.ids) > 0), "IDList ids not strictly sorted"
            assert np.all(self.pidpos < np.arange(m)), "parent must precede child"
            assert np.all(self.ndesc >= 1)


@dataclass
class ContainmentTable:
    """All (node, keyword, count) containment triples, sorted by (kw, node).

    ``count`` is the number of nodes in ``node``'s subtree directly containing
    ``kw`` (the IDList NDesc).  This table is shared by the base index and the
    DAG index builder (the per-RC lists are filtered views of it).
    """

    kws: np.ndarray  # int32[nnz] sorted (primary)
    nodes: np.ndarray  # int32[nnz] sorted within each kw segment
    counts: np.ndarray  # int32[nnz]
    kw_starts: np.ndarray  # int64[K+1] CSR offsets per keyword id

    def slice_for(self, kw: int) -> tuple[np.ndarray, np.ndarray]:
        lo, hi = self.kw_starts[kw], self.kw_starts[kw + 1]
        return self.nodes[lo:hi], self.counts[lo:hi]


def build_containment(tree: XMLTree) -> ContainmentTable:
    """Propagate direct postings to all ancestors, accumulating node counts."""
    n = tree.num_nodes
    num_kw = len(tree.vocab)
    node_of = np.repeat(
        np.arange(n, dtype=np.int64), np.diff(tree.kw_offsets).astype(np.int64)
    )
    kw_of = tree.kw_ids.astype(np.int64)

    # key = kw * n + node  (fits int64 comfortably for our scales)
    def pack(nodes: np.ndarray, kws: np.ndarray) -> np.ndarray:
        return kws * n + nodes

    acc_keys = [pack(node_of, kw_of)]
    acc_vals = [np.ones(node_of.shape[0], dtype=np.int64)]

    cur_nodes, cur_kws = node_of, kw_of
    cur_vals = np.ones(node_of.shape[0], dtype=np.int64)
    parent = tree.parent.astype(np.int64)
    while cur_nodes.size:
        nxt_nodes = parent[cur_nodes]
        keep = nxt_nodes >= 0
        nxt_nodes, nxt_kws, nxt_vals = nxt_nodes[keep], cur_kws[keep], cur_vals[keep]
        if nxt_nodes.size == 0:
            break
        keys = pack(nxt_nodes, nxt_kws)
        # merge duplicates at this level so the frontier stays minimal
        uk, inv = np.unique(keys, return_inverse=True)
        uv = np.zeros(uk.shape[0], dtype=np.int64)
        np.add.at(uv, inv, nxt_vals)
        acc_keys.append(uk)
        acc_vals.append(uv)
        cur_nodes, cur_kws, cur_vals = uk % n, uk // n, uv

    all_keys = np.concatenate(acc_keys)
    all_vals = np.concatenate(acc_vals)
    uk, inv = np.unique(all_keys, return_inverse=True)
    uv = np.zeros(uk.shape[0], dtype=np.int64)
    np.add.at(uv, inv, all_vals)

    kws = (uk // n).astype(np.int32)
    nodes = (uk % n).astype(np.int32)
    counts = uv.astype(np.int32)
    kw_starts = np.zeros(num_kw + 1, dtype=np.int64)
    np.add.at(kw_starts, kws + 1, 1)
    np.cumsum(kw_starts, out=kw_starts)
    return ContainmentTable(kws=kws, nodes=nodes, counts=counts, kw_starts=kw_starts)


class BaseIndex:
    """Tree-based IDList index — the paper's baseline (Zhou et al.)."""

    def __init__(self, tree: XMLTree, containment: ContainmentTable | None = None):
        self.tree = tree
        self.containment = containment or build_containment(tree)
        self._cache: dict[int, IDList] = {}

    def idlist(self, kw: int) -> IDList:
        """Materialize (and cache) the IDList for a keyword id."""
        got = self._cache.get(kw)
        if got is not None:
            return got
        if kw < 0 or kw + 1 >= self.containment.kw_starts.shape[0]:
            lst = IDList(
                np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0, np.int32)
            )
        else:
            nodes, counts = self.containment.slice_for(kw)
            pidpos = make_pidpos(nodes, self.tree.parent)
            lst = IDList(
                ids=nodes.astype(np.int32),
                pidpos=pidpos,
                ndesc=counts.astype(np.int32),
            )
        self._cache[kw] = lst
        return lst

    def idlists(self, kws: list[int]) -> list[IDList]:
        return [self.idlist(k) for k in kws]

    def num_entries(self) -> int:
        """Total IDList entries across all keywords (paper §IV-F index size)."""
        return int(self.containment.nodes.shape[0])


def make_pidpos(sorted_ids: np.ndarray, parent: np.ndarray) -> np.ndarray:
    """PIDPos for a sorted id array: position of each entry's parent entry.

    Every non-root entry's parent is guaranteed to be present
    (containment is ancestor-closed); entries whose parent is absent
    (the component root) get -1.
    """
    if sorted_ids.size == 0:
        return np.zeros(0, dtype=np.int32)
    par = parent[sorted_ids]
    pos = np.searchsorted(sorted_ids, par)
    pos_clip = np.clip(pos, 0, sorted_ids.size - 1)
    found = (par >= 0) & (sorted_ids[pos_clip] == par)
    return np.where(found, pos_clip, -1).astype(np.int32)
