"""Pass 1 — DAG compression of the XML tree (paper §III-A).

Two nodes are *identical* iff (a) they directly contain the same keywords and
(b) their child lists are identical (element-wise, in order).  Identical
subtrees are hash-consed: every node maps to its canonical representative
(the occurrence with the smallest preorder id).  An edge whose original child
was deduplicated becomes an *offset edge* carrying ``ID(child') - ID(canon)``
so original ids remain recoverable.  Every canonical node carries its
``OccurrenceCount`` — how many original nodes it represents.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .xml_tree import XMLTree


@dataclass
class DagInfo:
    """Result of the compression pass.

    canon[i]       canonical (first-occurrence) id of original node i
    occ[i]         OccurrenceCount of canonical node i (0 for non-canonical)
    num_canonical  number of surviving DAG nodes
    """

    canon: np.ndarray  # int32[N]
    occ: np.ndarray  # int64[N]
    num_canonical: int

    def is_canonical(self) -> np.ndarray:
        return self.canon == np.arange(self.canon.shape[0], dtype=np.int32)


def compress(tree: XMLTree) -> DagInfo:
    """Hash-cons all subtrees bottom-up *by height*.

    Identical subtrees have identical heights, so processing all nodes of
    height h before any node of height h+1 guarantees that every child's
    canonical id is final when a parent's signature is formed.  (A naive
    reversed-preorder sweep is wrong: a later-discovered smaller occurrence
    of a child would retroactively change earlier parents' signatures.)

    Canonical representative = the occurrence with the smallest preorder id.
    """
    n = tree.num_nodes
    canon = np.arange(n, dtype=np.int32)
    children = tree.children_lists()
    kw_off, kw_ids = tree.kw_offsets, tree.kw_ids

    # heights (leaf = 0); parent < child in preorder so one reversed pass works
    height = np.zeros(n, dtype=np.int32)
    par = tree.parent
    for i in range(n - 1, 0, -1):
        hp = height[i] + 1
        if hp > height[par[i]]:
            height[par[i]] = hp

    def find(x: int) -> int:
        # path-halving union-find over canon (pointers always go to smaller id)
        while canon[x] != x:
            canon[x] = canon[canon[x]]
            x = canon[x]
        return int(x)

    order = np.argsort(height, kind="stable")  # height-ascending buckets
    sig_to_id: dict[tuple, int] = {}
    for i in map(int, order):
        sig = (
            kw_ids[kw_off[i] : kw_off[i + 1]].tobytes(),
            tuple(find(c) for c in children[i]),
        )
        rep = sig_to_id.get(sig)
        if rep is None:
            sig_to_id[sig] = i
        elif i < rep:
            canon[rep] = i
            sig_to_id[sig] = i
        else:
            canon[i] = rep

    # full resolution: ascending sweep (targets are final by construction)
    for i in range(n):
        canon[i] = canon[canon[i]]

    occ = np.zeros(n, dtype=np.int64)
    np.add.at(occ, canon, 1)
    num_canonical = int((canon == np.arange(n, dtype=np.int32)).sum())
    return DagInfo(canon=canon, occ=occ, num_canonical=num_canonical)
