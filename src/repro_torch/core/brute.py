"""Brute-force CA/SLCA/ELCA oracle, straight from the definitions (§II-B).

Used only by tests and benchmarks as ground truth; O(N·k) per query via
preorder-interval prefix sums — no index, no intersection, no DAG.
"""
from __future__ import annotations

import numpy as np

from .xml_tree import XMLTree


def _direct_mask(tree: XMLTree, kw: int) -> np.ndarray:
    mask = np.zeros(tree.num_nodes, dtype=np.int64)
    if kw < 0:
        return mask
    hit = tree.kw_ids == kw
    if hit.any():
        # nodes owning the matching CSR slots
        node_of = np.repeat(
            np.arange(tree.num_nodes), np.diff(tree.kw_offsets).astype(np.int64)
        )
        mask[node_of[hit]] = 1
    return mask


def subtree_counts(tree: XMLTree, kw: int) -> np.ndarray:
    """#nodes directly containing ``kw`` inside each node's subtree (NDesc)."""
    direct = _direct_mask(tree, kw)
    prefix = np.concatenate([[0], np.cumsum(direct)])
    n = np.arange(tree.num_nodes)
    return prefix[n + tree.subtree_size] - prefix[n]


def ca_nodes(tree: XMLTree, kws: list[int]) -> np.ndarray:
    """All common ancestors of a keyword set, ascending node ids."""
    if not kws:
        return np.zeros(0, dtype=np.int64)
    ok = np.ones(tree.num_nodes, dtype=bool)
    for k in kws:
        ok &= subtree_counts(tree, k) > 0
    return np.nonzero(ok)[0].astype(np.int64)


def slca_nodes(tree: XMLTree, kws: list[int]) -> np.ndarray:
    """SLCA = CA nodes with no CA descendant (preorder-interval check)."""
    ca = ca_nodes(tree, kws)
    if ca.size == 0:
        return ca
    ends = ca + tree.subtree_size[ca]
    nxt = np.searchsorted(ca, ca + 1)  # position of next CA in preorder
    next_ca = np.where(nxt < ca.size, ca[np.minimum(nxt, ca.size - 1)], np.iinfo(np.int64).max)
    return ca[next_ca >= ends]


def elca_nodes(tree: XMLTree, kws: list[int]) -> np.ndarray:
    """ELCA per §II-B: each keyword present outside every CA-child subtree."""
    ca = ca_nodes(tree, kws)
    if ca.size == 0:
        return ca
    ca_set = set(map(int, ca))
    counts = np.stack([subtree_counts(tree, k) for k in kws])  # [k, N]
    # nearest CA proper ancestor of each CA node
    remaining = {int(c): counts[:, c].astype(np.int64).copy() for c in ca}
    parent = tree.parent
    for c in map(int, ca):
        p = int(parent[c])
        while p >= 0 and p not in ca_set:
            p = int(parent[p])
        if p >= 0:
            remaining[p] -= counts[:, c]
    out = [c for c in map(int, ca) if np.all(remaining[c] >= 1)]
    return np.asarray(out, dtype=np.int64)
