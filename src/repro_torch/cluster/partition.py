"""Corpus partitioner: one big tree -> N per-shard DAG indices.

A corpus tree is a root whose children are *documents* (the discogs
``<releases>`` root with one subtree per ``<release>``).  The partitioner
assigns **contiguous document ranges** to shards, balanced by node count, and
builds each shard's tree as

    local 0              a replica of the corpus root (same direct keywords)
    local 1..            the shard's documents, in corpus preorder

Contiguity is what keeps the scatter-gather exact *and* cheap: the documents
of shard ``s`` occupy one global preorder interval ``[node_start, node_end)``,
so every non-root local id maps to its original corpus id with a single
integer add (``global = local + node_start - 1``) — no per-node tables.
Because documents never span shards, every result node below the corpus root
is produced by exactly one shard with within-document semantics identical to
the monolith; only the corpus root itself needs cross-shard reasoning, which
the router reconstructs from the routing table and per-shard document stats
(see :mod:`repro_torch.cluster.router` for the proof sketch and
``tests/test_cluster.py`` for the machine-checked equivalence).

Routing: per keyword id, a bitmask of the shards whose *documents* contain it
(the replicated root's direct keywords are tracked separately — they exist in
every shard and would otherwise smear the bitmap).  A query can only match
inside a shard that contains every keyword, so the router fans out to the AND
of the masks.  Shard count is capped at 64 to keep the mask one uint64 wide.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.engine import KeywordSearchEngine
from repro_torch.core.xml_tree import XMLTree

MAX_SHARDS = 64


@dataclass(frozen=True)
class ShardSpec:
    """One shard's slice of the corpus (all ranges half-open)."""

    index: int
    doc_lo: int  # first document ordinal
    doc_hi: int  # one past the last document ordinal
    node_start: int  # global preorder id of the first document node
    node_end: int  # one past the last document node

    @property
    def id_offset(self) -> int:
        """shard-local id (>0) + id_offset == global corpus id."""
        return self.node_start - 1

    @property
    def num_docs(self) -> int:
        return self.doc_hi - self.doc_lo

    def to_json(self) -> dict:
        return {
            "index": self.index,
            "doc_lo": self.doc_lo,
            "doc_hi": self.doc_hi,
            "node_start": self.node_start,
            "node_end": self.node_end,
        }

    @classmethod
    def from_json(cls, obj: dict) -> ShardSpec:
        return cls(
            index=int(obj["index"]),
            doc_lo=int(obj["doc_lo"]),
            doc_hi=int(obj["doc_hi"]),
            node_start=int(obj["node_start"]),
            node_end=int(obj["node_end"]),
        )


def doc_roots(tree: XMLTree) -> np.ndarray:
    """Global preorder ids of the corpus documents (children of the root)."""
    return np.where(tree.parent == 0)[0].astype(np.int64)


def specs_from_bounds(tree: XMLTree, bounds: list[int]) -> list[ShardSpec]:
    """Shard specs for *arbitrary* contiguous document boundaries.

    ``bounds`` is ``[0, c1, ..., n_docs]`` — strictly increasing document
    ordinals; shard ``s`` owns documents ``[bounds[s], bounds[s+1])``.  This
    is the repartition primitive: any boundary vector a placement plan
    proposes becomes a valid layout here, with the same contiguity (and
    therefore exactness) guarantees as the build-time balancer.
    """
    roots = doc_roots(tree)
    n_docs = int(roots.size)
    if n_docs == 0:
        raise ValueError("corpus tree has no documents (root has no children)")
    bounds = [int(b) for b in bounds]
    if (
        len(bounds) < 2
        or bounds[0] != 0
        or bounds[-1] != n_docs
        or any(a >= b for a, b in zip(bounds, bounds[1:]))
    ):
        raise ValueError(
            f"doc bounds must be strictly increasing from 0 to {n_docs}, "
            f"got {bounds}"
        )
    if len(bounds) - 1 > MAX_SHARDS:
        raise ValueError(
            f"{len(bounds) - 1} shards exceeds MAX_SHARDS={MAX_SHARDS}"
        )
    specs = []
    for s in range(len(bounds) - 1):
        lo, hi = bounds[s], bounds[s + 1]
        start = int(roots[lo])
        end = int(roots[hi]) if hi < n_docs else tree.num_nodes
        specs.append(ShardSpec(s, lo, hi, start, end))
    return specs


def balanced_bounds(weights: np.ndarray, num_shards: int) -> list[int]:
    """Document boundaries cutting cumulative ``weights`` into equal shares.

    Cuts land at the ideal weight fractions, then are clamped so they stay
    strictly increasing and every shard keeps at least one document
    (``num_shards <= len(weights)`` makes both clamps always satisfiable).
    """
    weights = np.asarray(weights, dtype=np.float64)
    n_docs = int(weights.size)
    num_shards = max(1, min(int(num_shards), n_docs, MAX_SHARDS))
    cum = np.cumsum(weights)
    total = float(cum[-1])
    bounds = [0]
    for s in range(1, num_shards):
        c = int(np.searchsorted(cum, total * s / num_shards, side="left")) + 1
        c = max(c, bounds[-1] + 1)
        c = min(c, n_docs - (num_shards - s))
        bounds.append(c)
    bounds.append(n_docs)
    return bounds


def split_doc_ranges(tree: XMLTree, num_shards: int) -> list[ShardSpec]:
    """Contiguous document ranges, balanced by total node count per shard."""
    roots = doc_roots(tree)
    if roots.size == 0:
        raise ValueError("corpus tree has no documents (root has no children)")
    sizes = tree.subtree_size[roots].astype(np.int64)
    return specs_from_bounds(tree, balanced_bounds(sizes, num_shards))


def heat_weighted_bounds(
    tree: XMLTree,
    num_shards: int,
    doc_heat: np.ndarray | list[float],
    *,
    smoothing: float = 1.0,
) -> list[int]:
    """Document boundaries balancing *observed query heat*, not node count.

    ``doc_heat[d]`` is a per-document load weight (e.g. expanded from the
    load report's doc-range histogram, see
    :func:`repro_torch.cluster.rebalance.doc_heat_weights`).  ``smoothing`` adds a
    uniform node-count-proportional floor so documents that saw zero traffic
    still spread across shards instead of collapsing into one — with no heat
    at all this degrades exactly to the node-count balancer.
    """
    roots = doc_roots(tree)
    n_docs = int(roots.size)
    if n_docs == 0:
        raise ValueError("corpus tree has no documents (root has no children)")
    heat = np.asarray(doc_heat, dtype=np.float64)
    if heat.shape != (n_docs,):
        raise ValueError(
            f"doc_heat must have one weight per document ({n_docs}), "
            f"got shape {heat.shape}"
        )
    sizes = tree.subtree_size[roots].astype(np.float64)
    floor = sizes / sizes.sum() * max(float(smoothing), 0.0)
    total = float(heat.sum())
    load = heat / total if total > 0 else np.zeros(n_docs)
    return balanced_bounds(load + floor, num_shards)


def shard_tree(tree: XMLTree, spec: ShardSpec) -> XMLTree:
    """Materialize one shard's tree by slicing the corpus arrays.

    The shard shares the corpus :class:`Vocab` object, so keyword ids are
    identical across shards and the routing bitmap indexes all of them.
    """
    g0, g1 = spec.node_start, spec.node_end
    span = g1 - g0
    parent = np.empty(span + 1, dtype=np.int32)
    parent[0] = -1
    gp = tree.parent[g0:g1]
    # document roots keep the replica root as parent; everyone else shifts
    parent[1:] = np.where(gp == 0, 0, gp - spec.id_offset)
    subtree = np.empty(span + 1, dtype=np.int32)
    subtree[0] = span + 1
    subtree[1:] = tree.subtree_size[g0:g1]
    root_kws = tree.direct_keywords(0)
    k0, k1 = tree.kw_offsets[g0], tree.kw_offsets[g1]
    kw_offsets = np.empty(span + 2, dtype=np.int64)
    kw_offsets[0] = 0
    kw_offsets[1:] = tree.kw_offsets[g0 : g1 + 1] - k0 + root_kws.size
    kw_ids = np.concatenate([root_kws, tree.kw_ids[k0:k1]]).astype(np.int32)
    return XMLTree(parent, subtree, kw_offsets, kw_ids, tree.vocab)


def routing_arrays(
    tree: XMLTree, specs: list[ShardSpec]
) -> tuple[np.ndarray, np.ndarray]:
    """(masks, root_kw_ids): per-keyword shard bitmap + the root's own kws.

    ``masks[kid]`` has bit ``s`` set iff some *document* of shard ``s``
    contains keyword ``kid``.  The corpus root's direct keywords are excluded
    here (they are replicated into every shard) and reported separately.
    """
    masks = np.zeros(len(tree.vocab), dtype=np.uint64)
    for spec in specs:
        k0 = tree.kw_offsets[spec.node_start]
        k1 = tree.kw_offsets[spec.node_end]
        present = np.unique(tree.kw_ids[k0:k1])
        masks[present] |= np.uint64(1) << np.uint64(spec.index)
    root_kw_ids = np.unique(tree.direct_keywords(0)).astype(np.int32)
    return masks, root_kw_ids


def partition_corpus(
    tree: XMLTree, num_shards: int, device: str | torch.device = "cuda"
) -> tuple[list[tuple[ShardSpec, KeywordSearchEngine]], np.ndarray, np.ndarray]:
    """Split + index in-process: [(spec, engine)], routing masks, root kws.

    Each shard gets its own DAG/IDCluster build and its own PlanCache on
    ``device`` — this is the in-memory twin of
    :func:`repro_torch.cluster.manifest.build_cluster`, used by tests and
    benchmarks that don't need the artifact round-trip.
    """
    specs = split_doc_ranges(tree, num_shards)
    shards = [
        (spec, KeywordSearchEngine.from_tree(shard_tree(tree, spec), device=device))
        for spec in specs
    ]
    masks, root_kw_ids = routing_arrays(tree, specs)
    return shards, masks, root_kw_ids
