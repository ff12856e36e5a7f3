"""Workload heat tracking: which keywords and doc ranges traffic actually hits.

The paper's DAG compression makes query cost a function of *what* the
workload asks for — hot keywords drive RC-subset launches, hot doc ranges
drive which shard pages stay resident — so the rebalancer-facing telemetry
is three fixed-memory summaries per worker:

  * :class:`CountMinSketch` — approximate per-keyword-id hit counts.
    Linear (merge = element-wise table sum), so the merged sketch's
    estimates are *exactly* the estimates of a sketch fed the concatenated
    streams — the property that makes cross-worker rollups honest.  Hash
    rows use fixed multiply-shift constants, identical in every process,
    which is what makes tables from different workers mergeable at all.
  * :class:`SpaceSaving` — the top-K heavy hitters with per-key error
    bounds (``count`` overestimates the true frequency by at most
    ``err``).  The sketch is exact while distinct keys fit the capacity.
  * a fixed-granularity **doc-range histogram** — result spans bucketed
    over the shard's node-id space (documents are contiguous id ranges, so
    result min/max is a doc-range statement), O(buckets) memory.

:class:`HeatSketch` bundles the three behind one lock with an O(#keywords)
allocation-free ``record()`` for the engine/service hot path, gated on the
module-level :data:`ENABLED` flag (env ``XKS_HEAT``, default on — the
benchmark gate in ``compare.py --checks heat`` keeps it cheap enough to
never turn off).  Sketches ride the stats wire header exactly like the
latency histogram: ``to_dict``/``from_dict`` are JSON-safe, old peers
ignore the unknown field.
"""
from __future__ import annotations

import os
import threading

__all__ = [
    "ENABLED",
    "CountMinSketch",
    "HeatShapeError",
    "HeatSketch",
    "SpaceSaving",
    "set_enabled",
]

_FALSY = ("0", "false", "off", "no", "")

#: process-wide heat-tracking switch; ``record()`` is a no-op when False.
ENABLED = os.environ.get("XKS_HEAT", "1").strip().lower() not in _FALSY


def set_enabled(flag: bool) -> bool:
    """Flip the process-wide heat switch (benchmarks toggle it per drive)."""
    global ENABLED
    ENABLED = bool(flag)
    return ENABLED


class HeatShapeError(ValueError):
    """Merging sketches with different shapes would silently misaccount."""


# fixed odd 64-bit multipliers/offsets: every process hashes identically,
# so tables merged across workers stay row-aligned
_MOD = (1 << 61) - 1  # Mersenne prime
_HASH_A = (
    0x9E3779B97F4A7C15, 0xC2B2AE3D27D4EB4F,
    0x165667B19E3779F9, 0xFF51AFD7ED558CCD,
    0x27D4EB2F165667C5, 0x85EBCA77C2B2AE63,
)
_HASH_B = (
    0x94D049BB133111EB, 0xBF58476D1CE4E5B9,
    0x2545F4914F6CDD1D, 0xD6E8FEB86659FD93,
    0x7F4A7C159E3779B9, 0x1CE4E5B9BF58476D,
)


class CountMinSketch:
    """Approximate counts over integer keys; never undercounts.

    ``estimate(k) >= true_count(k)`` always, with overestimate at most
    ``total / width`` per row in expectation.  Not self-locking — the
    owning :class:`HeatSketch` serializes access.
    """

    __slots__ = ("width", "depth", "table", "total")

    def __init__(self, width: int = 512, depth: int = 4):
        if not (1 <= depth <= len(_HASH_A)):
            raise ValueError(f"depth must be in 1..{len(_HASH_A)}, got {depth}")
        if width < 1:
            raise ValueError(f"width must be >= 1, got {width}")
        self.width = int(width)
        self.depth = int(depth)
        self.table = [[0] * self.width for _ in range(self.depth)]
        self.total = 0

    def _row_index(self, row: int, key: int) -> int:
        return ((_HASH_A[row] * (key + 1) + _HASH_B[row]) % _MOD) % self.width

    def add(self, key: int, n: int = 1) -> None:
        key = int(key)
        for r in range(self.depth):
            self.table[r][self._row_index(r, key)] += n
        self.total += n

    def estimate(self, key: int) -> int:
        key = int(key)
        return min(
            self.table[r][self._row_index(r, key)] for r in range(self.depth)
        )

    def merge(self, other: "CountMinSketch") -> "CountMinSketch":
        if (other.width, other.depth) != (self.width, self.depth):
            raise HeatShapeError(
                f"count-min shape mismatch: {self.depth}x{self.width} vs "
                f"{other.depth}x{other.width}"
            )
        for mine, theirs in zip(self.table, other.table):
            for i, c in enumerate(theirs):
                if c:
                    mine[i] += c
        self.total += other.total
        return self

    def copy(self) -> "CountMinSketch":
        out = CountMinSketch.__new__(CountMinSketch)
        out.width, out.depth = self.width, self.depth
        out.table = [list(row) for row in self.table]
        out.total = self.total
        return out

    def to_dict(self) -> dict:
        return {
            "width": self.width,
            "depth": self.depth,
            "table": [list(row) for row in self.table],
            "total": self.total,
        }

    @classmethod
    def from_dict(cls, obj: dict) -> "CountMinSketch":
        out = cls(int(obj.get("width", 512)), int(obj.get("depth", 4)))
        table = obj.get("table", [])
        if len(table) == out.depth and all(
            len(row) == out.width for row in table
        ):
            out.table = [[int(c) for c in row] for row in table]
        out.total = int(obj.get("total", 0))
        return out


class SpaceSaving:
    """Top-K heavy hitters (Metwally et al. space-saving).

    Each monitored key carries ``(count, err)`` with the classic bounds
    ``count >= true`` and ``count - err <= true``; while the number of
    distinct keys seen is at most ``capacity`` the counts are exact
    (``err == 0``).  Merge follows the mergeable-summaries construction:
    a key absent from one sketch contributes that sketch's minimum count
    as both count and error, then the union is trimmed back to capacity.
    """

    __slots__ = ("capacity", "counts", "errs")

    def __init__(self, capacity: int = 32):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.counts: dict[int, int] = {}
        self.errs: dict[int, int] = {}

    def add(self, key: int, n: int = 1) -> None:
        key = int(key)
        counts = self.counts
        got = counts.get(key)
        if got is not None:
            counts[key] = got + n
        elif len(counts) < self.capacity:
            counts[key] = n
            self.errs[key] = 0
        else:  # evict the minimum; the newcomer inherits its count as error
            victim = min(counts, key=counts.get)
            floor = counts.pop(victim)
            self.errs.pop(victim, None)
            counts[key] = floor + n
            self.errs[key] = floor

    def top(self, k: int | None = None) -> list[tuple[int, int, int]]:
        """``(key, count, err)`` rows, largest count first."""
        rows = sorted(
            ((key, c, self.errs.get(key, 0)) for key, c in self.counts.items()),
            key=lambda row: row[1],
            reverse=True,
        )
        return rows if k is None else rows[: max(int(k), 0)]

    def _floor(self) -> int:
        """Lower bound a key absent from this sketch may still hold."""
        if len(self.counts) < self.capacity:
            return 0
        return min(self.counts.values())

    def merge(self, other: "SpaceSaving") -> "SpaceSaving":
        if other.capacity != self.capacity:
            raise HeatShapeError(
                f"space-saving capacity mismatch: {self.capacity} vs "
                f"{other.capacity}"
            )
        f1, f2 = self._floor(), other._floor()
        merged_counts: dict[int, int] = {}
        merged_errs: dict[int, int] = {}
        for key in set(self.counts) | set(other.counts):
            c1 = self.counts.get(key)
            c2 = other.counts.get(key)
            merged_counts[key] = (c1 if c1 is not None else f1) + (
                c2 if c2 is not None else f2
            )
            merged_errs[key] = (
                (self.errs.get(key, 0) if c1 is not None else f1)
                + (other.errs.get(key, 0) if c2 is not None else f2)
            )
        kept = sorted(
            merged_counts.items(), key=lambda kv: kv[1], reverse=True
        )[: self.capacity]
        self.counts = dict(kept)
        self.errs = {key: merged_errs[key] for key, _ in kept}
        return self

    def copy(self) -> "SpaceSaving":
        out = SpaceSaving(self.capacity)
        out.counts = dict(self.counts)
        out.errs = dict(self.errs)
        return out

    def to_dict(self) -> dict:
        return {
            "capacity": self.capacity,
            "rows": [[key, c, self.errs.get(key, 0)]
                     for key, c in self.counts.items()],
        }

    @classmethod
    def from_dict(cls, obj: dict) -> "SpaceSaving":
        out = cls(int(obj.get("capacity", 32)))
        for key, c, err in obj.get("rows", []):
            out.counts[int(key)] = int(c)
            out.errs[int(key)] = int(err)
        return out


class HeatSketch:
    """Per-worker workload heat: keyword sketches + doc-range histogram.

    ``record(kw_ids, ids)`` is the hot-path entry: O(#keywords) sketch
    updates plus an O(buckets)-bounded range increment, no allocation,
    behind one lock (one uncontended acquire per query — the same cost
    class as the latency histogram's).  ``merge`` expects the other sketch
    to be a private snapshot (``copy()``/``from_dict``), so only ``self``
    is locked.
    """

    DOC_BUCKETS = 64

    def __init__(
        self,
        num_nodes: int = 0,
        *,
        doc_buckets: int = DOC_BUCKETS,
        cms_width: int = 512,
        cms_depth: int = 4,
        top_capacity: int = 32,
    ):
        self.num_nodes = int(num_nodes)
        self.doc_buckets = int(doc_buckets)
        self.doc_counts = [0] * self.doc_buckets
        self.cms = CountMinSketch(cms_width, cms_depth)
        self.topk = SpaceSaving(top_capacity)
        self.queries = 0
        self._lock = threading.Lock()

    # ------------------------------------------------------------------ #
    def record(self, kw_ids, ids=None) -> None:
        """One query's heat: resolved keyword ids + its (sorted) result ids."""
        if not ENABLED:
            return
        with self._lock:
            self.queries += 1
            cms_add, top_add = self.cms.add, self.topk.add
            for k in kw_ids:
                if k >= 0:
                    cms_add(k)
                    top_add(k)
            if ids is not None and len(ids):
                self._record_range(int(ids[0]), int(ids[-1]))

    def _record_range(self, lo: int, hi: int) -> None:
        span = max(self.num_nodes, hi + 1, 1)
        b0 = min(lo * self.doc_buckets // span, self.doc_buckets - 1)
        b1 = min(hi * self.doc_buckets // span, self.doc_buckets - 1)
        counts = self.doc_counts
        for b in range(max(b0, 0), b1 + 1):
            counts[b] += 1

    # ------------------------------------------------------------------ #
    def estimate(self, kw_id: int) -> int:
        with self._lock:
            return self.cms.estimate(kw_id)

    def top_keywords(self, k: int = 10) -> list[tuple[int, int, int]]:
        with self._lock:
            return self.topk.top(k)

    def merge(self, other: "HeatSketch") -> "HeatSketch":
        if other.doc_buckets != self.doc_buckets:
            raise HeatShapeError(
                f"doc-range granularity mismatch: {self.doc_buckets} vs "
                f"{other.doc_buckets}"
            )
        with self._lock:
            self.cms.merge(other.cms)
            self.topk.merge(other.topk)
            for i, c in enumerate(other.doc_counts):
                if c:
                    self.doc_counts[i] += c
            # cross-shard rollups cover different id spaces: buckets merge
            # positionally (relative position heat), span takes the max
            self.num_nodes = max(self.num_nodes, other.num_nodes)
            self.queries += other.queries
        return self

    def copy(self) -> "HeatSketch":
        with self._lock:
            out = HeatSketch(
                self.num_nodes,
                doc_buckets=self.doc_buckets,
                cms_width=self.cms.width,
                cms_depth=self.cms.depth,
                top_capacity=self.topk.capacity,
            )
            out.doc_counts = list(self.doc_counts)
            out.cms = self.cms.copy()
            out.topk = self.topk.copy()
            out.queries = self.queries
        return out

    def to_dict(self) -> dict:
        """JSON-safe wire form (the stats reply header's ``"heat"`` field)."""
        with self._lock:
            return {
                "v": 1,
                "queries": self.queries,
                "num_nodes": self.num_nodes,
                "cms": self.cms.to_dict(),
                "topk": self.topk.to_dict(),
                "doc": {
                    "buckets": list(self.doc_counts),
                    "granularity": self.doc_buckets,
                },
            }

    @classmethod
    def from_dict(cls, obj: dict) -> "HeatSketch":
        doc = obj.get("doc", {})
        cms = CountMinSketch.from_dict(obj.get("cms", {}))
        topk = SpaceSaving.from_dict(obj.get("topk", {}))
        out = cls(
            int(obj.get("num_nodes", 0)),
            doc_buckets=int(doc.get("granularity", cls.DOC_BUCKETS)),
            cms_width=cms.width,
            cms_depth=cms.depth,
            top_capacity=topk.capacity,
        )
        out.cms = cms
        out.topk = topk
        buckets = [int(c) for c in doc.get("buckets", [])]
        if len(buckets) == out.doc_buckets:
            out.doc_counts = buckets
        out.queries = int(obj.get("queries", 0))
        return out
