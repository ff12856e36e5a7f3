"""Public keyword-search API: build both indices once, query many times.

    engine = KeywordSearchEngine.from_xml(xml_string)      # or from_tree(...)
    engine.query(["USA", "English"], semantics="slca")     # -> node ids

``index``    "tree" (Zhou et al. baseline) or "dag" (the paper's IDCluster)
``backend``  "scalar" (paper-faithful host algorithms), "torch" (vectorized
             PyTorch), "fused" (one hand-written CUDA kernel from
             membership to ELCA per batched round), or "chained" (one
             hand-written CUDA kernel per phase, one query or RC per call)
``algorithm`` scalar backend only: fwd/bwd × slca/elca variant selection.
``device``   where the vectorized backends run: "cuda" unless the caller
             names the CPU; a CUDA device on a host without CUDA raises.

An engine owns one :class:`~repro_torch.core.plan_cache.PlanCache` on its
device: every vectorized DAG launch goes through it, so its shape counters
cover queries, batches, and service calls.  ``save``/``load`` round-trip
the full index state through the artifact format in
:mod:`repro_torch.core.io` (build once, memory-map from N serving processes).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.api import (
    Query,
    QueryResult,
    resolve_device,
    validate_backend,
    validate_index,
    validate_semantics,
)
from repro_torch.kernels import fused_search
from repro_torch.obs import (
    TRACER,
    BucketMismatchError,
    HeatSketch,
    LatencyHistogram,
    emit_phases,
)

from . import io as index_io
from . import search_base, search_vec
from .components import IDClusterIndex, build_indices
from .idlist import BaseIndex
from .plan_cache import PlanCache
from .search_dag import dag_search_vec
from .xml_tree import XMLTree, parse


@dataclass
class QueryStats:
    """Diagnostics for the last query / batch / service window.

    ``data`` carries per-call counters (rounds, launches, plan-cache hits).
    The latency store is ``hist``, a fixed-bucket
    :class:`~repro_torch.obs.metrics.LatencyHistogram`: O(#buckets) memory
    however long the service lives, O(1) record, and percentiles that
    weigh every sample since startup — the old ``np.percentile`` over a
    half-trimmed sample list re-ranked up to 10k floats per ``to_dict()``
    call and silently biased toward recent samples.  ``latencies_ms``
    remains as a bounded recent-sample window (legacy callers index it;
    :meth:`merge` still concatenates it), but no percentile math reads it
    once the histogram has samples.
    """

    MAX_LATENCIES = 10_000
    MAX_SLOW = 32

    data: dict = field(default_factory=dict)
    latencies_ms: list = field(default_factory=list)
    hist: LatencyHistogram = field(default_factory=LatencyHistogram)
    # workload heat (keyword sketches + doc-range histogram) and the
    # worker-side slow-query entries; both ride the stats wire header like
    # ``hist`` and merge across workers in :meth:`merge`
    heat: HeatSketch | None = None
    slow: list = field(default_factory=list)

    def __post_init__(self):
        # legacy construction (old wire peers, tests) passes samples only:
        # fold them so the histogram is authoritative from the start
        if self.hist.count == 0 and self.latencies_ms:
            for ms in self.latencies_ms:
                self.hist.observe(float(ms))

    def record_latency(self, ms: float) -> None:
        self.hist.observe(float(ms))
        if len(self.latencies_ms) >= self.MAX_LATENCIES:
            # amortized trim: drop the older half in one slice
            del self.latencies_ms[: self.MAX_LATENCIES // 2]
        self.latencies_ms.append(float(ms))

    def percentile(self, p: float) -> float:
        if self.hist.count:
            return self.hist.percentile(p)
        if not self.latencies_ms:  # hist empty, window assigned post-init
            return 0.0
        return float(np.percentile(np.asarray(self.latencies_ms), p))

    @property
    def queries_timed(self) -> int:
        return self.hist.count if self.hist.count else len(self.latencies_ms)

    def to_dict(self) -> dict:
        """The one stats schema: counters + (when timed) latency percentiles.

        Engine, service, cluster rollups, and the HTTP gateway all emit this
        shape — same field names at every layer, so a dashboard reading the
        gateway's ``/stats`` JSON can read a worker's local stats unchanged.
        """
        out = dict(self.data)
        timed = self.queries_timed
        if timed:
            out["queries_timed"] = timed
            out["p50_ms"] = round(self.percentile(50), 3)
            out["p99_ms"] = round(self.percentile(99), 3)
        return out

    def summary(self) -> dict:
        """Deprecated alias of :meth:`to_dict` (kept for old callers)."""
        return self.to_dict()

    @classmethod
    def merge(cls, parts: list[QueryStats]) -> QueryStats:
        """Aggregate stats across workers (cluster-level rollup).

        Numeric counters sum key-wise; derived ``*_rate`` gauges are ratios
        (summing them is nonsense) so they are recomputed from the merged
        counters where possible — ``plan_hit_rate`` from hits/launches —
        and dropped otherwise.  Non-numeric values keep the first
        occurrence.  Latency histograms merge bucket-wise (exact, unlike
        concatenating bounded sample lists); the legacy sample windows
        still concatenate for callers that read them directly.  A peer
        whose histogram has diverged bucket edges (typed
        :class:`~repro_torch.obs.BucketMismatchError`) is counted under
        ``hist_edge_mismatches`` and its raw sample window is folded
        instead — a version skew never silently corrupts the rollup.
        Heat sketches merge sketch-wise; slow-query entries concatenate,
        trimmed to the worst :data:`MAX_SLOW`.
        """
        merged = cls()
        for part in parts:
            for key, val in part.data.items():
                if key.endswith("_rate"):
                    continue
                if isinstance(val, bool) or not isinstance(val, (int, float)):
                    merged.data.setdefault(key, val)
                else:
                    merged.data[key] = merged.data.get(key, 0) + val
            if part.hist.count:
                try:
                    merged.hist.merge(part.hist)
                except BucketMismatchError:
                    merged.data["hist_edge_mismatches"] = (
                        merged.data.get("hist_edge_mismatches", 0) + 1
                    )
                    if part.latencies_ms:
                        merged.hist.merge(
                            LatencyHistogram.from_samples(part.latencies_ms)
                        )
            elif part.latencies_ms:  # window assigned after construction
                merged.hist.merge(LatencyHistogram.from_samples(part.latencies_ms))
            merged.latencies_ms.extend(part.latencies_ms)
            part_heat = getattr(part, "heat", None)
            if part_heat is not None:
                if merged.heat is None:
                    merged.heat = part_heat.copy()
                else:
                    merged.heat.merge(part_heat)
            part_slow = getattr(part, "slow", None)
            if part_slow:
                merged.slow.extend(part_slow)
        launches = merged.data.get("plan_launches_total", 0)
        if launches:
            merged.data["plan_hit_rate"] = round(
                merged.data.get("plan_hits", 0) / launches, 4
            )
        del merged.latencies_ms[: -cls.MAX_LATENCIES]
        if merged.slow:
            merged.slow.sort(
                key=lambda r: r.get("latency_ms", 0.0), reverse=True
            )
            del merged.slow[cls.MAX_SLOW:]
        return merged


class KeywordSearchEngine:
    def __init__(
        self,
        tree: XMLTree,
        build_dag: bool = True,
        plan_cache: PlanCache | None = None,
        *,
        base: BaseIndex | None = None,
        cluster: IDClusterIndex | None = None,
        device: str | torch.device = "cuda",
    ):
        # resolve first: a missing CUDA device fails before any index build
        self.device = resolve_device(device)
        if plan_cache is not None and plan_cache.device != self.device:
            raise ValueError(
                f"plan_cache runs on {plan_cache.device}, engine on {self.device}"
            )
        self.tree = tree
        if base is not None:  # artifact reload: indices arrive prebuilt
            self.base, self.cluster = base, cluster
        elif build_dag:
            self.base, self.cluster = build_indices(tree)
        else:
            self.base, self.cluster = BaseIndex(tree), None
        self.plan_cache = plan_cache or PlanCache(device=self.device)
        self.last_stats = QueryStats()
        # workload heat over this engine's keyword/node-id space; recorded
        # on every query path (direct and through QueryService) behind the
        # always-on ``repro_torch.obs.heat.ENABLED`` switch
        self.heat = HeatSketch(num_nodes=tree.num_nodes)

    # ------------------------------------------------------------------ #
    @classmethod
    def from_xml(cls, source: str, **kw) -> KeywordSearchEngine:
        return cls(parse(source), **kw)

    @classmethod
    def from_tree(cls, tree: XMLTree, **kw) -> KeywordSearchEngine:
        return cls(tree, **kw)

    # ------------------------------------------------------------------ #
    # Index artifacts (see core/io.py for the format)
    # ------------------------------------------------------------------ #
    def save(self, path: str) -> None:
        """Write the full index state to an artifact directory."""
        dag = self.cluster.dag if self.cluster is not None else None
        rcs = self.cluster.rcs if self.cluster is not None else None
        index_io.save_parts(path, self.tree, self.base.containment, dag, rcs)

    @classmethod
    def load(
        cls,
        path: str,
        mmap: bool = True,
        plan_cache: PlanCache | None = None,
        device: str | torch.device = "cuda",
    ) -> KeywordSearchEngine:
        """Reload a saved artifact without re-running any index build."""
        device = resolve_device(device)
        tree, containment, dag, rcs, _ = index_io.load_parts(path, mmap=mmap)
        base = BaseIndex(tree, containment)
        cluster = (
            IDClusterIndex(tree, containment, dag=dag, rcs=rcs)
            if dag is not None
            else None
        )
        return cls(
            tree, plan_cache=plan_cache, base=base, cluster=cluster, device=device
        )

    # ------------------------------------------------------------------ #
    def keyword_ids(self, keywords: list[str] | str) -> list[int]:
        if isinstance(keywords, str):
            keywords = keywords.split()
        return [self.tree.vocab.get(w) for w in keywords]

    def query(
        self,
        keywords: list[str] | str | Query,
        semantics: str = "slca",
        index: str = "dag",
        backend: str = "scalar",
        algorithm: str | None = None,
    ) -> np.ndarray | QueryResult:
        """Run one keyword query.

        Pass a :class:`repro_torch.api.Query` to get a
        :class:`repro_torch.api.QueryResult` (ids + stats dict); the positional
        string/kwargs form is the deprecated legacy surface and returns the
        bare sorted original node ids.
        """
        if isinstance(keywords, Query):
            q = keywords.validate()
            span = TRACER.start(
                q.traceparent, "engine.query",
                semantics=q.semantics, index=q.index,
                backend=q.backend or "scalar",
            )
            phases = [] if span.ctx is not None else None
            t0 = time.perf_counter()
            ids = self._query(
                list(q.keywords), q.semantics, q.index, q.backend or "scalar",
                algorithm, phases=phases,
            )
            stats = self.last_stats.to_dict()
            stats["latency_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
            if phases:
                emit_phases(span.ctx, phases)
            span.end()
            return QueryResult(ids=ids, stats=stats, generations=())
        return self._query(keywords, semantics, index, backend, algorithm)

    def _query(
        self,
        keywords: list[str] | str,
        semantics: str,
        index: str,
        backend: str,
        algorithm: str | None,
        phases: list | None = None,
    ) -> np.ndarray:
        # validate *before* the unknown-keyword early return — a bogus
        # semantics/index/backend is a caller bug and must raise even when
        # the keywords miss the vocab (and regardless of the algorithm
        # override on the scalar paths)
        validate_semantics(semantics)
        validate_index(index)
        validate_backend(backend)
        self.last_stats = QueryStats()
        kws = self.keyword_ids(keywords)
        if any(k < 0 for k in kws) or not kws:
            return np.zeros(0, dtype=np.int64)
        ids = self._execute(kws, semantics, index, backend, algorithm, phases)
        self.heat.record(kws, ids)
        return ids

    def _execute(
        self,
        kws: list[int],
        semantics: str,
        index: str,
        backend: str,
        algorithm: str | None,
        phases: list | None,
    ) -> np.ndarray:
        if index == "tree":
            if backend == "scalar":
                algo = algorithm or f"fwd_{semantics}"
                fn = search_base.BASE_ALGORITHMS[algo]
                return fn(self.base.idlists(kws)).astype(np.int64)
            if backend == "fused":
                return fused_search.run_query_fused(
                    self.base.idlists(kws), semantics=semantics, device=self.device
                )
            if backend == "chained":
                from repro_torch.kernels import ops  # lazy: avoid cycle

                return ops.run_query_chained(
                    self.base.idlists(kws), semantics=semantics, device=self.device
                )
            return search_vec.run_query(
                self.base.idlists(kws), semantics=semantics, backend="torch",
                device=self.device,
            )

        if index == "dag":
            if self.cluster is None:
                raise ValueError("engine was built without the DAG index")
            if backend == "scalar":
                algo = algorithm or f"fwd_{semantics}"
                return search_base.dag_search(
                    self.cluster, kws, algorithm=algo,
                    collect_stats=self.last_stats.data,
                )
            return dag_search_vec(
                self.cluster,
                kws,
                semantics=semantics,
                backend=backend,
                stats=self.last_stats.data,
                plan=self.plan_cache,
                phases=phases,
            )
        raise ValueError(f"index must be tree|dag, got {index!r}")

    def query_batch(
        self,
        queries: list[list[str] | str],
        semantics: str = "slca",
    ) -> list[np.ndarray]:
        """Serve many queries with cross-query batched DAG search (one device
        launch per frontier round across the whole batch)."""
        from .search_dag import dag_search_vec_multi

        validate_semantics(semantics)
        if self.cluster is None:
            raise ValueError("engine was built without the DAG index")
        kws = [self.keyword_ids(q) for q in queries]
        self.last_stats = QueryStats()
        return dag_search_vec_multi(
            self.cluster,
            kws,
            semantics=semantics,
            stats=self.last_stats.data,
            plan=self.plan_cache,
        )

    # ------------------------------------------------------------------ #
    def index_sizes(self) -> dict:
        """Entry counts for the paper's §IV-F index-size comparison."""
        out = {"tree_entries": self.base.num_entries()}
        if self.cluster is not None:
            out["dag_entries"] = self.cluster.num_entries()
            out["rcpm_entries"] = self.cluster.rcpm_size()
            out["num_rcs"] = self.cluster.num_rcs
            out["dag_nodes"] = self.cluster.dag.num_canonical
            out["tree_nodes"] = self.tree.num_nodes
        return out
