"""QueryService — asynchronous admission + microbatched execution.

The paper's batched DAG search (`dag_search_vec_multi`) amortizes device
dispatch across a batch, but as a one-shot call: every caller must assemble
its own batch.  This service is the admission path in front of it:

  * ``submit()`` enqueues a query and returns a Future immediately;
  * a drain thread collects everything that arrives inside one *batch
    window* (bounded by ``max_batch``), groups it by semantics, and executes
    each group through the engine's batched search — all queries of a window
    share frontier-round launches, and the engine-owned PlanCache groups
    them by (k, bucket-shape);
  * per-query latency, launch counts, and plan-cache hit rates surface
    through :class:`repro_torch.core.engine.QueryStats`.

Thread model: one daemon drain thread per service.  The engine itself is
only touched from the drain thread, so no engine-level locking is needed.

``backend`` picks how a window is drained: "torch" (default) runs the
batched vectorized DAG search through the engine's PlanCache, "chained"
runs the same search with the searchsorted kernel as its membership step,
"fused" sends each drained window through the hand-written CUDA kernel (one
launch per frontier round), "scalar" runs the paper-faithful host algorithms
query-by-query.  Device work is launched from the drain thread, on that
thread's current CUDA stream.

    with QueryService(engine, batch_window_ms=2.0, device="cuda") as svc:
        futs = [svc.submit(q) for q in queries]
        results = [f.result() for f in futs]
        print(svc.stats().summary())
"""
from __future__ import annotations

import os
import threading
import time
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.api import (
    Query,
    QueryResult,
    chain_future,
    resolve_device,
    validate_backend,
    validate_semantics,
)
from repro_torch.core.engine import KeywordSearchEngine, QueryStats
from repro_torch.core.search_base import dag_search
from repro_torch.core.search_dag import dag_search_vec_multi
from repro_torch.obs import TRACER, SlowQueryLog, emit_phases, parse_traceparent

# worker-side slow-query threshold (ms): drained queries at or above it
# land in the service's bounded SlowQueryLog, shipped home in the stats
# wire header so GET /debug/slow covers process/remote shards too
DEFAULT_SLOW_LOG_MS = float(os.environ.get("XKS_SLOW_LOG_MS", "25.0"))

# drain backends: how one admission window reaches the index.  "torch" and
# "chained" run the batched vectorized search through the engine's PlanCache
# (the backend name is part of each plan key; "chained" swaps the membership
# step for the searchsorted kernel inside the same search), "fused" hands
# each packed window to the CUDA kernel (one launch from membership to ELCA —
# the whole drained batch goes down intact), "scalar" runs the paper-faithful host algorithms per
# query (no batching, no device).
_BACKENDS = {
    "scalar": None, "torch": "torch", "chained": "chained", "fused": "fused",
}


@dataclass
class _Pending:
    kws: list[int]  # resolved keyword ids
    semantics: str
    future: Future
    t_submit: float = field(default_factory=time.perf_counter)
    trace: object = None  # TraceContext | traceparent str | None
    words: object = None  # the caller's raw keywords (slow-log context)


class QueryService:
    """Microbatching front-end over one KeywordSearchEngine."""

    def __init__(
        self,
        engine: KeywordSearchEngine,
        max_batch: int = 64,
        batch_window_ms: float = 2.0,
        backend: str = "torch",
        slow_log_ms: float | None = None,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        if engine.device != self.device:
            raise ValueError(
                f"engine runs on {engine.device}, service asked for {self.device}"
            )
        if engine.cluster is None:
            raise ValueError("QueryService needs an engine with the DAG index")
        validate_backend(backend)
        if backend not in _BACKENDS:  # None: a service needs a concrete drain
            raise ValueError(
                f"backend must be one of {sorted(_BACKENDS)}, got {backend!r}"
            )
        if backend == "chained":
            # importing the kernel ops registers the "chained" membership
            # backend with search_vec; without it the first drain would fail
            from repro_torch.kernels import ops  # noqa: F401
        self.engine = engine
        self.backend = backend
        self.max_batch = int(max_batch)
        self.batch_window_s = float(batch_window_ms) / 1e3
        self._pending: list[_Pending] = []
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._closed = False
        self._stats = QueryStats(
            data={"queries": 0, "batches": 0, "launches": 0, "max_batch_seen": 0}
        )
        # queries drained at or above this latency are logged for the
        # cluster-wide GET /debug/slow (entries ride the stats header)
        self._slow_ms = (
            DEFAULT_SLOW_LOG_MS if slow_log_ms is None else float(slow_log_ms)
        )
        self._slow = SlowQueryLog(64)
        self._thread = threading.Thread(
            target=self._drain_loop, name="query-service-drain", daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------------ #
    # Admission
    # ------------------------------------------------------------------ #
    def submit(
        self,
        keywords: list[str] | str | Query,
        semantics: str = "slca",
        trace=None,
    ) -> Future:
        """Enqueue one query; the Future resolves when its window drains.

        Pass a :class:`repro_torch.api.Query` for a ``Future[QueryResult]``; the
        legacy ``(keywords, semantics)`` form is deprecated and resolves to
        the bare sorted original node ids.  ``trace`` (a traceparent string
        or :class:`~repro_torch.obs.TraceContext`) parents the per-query
        queued/execute/phase spans the drain emits.
        """
        if isinstance(keywords, Query):
            return self._submit_query(keywords)
        validate_semantics(semantics)
        fut: Future = Future()
        item = _Pending(
            self.engine.keyword_ids(keywords), semantics, fut,
            trace=trace if TRACER.enabled else None,
            words=keywords,
        )
        with self._wake:
            # the closed check lives under the same lock close() takes, so a
            # submit racing close() either lands in the final drain window or
            # raises here — it can never enqueue onto a stopped drain thread
            # and hang its caller.  A dead drain thread (crashed, or the
            # interpreter is tearing down daemon threads) is the same story.
            if self._closed:
                raise RuntimeError("submit() on a closed QueryService")
            if not self._thread.is_alive():
                raise RuntimeError(
                    "QueryService drain thread is not running (closed or died)"
                )
            self._pending.append(item)
            self._wake.notify()
        return fut

    def _submit_query(self, q: Query) -> Future:
        """Unified-API admission: ``Future[QueryResult]``."""
        q.validate()
        if q.index != "dag":
            raise ValueError(
                f"index must be dag for QueryService, got {q.index!r}"
            )
        if q.backend is not None and _BACKENDS[q.backend] != _BACKENDS[self.backend]:
            raise ValueError(
                f"backend mismatch: this service drains {self.backend!r}, "
                f"the query asked for {q.backend!r}"
            )
        t0 = time.perf_counter()

        def finish(ids: np.ndarray) -> QueryResult:
            lat = round((time.perf_counter() - t0) * 1e3, 3)
            return QueryResult(ids=ids, stats={"latency_ms": lat}, generations=())

        return chain_future(
            self.submit(list(q.keywords), q.semantics, trace=q.traceparent),
            finish,
        )

    def query(
        self, keywords: list[str] | str | Query, semantics: str = "slca"
    ) -> np.ndarray | QueryResult:
        """Synchronous convenience: submit + wait (QueryResult for a Query)."""
        return self.submit(keywords, semantics).result()

    def map(
        self, queries: list[list[str] | str], semantics: str = "slca"
    ) -> list[np.ndarray]:
        """Submit many queries, wait for all (order preserved)."""
        futs = [self.submit(q, semantics) for q in queries]
        return [f.result() for f in futs]

    # ------------------------------------------------------------------ #
    # Stats / lifecycle
    # ------------------------------------------------------------------ #
    def stats(self) -> QueryStats:
        """Snapshot of service counters + queue depth + the engine plan cache.

        ``queue_depth`` (currently admitted-but-undrained queries) and the
        plan-cache hit/miss/launch counters all land in ``data`` so
        ``summary()`` — and any cluster-level rollup via
        :meth:`QueryStats.merge` — sees them as plain numeric counters.
        """
        with self._lock:
            snap = QueryStats(
                data=dict(self._stats.data),
                latencies_ms=list(self._stats.latencies_ms),
                hist=self._stats.hist.copy(),
            )
            snap.data["queue_depth"] = len(self._pending)
        snap.data.update(self.engine.plan_cache.snapshot())
        # workload heat + worker-side slow entries ride the same snapshot
        # (and, for RPC transports, the same stats reply header as `hist`)
        snap.heat = self.engine.heat.copy()
        snap.slow = self._slow.worst(QueryStats.MAX_SLOW)
        return snap

    @property
    def queue_depth(self) -> int:
        """Queries admitted but not yet drained (cheap, lock-held read)."""
        with self._lock:
            return len(self._pending)

    def close(self, timeout: float = 30.0) -> None:
        """Drain outstanding queries, then stop the worker thread."""
        with self._wake:
            self._closed = True
            self._wake.notify()
        self._thread.join(timeout)

    def __enter__(self) -> QueryService:
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------ #
    # Drain loop
    # ------------------------------------------------------------------ #
    def _take_window(self) -> list[_Pending] | None:
        """Block for work; return one admission window (None = shut down)."""
        with self._wake:
            while not self._pending and not self._closed:
                self._wake.wait()
            if not self._pending:
                return None  # closed and drained
            # admission window: let a burst accumulate so batching has
            # material; submit() notifies, so a filled batch exits early
            deadline = time.perf_counter() + self.batch_window_s
            while len(self._pending) < self.max_batch and not self._closed:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                self._wake.wait(timeout=remaining)
            window, self._pending = (
                self._pending[: self.max_batch],
                self._pending[self.max_batch :],
            )
        return window

    def _drain_loop(self) -> None:
        while True:
            window = self._take_window()
            if window is None:
                return
            by_sem: dict[str, list[_Pending]] = {}
            for item in window:
                by_sem.setdefault(item.semantics, []).append(item)
            launches0 = self.engine.plan_cache.launches
            for semantics, items in by_sem.items():
                self._run_group(semantics, items)
            done = time.perf_counter()
            slow: list[_Pending] = []
            with self._lock:
                d = self._stats.data
                d["queries"] += len(window)
                d["batches"] += 1
                d["launches"] += self.engine.plan_cache.launches - launches0
                d["max_batch_seen"] = max(d["max_batch_seen"], len(window))
                for item in window:
                    lat = (done - item.t_submit) * 1e3
                    self._stats.record_latency(lat)
                    if lat >= self._slow_ms:
                        slow.append(item)
            for item in slow:  # rare: only queries over the threshold
                self._log_slow(item, (done - item.t_submit) * 1e3, len(window))

    def _log_slow(self, item: _Pending, lat_ms: float, batch: int) -> None:
        """One slow-query entry (ships home in the stats wire header)."""
        words = item.words
        if isinstance(words, str):
            words = words.split()
        ctx = parse_traceparent(item.trace) if item.trace is not None else None
        self._slow.add(
            {
                "latency_ms": round(lat_ms, 3),
                "keywords": list(words) if words is not None else None,
                "kw_ids": [int(k) for k in item.kws],
                "semantics": item.semantics,
                "backend": self.backend,
                "batch": int(batch),
                "ts_ms": round(time.time() * 1e3, 3),
                "trace_id": ctx.trace_id if ctx is not None else None,
            }
        )

    @staticmethod
    def _deliver(fut: Future, result=None, exc: Exception | None = None) -> None:
        # a caller may cancel concurrently; losing the race must not kill
        # the drain thread (InvalidStateError on a cancelled future)
        try:
            fut.set_exception(exc) if exc is not None else fut.set_result(result)
        except InvalidStateError:
            pass

    def _run_group(self, semantics: str, items: list[_Pending]) -> None:
        traced = (
            [it for it in items if it.trace is not None]
            if TRACER.enabled
            else []
        )
        phases: list | None = [] if traced else None
        t_run = time.perf_counter()
        try:
            if self.backend == "scalar":
                results = [
                    dag_search(
                        self.engine.cluster, it.kws, algorithm=f"fwd_{semantics}"
                    )
                    if all(k >= 0 for k in it.kws)
                    else np.zeros(0, dtype=np.int64)
                    for it in items
                ]
            else:
                results = dag_search_vec_multi(
                    self.engine.cluster,
                    [it.kws for it in items],
                    semantics=semantics,
                    backend=_BACKENDS[self.backend],
                    plan=self.engine.plan_cache,
                    phases=phases,
                )
        except Exception as e:  # surface the failure on every waiter
            for it in items:
                self._deliver(it.future, exc=e)
            return
        if traced:
            # spans are recorded BEFORE futures resolve, so a caller that
            # collects the trace right after .result() sees the full tree
            self._emit_spans(semantics, items, traced, phases, t_run)
        heat = self.engine.heat
        for it, res in zip(items, results):
            heat.record(it.kws, res)
            self._deliver(it.future, result=res)

    def _emit_spans(
        self,
        semantics: str,
        items: list[_Pending],
        traced: list[_Pending],
        phases: list | None,
        t_run: float,
    ) -> None:
        """Execute (+ engine phase) spans for each traced item.

        Wall-clock anchors are reconstructed from the perf-counter stamps
        (``wall_now - perf_elapsed``), so span timestamps line up with the
        phase timings captured inside the drain.  Queueing shows up as a
        ``queued_ms`` attribute rather than its own span — one span per
        item per batch keeps the traced hot path inside the overhead
        budget compare.py gates.
        """
        now_perf = time.perf_counter()
        now_wall = time.time() * 1e3
        t0_ms = now_wall - (now_perf - t_run) * 1e3
        dur_ms = (now_perf - t_run) * 1e3
        for it in traced:
            ectx = TRACER.emit(
                it.trace, "service.execute", t0_ms, dur_ms,
                batch=len(items), semantics=semantics, backend=self.backend,
                queued_ms=round((t_run - it.t_submit) * 1e3, 3),
            )
            if phases and ectx is not None:
                emit_phases(ectx, phases)
