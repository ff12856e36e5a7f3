"""ClusterService: scatter-gather keyword search over sharded DAG indices.

One router fronts N shard workers behind the transport-agnostic worker
seam (:mod:`repro_torch.cluster.workers`): every worker speaks
``submit/doc_stats/stats/drain/close``, whether it is a thread in this
process (ThreadWorker), a subprocess over the shard's mmap'd artifact
(ProcessWorker, supervised by a ProcessPool), or a socket to a standalone
shard server on another host (RemoteWorker, reconnected with backoff by a
RemotePool; shards with no endpoint configured stay local — the pool
prefers a process worker over a network hop).  The router itself owns no
engines and no drain threads — it is routing, admission, gather, and merge
logic.  Every shard engine searches on the ``device`` the service was
built for (``"cuda"`` unless the caller names the CPU), through its own
``QueryService`` drain and the port's kernels on ``backends="fused"`` or
``"chained"``.  A query's life:

  1. keywords resolve against the cluster routing table; the fanout is the
     AND of the per-keyword shard bitmaps — only shards whose documents
     contain *every* keyword can produce a match, everyone else is skipped;
  2. identical in-flight queries coalesce (single-flight request
     coalescing): a burst of one hot query costs one execution, Zipfian
     traffic being the serving norm;
  3. admission control takes one slot on every fanout shard or sheds the
     query with a typed :class:`Overloaded` (all-or-nothing, so a saturated
     shard only sheds traffic actually routed at it);
  4. the query is submitted to every fanout worker; the last shard future
     to complete hands the gather to the merge executor, which merges and
     fans the result out to every coalesced caller.  A worker that dies
     mid-query fails the gather with the typed
     :class:`~repro_torch.cluster.workers.WorkerDied` — callers never hang.

The gather captures its worker references at submit time, so
:meth:`ClusterService.reload_shard` can hot-swap a shard's worker to a
newly published artifact (rolling republish) without dropping in-flight
queries: swapped-out workers are *retired* and closed only when their last
in-flight gather finishes.

Exactness (ELCA/SLCA semantics are preserved, machine-checked in
tests/test_cluster.py): documents never span shards, and each shard tree is
the corpus tree restricted to the root + that shard's documents, so every
node below the corpus root lives in exactly one shard and its SLCA/ELCA
status depends only on within-document structure — per-shard results, mapped
back through the contiguous id offset, are exactly the monolith's non-root
results.  Only the corpus root needs cross-shard reasoning:

  * root is an SLCA  iff  every keyword occurs somewhere in the corpus and
    no deeper common ancestor exists — i.e. the merged non-root result set
    is empty;
  * root is an ELCA  iff  every keyword also occurs *outside* the subtrees
    of the root's descendant common ancestors.  Those descendant-CA subtrees
    are exactly the documents containing all keywords ("full" documents,
    CA-ness being ancestor-closed within a document), so the residual check
    per keyword k reduces to:  k is a root keyword, or k occurs in a shard
    outside the fanout (such shards cannot contain full documents), or the
    fanout shards together have more documents containing k than full
    documents.  Workers report the two document counts per query.
"""
from __future__ import annotations

import logging
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import Future, InvalidStateError, ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.api import Query, QueryResult, chain_future, validate_semantics
from repro_torch.core.engine import QueryStats
from repro_torch.core.xml_tree import XMLTree
from repro_torch.obs import NULL_SPAN, TRACER

from .admission import AdmissionController, Overloaded
from .manifest import (
    RoutingTable,
    build_cluster,
    load_cluster,
    load_cluster_layout,
    manifest_endpoints,
)
from .partition import partition_corpus
from .workers import (
    ProcessPool,
    ProtocolError,
    RemotePool,
    ThreadPool,
    Worker,
    WorkerPool,
)
from .workers.base import DEFAULT_OP_TIMEOUT, WorkerDied

log = logging.getLogger(__name__)

# End-to-end deadline for one routed query (scatter, execute, gather,
# merge) — deliberately wider than the per-RPC DEFAULT_OP_TIMEOUT, since a
# query spans several round-trips plus a possible first-launch compile.
DEFAULT_QUERY_TIMEOUT = 2 * DEFAULT_OP_TIMEOUT

_EMPTY = np.zeros(0, dtype=np.int64)


class _Gather:
    """Mutable scatter-gather state for one admitted (coalesced) query.

    ``workers`` pins the shard->Worker mapping as of submit time: merge and
    the ELCA residual check always talk to the workers the query actually
    ran on, even if a reload swapped the live pool underneath it.
    """

    __slots__ = (
        "key", "futures", "kw_ids", "semantics", "shards", "workers",
        "routing", "fanout_mask", "all_present", "t0s", "remaining",
        "results", "error", "lock", "spans", "shard_spans", "admission",
    )

    def __init__(self, key, future, kw_ids, semantics, shards, workers,
                 routing, fanout_mask, all_present, t0, span=NULL_SPAN,
                 admission=None):
        self.key = key
        # the admission controller whose slots this gather holds: a layout
        # swap (apply_layout) replaces the live controller, and releasing
        # old slots into the new one would corrupt its depth accounting
        self.admission = admission
        self.futures = [future]
        # spans[i] belongs to futures[i]'s caller: [0] is the execution
        # owner's router.submit span, the rest are coalesced joiners (each
        # in its *own* trace — coalescing crosses trace boundaries)
        self.spans = [span]
        self.shard_spans: dict[int, object] = {}
        self.kw_ids = kw_ids
        self.semantics = semantics
        self.shards = shards
        self.workers = workers  # dict[int, Worker], pinned at submit
        self.routing = routing  # table the kw_ids/fanout were resolved on
        self.fanout_mask = fanout_mask
        self.all_present = all_present
        self.t0s = [t0]
        self.remaining = len(shards)
        self.results: dict[int, np.ndarray] = {}
        self.error: BaseException | None = None
        self.lock = threading.Lock()


class ClusterService:
    """Sharded serving front door: route, scatter, gather, merge."""

    def __init__(
        self,
        pool: WorkerPool,
        routing: RoutingTable,
        *,
        max_queue_per_shard: int = 256,
        op_timeout: float | None = DEFAULT_QUERY_TIMEOUT,
        generations: list[int] | None = None,
        layout_epoch: int = 0,
    ):
        # _routing_seq is bumped by every routing-table swap (rolling
        # republish or layout transaction) and is part of the coalescing
        # key: keyword ids resolved on different tables never coalesce
        self._routing_seq = 0
        self._routing = routing
        self.pool = pool
        # layout epoch: seeded from the manifest, bumped by apply_layout —
        # the edge cache's repartition-coherence signal (generations cover
        # content changes, the epoch covers boundary changes)
        self.layout_epoch = int(layout_epoch)
        self._converging = False
        # per-shard serving generation: seeded from the manifest (from_dir)
        # or zeros, bumped by reload_shard — the cache-coherence signal the
        # gateway's edge cache keys invalidation on
        self.generations = (
            list(generations)
            if generations is not None
            else [0] * len(pool.workers)
        )
        # per-op deadline for the blocking waits this service performs on
        # behalf of callers (query/map results, the ELCA doc_stats gather):
        # a shard that stops answering mid-gather fails typed
        # (TimeoutError / WorkerDied) after this long instead of hanging
        # the caller forever.  None disables the deadline.
        self.op_timeout = op_timeout
        self.admission = AdmissionController(
            len(pool.workers), max_queue_per_shard
        )
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._closed = False
        self._close_done = False
        self._owned_dir: str | None = None  # tempdir for from_tree(process)
        self._owned_servers: list[subprocess.Popen] = []  # from_tree(remote)
        self._inflight: dict[tuple, _Gather] = {}
        self._active = 0  # admitted gathers not yet finalized
        self._refs: dict[Worker, int] = {}  # in-flight gathers per worker
        self._retired: set[Worker] = set()  # swapped out, close when idle
        # merge + ELCA residual run here, never on a worker's callback
        # thread: a ProcessWorker's reader thread must stay free to deliver
        # the doc_stats responses the merge is waiting on
        self._merge_exec = ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="cluster-merge"
        )
        self._stats = QueryStats(
            data={
                "queries": 0,
                "fanout_submits": 0,
                "root_results": 0,
                "coalesced": 0,
                "reloads": 0,
                "repartitions": 0,
                "moves": 0,
                "health_probe_errors": 0,
            }
        )
        # load_report() qps windows: shard -> (monotonic, queries counter)
        # from the previous report, so qps is a delta over a real window
        # rather than a lifetime average
        self._load_prev: dict[int, tuple[float, int]] = {}
        self._t_created = time.monotonic()

    @property
    def routing(self) -> RoutingTable:
        return self._routing

    @routing.setter
    def routing(self, table: RoutingTable) -> None:
        # single assignment under the GIL; the seq bump invalidates the
        # coalescing keys of everything resolved on the old table
        self._routing = table
        self._routing_seq += 1

    # ------------------------------------------------------------------ #
    # Construction
    # ------------------------------------------------------------------ #
    @classmethod
    def from_dir(
        cls,
        path: str,
        transport: str = "thread",
        mmap: bool = True,
        *,
        backends: str | list[str] = "torch",
        max_batch: int = 64,
        batch_window_ms: float = 2.0,
        max_queue_per_shard: int = 256,
        op_timeout: float | None = DEFAULT_QUERY_TIMEOUT,
        endpoints: list[str | None] | dict[int, str] | None = None,
        device: str | torch.device = "cuda",
        **pool_kw,
    ) -> ClusterService:
        """Serve a published cluster artifact.

        ``transport="thread"`` loads every shard engine in-process (arrays
        stay mmapped); ``transport="process"`` spawns one subprocess per
        shard over its artifact dir — same page-cache pages, real
        parallelism, crash isolation; ``transport="remote"`` connects to
        standalone shard servers (:mod:`repro_torch.cluster.workers.server`) —
        shards on other hosts, same protocol framing.  Remote endpoints
        come from ``endpoints`` (a per-shard list, None entries = local, or
        a ``{shard: "host:port"}`` dict) or, when omitted, from the
        manifest's per-shard ``endpoint`` fields; any shard with no
        endpoint configured is preferred *local* and served by a process
        worker over its artifact dir.  ``device`` is where every local shard
        engine searches (in this process or in its subprocess); a remote
        shard searches wherever its server was started.
        """
        if transport == "thread":
            shards, routing, manifest = load_cluster(path, mmap=mmap, device=device)
            pool: WorkerPool = ThreadPool(
                shards,
                backends=backends,
                max_batch=max_batch,
                batch_window_ms=batch_window_ms,
                device=device,
                **pool_kw,
            )
        elif transport == "process":
            manifest, routing, entries = load_cluster_layout(path, mmap=mmap)
            pool = ProcessPool(
                entries,
                backends=backends,
                max_batch=max_batch,
                batch_window_ms=batch_window_ms,
                device=device,
                **pool_kw,
            )
        elif transport == "remote":
            manifest, routing, entries = load_cluster_layout(path, mmap=mmap)
            if endpoints is None:
                eps = manifest_endpoints(manifest)
            elif isinstance(endpoints, dict):
                eps = [endpoints.get(i) for i in range(len(entries))]
            else:
                eps = list(endpoints)
            pool = RemotePool(
                entries,
                endpoints=eps,
                backends=backends,
                max_batch=max_batch,
                batch_window_ms=batch_window_ms,
                device=device,
                **pool_kw,
            )
        else:
            raise ValueError(
                f"transport must be thread|process|remote, got {transport!r}"
            )
        return cls(
            pool,
            routing,
            max_queue_per_shard=max_queue_per_shard,
            op_timeout=op_timeout,
            generations=[
                int(s.get("generation", 0)) for s in manifest["shards"]
            ],
            layout_epoch=int(manifest.get("layout_epoch", 0)),
        )

    @classmethod
    def from_tree(
        cls,
        tree: XMLTree,
        num_shards: int,
        transport: str = "thread",
        **kw,
    ) -> ClusterService:
        """Partition + index + serve (tests and benchmarks).

        The process transport needs on-disk artifacts, so it publishes the
        cluster into a service-owned temp directory first (reclaimed at
        close); the thread transport stays fully in memory.  The remote
        transport additionally launches one standalone shard server per
        shard on localhost (ephemeral ports, owned by the service and
        terminated at close) — real sockets, the full remote path, no
        external deployment needed.  ``device`` (in ``kw``, ``"cuda"`` unless
        given) is where every shard engine is built and searches, the
        remote transport's servers included.
        """
        device = kw.get("device", "cuda")
        if transport == "process":
            workdir = tempfile.mkdtemp(prefix="cluster-proc-")
            try:
                build_cluster(tree, num_shards, workdir, device=device)
                svc = cls.from_dir(workdir, transport="process", **kw)
            except BaseException:
                shutil.rmtree(workdir, ignore_errors=True)
                raise
            svc._owned_dir = workdir
            return svc
        if transport == "remote":
            from .workers.server import launch_cluster_servers

            replicas = max(int(kw.pop("replicas", 1)), 1)
            workdir = tempfile.mkdtemp(prefix="cluster-remote-")
            procs: list[subprocess.Popen] = []
            try:
                manifest = build_cluster(tree, num_shards, workdir, device=device)
                # one full server set per replica rank, all over the same
                # published artifacts; shard i's endpoints are column i
                rounds = []
                for _ in range(replicas):
                    procs_r, eps_r = launch_cluster_servers(
                        workdir,
                        manifest,
                        backends=kw.get("backends", "torch"),
                        max_batch=kw.get("max_batch", 64),
                        batch_window_ms=kw.get("batch_window_ms", 2.0),
                        device=str(device),
                    )
                    procs.extend(procs_r)
                    rounds.append(eps_r)
                eps = (
                    rounds[0]
                    if replicas == 1
                    else [list(col) for col in zip(*rounds)]
                )
                svc = cls.from_dir(
                    workdir, transport="remote", endpoints=eps, **kw
                )
            except BaseException:
                for p in procs:
                    p.kill()
                shutil.rmtree(workdir, ignore_errors=True)
                raise
            svc._owned_dir = workdir
            svc._owned_servers = procs
            return svc
        max_queue = kw.pop("max_queue_per_shard", 256)
        op_timeout = kw.pop("op_timeout", DEFAULT_QUERY_TIMEOUT)
        shards, masks, root_kw_ids = partition_corpus(tree, num_shards, device)
        routing = RoutingTable(
            vocab=tree.vocab, masks=masks, root_kw_ids=root_kw_ids
        )
        return cls(
            ThreadPool(shards, **kw),
            routing,
            max_queue_per_shard=max_queue,
            op_timeout=op_timeout,
        )

    @property
    def num_shards(self) -> int:
        return len(self.pool.workers)

    @property
    def workers(self) -> list[Worker]:
        return self.pool.workers

    def generation_vector(self) -> tuple[int, ...]:
        """Per-shard serving generations (the edge cache's coherence stamp)."""
        with self._lock:
            return tuple(self.generations)

    def touched(self, keywords: list[str] | str) -> tuple[int, ...]:
        """Shards whose generation can affect this query's result.

        The fanout shards for a resolvable query; conservatively *every*
        shard for unknown keywords or an empty fanout — those results are
        statements about the whole routing table (root-only answers), so
        any republish must invalidate them.
        """
        routing = self.routing
        kw_ids = routing.kw_ids(keywords)
        if not kw_ids or any(k < 0 for k in kw_ids):
            return tuple(range(self.num_shards))
        mask = routing.fanout(kw_ids)
        shards = tuple(s for s in range(self.num_shards) if mask >> s & 1)
        return shards if shards else tuple(range(self.num_shards))

    # ------------------------------------------------------------------ #
    # Admission + scatter
    # ------------------------------------------------------------------ #
    def submit(
        self,
        keywords: list[str] | str,
        semantics: str = "slca",
        trace=None,
    ) -> Future:
        """Route one query; the Future resolves to sorted corpus node ids.

        Raises :class:`Overloaded` *synchronously* when admission sheds the
        query — the caller gets backpressure, not a doomed future.

        Identical in-flight queries are *coalesced* (single-flight): callers
        asking for a (keywords, semantics) pair that is already being
        scatter-gathered attach to the running execution instead of spawning
        a duplicate — hot queries cost one execution per burst, they are
        never shed, and take no extra admission slots.  Exactness is free:
        the index is immutable while served, so equal queries have equal
        results.

        Pass a :class:`repro_torch.api.Query` for a ``Future[QueryResult]`` (ids
        + per-request stats + the serving generation vector); the legacy
        ``(keywords, semantics)`` form is deprecated and resolves to the
        bare ndarray.  ``trace`` (a traceparent string or
        :class:`~repro_torch.obs.TraceContext`) parents the router/shard/merge
        spans; a coalesced joiner gets a single span in its *own* trace,
        annotated with the owning execution's trace id.
        """
        if isinstance(keywords, Query):
            return self._submit_query(keywords)
        validate_semantics(semantics)
        if isinstance(keywords, str):
            keywords = keywords.split()
        fut: Future = Future()
        t0 = time.perf_counter()
        span = TRACER.start(trace, "router.submit", semantics=semantics)
        # One routing snapshot per query: a rolling republish or a layout
        # transaction may swap self.routing mid-flight, and ids resolved on
        # one table must never be interpreted against another.  The resolve
        # runs outside the lock; if a swap landed in between (the seq check
        # below), it retries on the new table.  Routing table, admission
        # controller, and workers are pinned from the *same* layout inside
        # one locked section — that consistency is what makes a live
        # repartition invisible to concurrent queries.
        state = None
        while True:
            routing = self.routing
            seq = self._routing_seq
            kw_ids = routing.kw_ids(keywords)
            # seq is part of the coalescing key: queries resolved on
            # different routing tables (same words, possibly different ids)
            # never share an execution
            key = (seq, tuple(kw_ids), semantics)
            unknown = not kw_ids or any(k < 0 for k in kw_ids)
            with self._lock:
                if self._closed:
                    raise RuntimeError("submit() on a closed ClusterService")
                if seq != self._routing_seq:
                    continue  # a routing/layout swap landed mid-resolve
                self._stats.data["queries"] += 1
                running = self._inflight.get(key)
                if running is not None:  # join the in-flight execution
                    running.futures.append(fut)
                    running.t0s.append(t0)
                    span.annotate(coalesced=True)
                    if running.spans[0].trace_id is not None:
                        span.annotate(host_trace=running.spans[0].trace_id)
                    running.spans.append(span)
                    self._stats.data["coalesced"] += 1
                    return fut
                if unknown:
                    break  # delivered outside the lock
                fanout_mask = routing.fanout(kw_ids)
                n = len(self.pool.workers)
                shards = [s for s in range(n) if fanout_mask >> s & 1]
                all_present = all(
                    routing.doc_presence(k) != 0 or routing.at_root(k)
                    for k in kw_ids
                )
                if not shards:
                    if all_present:
                        self._stats.data["root_results"] += 1
                    break  # root-only: delivered outside the lock
                admission = self.admission
                try:
                    # raises Overloaded on a full shard; all-or-nothing
                    admission.acquire(shards)
                except Overloaded:
                    span.end(error="Overloaded")
                    raise
                # pin the workers this execution runs on; reloads and layout
                # swaps replace the pool but never the gather
                workers = {s: self.pool.workers[s] for s in shards}
                state = _Gather(key, fut, kw_ids, semantics, shards, workers,
                                routing, fanout_mask, all_present, t0, span,
                                admission=admission)
                self._inflight[key] = state
                self._active += 1
                for w in workers.values():
                    self._refs[w] = self._refs.get(w, 0) + 1
                self._stats.data["fanout_submits"] += len(shards)
                break
        if state is None:
            if unknown:
                # unknown keyword: no document (and not the root) can match
                span.end(outcome="unknown_keyword", results=0)
                self._finish([fut], _EMPTY, [t0])
                return fut
            # no shard holds every keyword => no full document anywhere =>
            # the corpus root is the only candidate (both semantics; see
            # module docstring)
            res = np.zeros(1, dtype=np.int64) if all_present else _EMPTY
            span.end(outcome="root_only", results=int(res.size))
            self._finish([fut], res, [t0])
            return fut
        span.annotate(fanout=len(shards))
        for s in shards:
            ssp = TRACER.start(span.ctx, "shard.gather", shard=s)
            state.shard_spans[s] = ssp
            try:
                ctx = ssp.ctx
                shard_fut = (
                    workers[s].submit(keywords, semantics, trace=ctx)
                    if ctx is not None
                    else workers[s].submit(keywords, semantics)
                )
            except Exception as e:  # worker closed/dead: fail this shard
                self._on_shard_done(state, s, None, e)
                continue
            shard_fut.add_done_callback(
                lambda f, s=s: self._on_shard_done(
                    state, s, f, f.exception()
                )
            )
        return fut

    def _submit_query(self, q: Query) -> Future:
        """Unified-API admission: ``Future[QueryResult]``."""
        q.validate()
        if q.index != "dag":
            raise ValueError(
                f"index must be dag for ClusterService, got {q.index!r}"
            )
        if q.backend is not None:
            want = q.backend
            have = set(getattr(self.pool, "_backends", [want]))
            if have != {want}:
                raise ValueError(
                    f"backend mismatch: this cluster drains {sorted(have)}, "
                    f"the query asked for {q.backend!r}"
                )
        # captured before submit: a reload that lands mid-flight makes the
        # reported vector *older* than what served the query, which is the
        # safe direction for cache stamping (over-invalidation, never stale)
        gens = self.generation_vector()
        t0 = time.perf_counter()

        def finish(ids: np.ndarray) -> QueryResult:
            lat = round((time.perf_counter() - t0) * 1e3, 3)
            return QueryResult(
                ids=ids, stats={"latency_ms": lat}, generations=gens
            )

        return chain_future(
            self.submit(list(q.keywords), q.semantics, trace=q.traceparent),
            finish,
        )

    def query(
        self,
        keywords: list[str] | str | Query,
        semantics: str = "slca",
        timeout: float | None = None,
    ) -> np.ndarray | QueryResult:
        """Blocking submit; waits at most ``timeout`` (default: the
        service's ``op_timeout``) and raises ``TimeoutError`` typed rather
        than hanging on a shard that stopped answering.  A
        :class:`repro_torch.api.Query` yields a ``QueryResult``."""
        return self.submit(keywords, semantics).result(
            self.op_timeout if timeout is None else timeout
        )

    def map(
        self,
        queries: list[list[str] | str],
        semantics: str = "slca",
        timeout: float | None = None,
    ) -> list[np.ndarray]:
        deadline = self.op_timeout if timeout is None else timeout
        futs = [self.submit(q, semantics) for q in queries]
        return [f.result(deadline) for f in futs]

    # ------------------------------------------------------------------ #
    # Gather + merge
    # ------------------------------------------------------------------ #
    def _on_shard_done(self, state: _Gather, shard: int, fut, exc) -> None:
        ssp = state.shard_spans.get(shard)
        if ssp is not None:  # ended (recorded) before the gather can finish
            if exc is not None:
                ssp.end(error=f"{type(exc).__name__}: {exc}")
            else:
                ssp.end()
        with state.lock:
            if exc is not None:
                state.error = state.error or exc
            else:
                state.results[shard] = fut.result()
            state.remaining -= 1
            last = state.remaining == 0
        if last:
            # hand off to the merge executor: this callback may be running
            # on a worker's response-reader thread, which must not block on
            # the doc_stats round-trips the ELCA merge performs
            try:
                self._merge_exec.submit(self._finalize, state)
            except RuntimeError:
                # executor already shut down (a gather outlived close()'s
                # wait, e.g. a wedged worker killed during pool teardown):
                # finalize inline — a stranded gather would hang its callers
                # forever, and at this point every worker is dead or drained
                # so the merge cannot block the reader thread indefinitely
                self._finalize(state)

    def _finalize(self, state: _Gather) -> None:
        # release into the controller the slots were taken from: a layout
        # transaction may have swapped self.admission since this gather
        # was admitted
        (state.admission or self.admission).release(state.shards)
        # un-publish BEFORE delivering: submits holding the service lock
        # either joined (their future is in state.futures now) or will start
        # a fresh execution after this pop
        with self._lock:
            self._inflight.pop(state.key, None)
        merged = None
        if state.error is None:
            msp = TRACER.start(state.spans[0].ctx, "router.merge")
            try:
                merged = self._merge(state, trace=msp.ctx)
            except BaseException as e:
                # a worker exception during merge/doc_stats must fail the
                # gather, never strand it unfinalized (callers would hang)
                state.error = e
                msp.end(error=f"{type(e).__name__}: {e}")
            else:
                msp.end(results=int(merged.size))
        # every caller's span ends (and records) before its future resolves
        if state.error is not None:
            err = f"{type(state.error).__name__}: {state.error}"
            for sp in state.spans:
                sp.end(error=err)
            for fut in state.futures:
                try:
                    fut.set_exception(state.error)
                except InvalidStateError:
                    pass
        else:
            for sp in state.spans:
                sp.end(results=int(merged.size))
            self._finish(state.futures, merged, state.t0s)
        self._release_workers(state)

    def _release_workers(self, state: _Gather) -> None:
        to_close = []
        with self._lock:
            for w in state.workers.values():
                n = self._refs.get(w, 0) - 1
                if n > 0:
                    self._refs[w] = n
                else:
                    self._refs.pop(w, None)
                    if w in self._retired:
                        self._retired.discard(w)
                        to_close.append(w)
            self._active -= 1
            self._idle.notify_all()
        for w in to_close:  # last rider gone: reclaim the swapped-out worker
            threading.Thread(target=w.close, daemon=True).start()

    def _merge(self, state: _Gather, trace=None) -> np.ndarray:
        parts = []
        for s in state.shards:
            res = state.results[s]
            # local id 0 is the shard's root replica: its status is a
            # statement about this shard only, recomputed globally below
            res = res[res != 0]
            parts.append(res + state.workers[s].spec.id_offset)
        merged = np.sort(np.concatenate(parts)) if parts else _EMPTY
        if state.semantics == "slca":
            root = merged.size == 0 and state.all_present
        else:
            root = state.all_present and self._root_is_elca(state, trace)
        if root:
            merged = np.concatenate([np.zeros(1, dtype=np.int64), merged])
            with self._lock:
                self._stats.data["root_results"] += 1
        return merged

    def _root_is_elca(self, state: _Gather, trace=None) -> bool:
        """Residual check: every keyword occurs outside all full documents."""
        stat_futs = [
            (
                s,
                state.workers[s].doc_stats(state.kw_ids, trace=trace)
                if trace is not None
                else state.workers[s].doc_stats(state.kw_ids),
            )
            for s in state.shards
        ]
        docs_k = np.zeros(len(state.kw_ids), dtype=np.int64)
        full = 0
        for _s, f in stat_futs:
            # bounded: a worker that stops answering mid-gather fails this
            # gather typed (the _finalize try/except delivers it to every
            # caller) instead of wedging a merge-executor thread forever
            dk, fl = f.result(timeout=self.op_timeout)
            docs_k += dk
            full += fl
        for j, k in enumerate(state.kw_ids):
            if state.routing.at_root(k):
                continue  # the root's own keyword is always residual
            if state.routing.doc_presence(k) & ~state.fanout_mask:
                continue  # occurs in a shard with no full documents
            if docs_k[j] > full:
                continue  # fanout shards have non-full documents with k
            return False
        return True

    def _finish(
        self, futs: list[Future], result: np.ndarray, t0s: list[float]
    ) -> None:
        done = time.perf_counter()
        with self._lock:
            for t0 in t0s:
                self._stats.record_latency((done - t0) * 1e3)
        for fut in futs:
            try:
                fut.set_result(result)
            except InvalidStateError:
                pass  # caller cancelled; nothing to deliver

    # ------------------------------------------------------------------ #
    # Rolling republish
    # ------------------------------------------------------------------ #
    def reload_shard(self, i: int, path: str) -> None:
        """Hot-swap shard ``i`` onto the artifact at ``path``.

        In-flight queries finish on the worker they were submitted to (it
        is retired and closed only once its last gather completes); every
        query submitted after the swap runs on the new artifact.  The shard
        must cover the same document range — this is the republish path
        (same partition, new generation), not a repartition.
        """
        if not 0 <= i < self.num_shards:
            raise IndexError(f"shard {i} out of range")
        with self._lock:
            if self._closed:
                raise RuntimeError("reload_shard() on a closed ClusterService")
        new = self.pool.spawn(i, path)
        with self._lock:
            if self._closed:  # raced close(): discard the fresh worker
                closing, old = new, None
            else:
                old = self.pool.install(i, new)
                self._stats.data["reloads"] += 1
                self.generations[i] += 1  # coherence signal for edge caches
                if self._refs.get(old, 0) > 0:
                    self._retired.add(old)  # closed by its last gather
                    closing = None
                else:
                    closing = old
        if closing is not None:
            threading.Thread(target=closing.close, daemon=True).start()

    # ------------------------------------------------------------------ #
    # Layout transactions (repartition / shard move)
    # ------------------------------------------------------------------ #
    def apply_layout(self, path: str, manifest: dict | None = None) -> None:
        """Converge this live service onto the layout committed at ``path``.

        The generalization of :meth:`reload_shard` from one shard to the
        whole cluster: a *layout transaction*.  A full worker set for the
        new layout (possibly a different shard count at different
        boundaries) is built first, while the old layout keeps serving;
        then, in one locked swap, the service replaces its worker pool,
        routing table, generations vector, admission controller (resized to
        the new shard count, cumulative counters carried over), and
        ``layout_epoch``.  Queries submitted before the swap finish on the
        workers, routing snapshot, and admission slots they were pinned to
        at submit time — old workers are retired and closed only after
        their last gather, so a live repartition drops nothing.
        """
        with self._lock:
            if self._closed:
                raise RuntimeError("apply_layout() on a closed ClusterService")
            self._converging = True
        try:
            loaded, routing, entries = load_cluster_layout(path)
            manifest = loaded if manifest is None else manifest
            # the expensive half runs outside the lock: spawn/load the new
            # worker set while the old layout keeps serving traffic
            new_pool = self.pool.rebuild(entries, manifest)
            to_close: list[Worker] = []
            with self._lock:
                if self._closed:  # raced close(): discard the fresh pool
                    discarded = new_pool
                else:
                    discarded = None
                    old_workers = self.pool.detach()
                    self.pool = new_pool
                    self.routing = routing  # property setter bumps the seq
                    self.generations = [
                        int(s.get("generation", 0))
                        for s in manifest["shards"]
                    ]
                    self.layout_epoch = int(
                        manifest.get("layout_epoch", self.layout_epoch + 1)
                    )
                    self.admission = self.admission.resized(len(entries))
                    self._load_prev.clear()  # qps windows are per-layout
                    self._stats.data["repartitions"] += 1
                    for w in old_workers:
                        if self._refs.get(w, 0) > 0:
                            self._retired.add(w)  # closed by its last gather
                        else:
                            to_close.append(w)
            if discarded is not None:
                discarded.close(5.0)
                raise RuntimeError("apply_layout() on a closed ClusterService")
            for w in to_close:
                threading.Thread(target=w.close, daemon=True).start()
        finally:
            with self._lock:
                self._converging = False

    def move_shard(self, i: int, endpoint: str | list[str] | None) -> None:
        """Converge shard ``i`` onto a new endpoint (the live half of a
        shard move — :func:`repro_torch.cluster.rebalance.move_shard` launches
        the server and flips the manifest).

        Dials the new endpoint, installs the connection, and retires the
        source worker: in-flight queries drain on the old worker (closed
        after its last gather), everything after runs against the new host.
        Requires the remote transport — only a :class:`RemotePool` can
        re-point a shard at another host.
        """
        if not 0 <= i < self.num_shards:
            raise IndexError(f"shard {i} out of range")
        redirect = getattr(self.pool, "redirect", None)
        if redirect is None:
            raise ValueError(
                "moving a shard between hosts needs the remote transport "
                f"(this service runs {self.pool.transport!r} workers)"
            )
        with self._lock:
            if self._closed:
                raise RuntimeError("move_shard() on a closed ClusterService")
        new = redirect(i, endpoint)
        with self._lock:
            if self._closed:  # raced close(): discard the fresh worker
                closing, old = new, None
            else:
                old = self.pool.install(i, new)
                self._stats.data["moves"] += 1
                if self._refs.get(old, 0) > 0:
                    self._retired.add(old)  # closed by its last gather
                    closing = None
                else:
                    closing = old
        if closing is not None:
            threading.Thread(target=closing.close, daemon=True).start()

    def layout(self) -> dict:
        """The serving layout as declarative facts (planner/debug input)."""
        with self._lock:
            workers = list(self.pool.workers)
            epoch = self.layout_epoch
            converging = self._converging
        specs = [w.spec for w in workers]
        bounds = [s.doc_lo for s in specs] + (
            [specs[-1].doc_hi] if specs else []
        )
        return {
            "layout_epoch": epoch,
            "converging": converging,
            "num_shards": len(specs),
            "doc_bounds": bounds,
        }

    # ------------------------------------------------------------------ #
    # Stats / lifecycle
    # ------------------------------------------------------------------ #
    def shard_health(self) -> list[dict]:
        """Per-shard replica liveness: the gateway's readiness probe input.

        Workers that expose ``health()`` (ReplicaSets, RPC workers) report
        ``(configured, live)`` replica counts; anything else falls back to
        its ``_dead`` post-mortem (alive unless marked dead).
        """
        with self._lock:
            workers = list(self.pool.workers)
        rows = []
        for i, w in enumerate(workers):
            health = getattr(w, "health", None)
            try:
                if health is not None:
                    configured, live = health()
                else:
                    configured = 1
                    live = 0 if getattr(w, "_dead", None) is not None else 1
            except (WorkerDied, ProtocolError, TimeoutError, OSError):
                configured, live = 1, 0  # typed: the worker is unanswerable
            except Exception:
                # an unexpected probe failure is a bug in the probe, not
                # evidence of a dead shard: log + count it instead of
                # silently flipping the shard to "down" (which would 503
                # the gateway's readiness for no real reason)
                log.warning(
                    "shard %d health probe failed unexpectedly",
                    i,
                    exc_info=True,
                )
                with self._lock:
                    self._stats.data["health_probe_errors"] += 1
                configured, live = 1, 1
            rows.append(
                {
                    "shard": i,
                    "transport": getattr(w, "transport", "?"),
                    "replicas": int(configured),
                    "replicas_live": int(live),
                }
            )
        return rows

    def stats(self) -> QueryStats:
        """Cluster rollup: router counters + admission + shard aggregates."""
        with self._lock:
            snap = QueryStats(
                data=dict(self._stats.data),
                latencies_ms=list(self._stats.latencies_ms),
                hist=self._stats.hist.copy(),
            )
            workers = list(self.pool.workers)
        snap.data["transport"] = self.pool.transport
        snap.data["worker_locality"] = self.pool.locality
        snap.data["worker_respawns"] = getattr(self.pool, "respawns", 0)
        snap.data["generations"] = list(self.generation_vector())
        snap.data["layout_epoch"] = self.layout_epoch
        snap.data["num_shards"] = len(workers)
        snap.data.update(self.admission.snapshot())
        # QueryStats.merge sums the shard counters and recomputes the plan
        # hit rate from the merged hits/launches.  Collection fans out so a
        # slow worker costs the max round-trip, not the sum (each process
        # worker's stats is a blocking RPC).
        with ThreadPoolExecutor(max_workers=max(len(workers), 1)) as ex:
            agg = QueryStats.merge(list(ex.map(lambda w: w.stats(), workers)))
        snap.data.update(
            {
                "shard_launches": agg.data.get("launches", 0),
                "shard_batches": agg.data.get("batches", 0),
                "queue_depth": agg.data.get("queue_depth", 0),
                "plan_launches_total": agg.data.get("plan_launches_total", 0),
                "plan_hits": agg.data.get("plan_hits", 0),
                "plan_misses": agg.data.get("plan_misses", 0),
                "plans": agg.data.get("plans", 0),
                "rows_padded": agg.data.get("rows_padded", 0),
                "plan_hit_rate": agg.data.get("plan_hit_rate", 0.0),
                "fused_fallbacks": agg.data.get("fused_fallbacks", 0),
            }
        )
        # replica-tier health (present only when shards are ReplicaSets)
        for key in ("replicas", "replicas_live", "hedges_fired", "hedge_wins",
                    "failovers", "replica_deaths", "replica_respawns"):
            if key in agg.data:
                snap.data[key] = agg.data[key]
        # cluster-wide workload heat + worker slow-query entries, merged
        # shard-wise exactly like the latency histogram
        snap.heat = agg.heat
        snap.slow = agg.slow
        return snap

    def load_report(self, top_k: int = 10) -> dict:
        """Versioned per-shard skew report for the balancer / ``/debug/heat``.

        Entirely derived from worker-side :class:`~repro_torch.obs.HeatSketch`
        and ``QueryStats`` counters, so it works identically over thread,
        process, and remote transports (heat rides the stats wire header).
        QPS is a delta against the previous ``load_report`` call's counter
        snapshot; the first call uses the service's lifetime as the window.
        Each row also carries the shard's own kernel launches when its worker
        runs in a process of its own (the gateway's only per-shard view of
        them, ``GET /debug/heat``).
        """
        with self._lock:
            workers = list(self.pool.workers)
        with ThreadPoolExecutor(max_workers=max(len(workers), 1)) as ex:
            snaps = list(ex.map(lambda w: w.stats(), workers))
        now = time.monotonic()
        admission = self.admission.snapshot()
        queue = admission.get("queue_depth_per_shard", ())
        shed = admission.get("shed_per_shard", ())
        health = self.shard_health()
        vocab = getattr(self.routing, "vocab", None)
        shards = []
        for i, snap in enumerate(snaps):
            queries = int(snap.data.get("queries", 0))
            t_prev, q_prev = self._load_prev.get(
                i, (self._t_created, 0)
            )
            window_s = max(now - t_prev, 1e-9)
            self._load_prev[i] = (now, queries)
            heat = snap.heat
            top = []
            if heat is not None:
                for kw_id, count, err in heat.topk.top(top_k):
                    word = None
                    if vocab is not None:
                        try:
                            word = vocab.id_to_word[kw_id]
                        except (IndexError, TypeError):
                            word = None
                    top.append(
                        {
                            "kw_id": int(kw_id),
                            "keyword": word,
                            "count": int(count),
                            "err": int(err),
                        }
                    )
            row = {
                "shard": i,
                "transport": health[i]["transport"] if i < len(health) else "?",
                "queries": queries,
                "qps": round(max(queries - q_prev, 0) / window_s, 3),
                "window_s": round(window_s, 3),
                "queue_depth": int(queue[i]) if i < len(queue) else 0,
                "shed": int(shed[i]) if i < len(shed) else 0,
                "generation": (
                    self.generations[i] if i < len(self.generations) else 0
                ),
                "replicas": health[i]["replicas"] if i < len(health) else 1,
                "replicas_live": (
                    health[i]["replicas_live"] if i < len(health) else 1
                ),
                "p50_ms": round(snap.percentile(50), 3),
                "p99_ms": round(snap.percentile(99), 3),
                "top_keywords": top,
                "doc_heat": (
                    list(heat.doc_counts) if heat is not None else []
                ),
                "heat_queries": (
                    int(heat.queries) if heat is not None else 0
                ),
                # a shard process's own launches of each kernel (its
                # ``kernel_launches_<kernel>`` stats); a thread worker shares
                # this process's counters and reports none
                "kernel_launches": {
                    key[len("kernel_launches_"):]: int(val)
                    for key, val in snap.data.items()
                    if key.startswith("kernel_launches_")
                },
            }
            shards.append(row)
        qps = [row["qps"] for row in shards]
        hottest = int(max(range(len(qps)), key=qps.__getitem__)) if qps else -1
        mean_qps = (sum(qps) / len(qps)) if qps else 0.0
        return {
            "version": 1,
            "kind": "xks-load-report",
            "ts_ms": round(time.time() * 1e3, 3),
            "num_shards": len(shards),
            "layout": self.layout(),
            "hottest_shard": hottest,
            # max/mean qps: 1.0 = perfectly balanced, grows with skew
            "skew": round(max(qps) / mean_qps, 3) if mean_qps > 0 else 1.0,
            "admitted": int(admission.get("admitted", 0)),
            "shed_total": int(admission.get("shed", 0)),
            "shards": shards,
        }

    def close(self, timeout: float = 30.0) -> None:
        """Stop admitting, drain every worker, finish gathers, shut down.

        Idempotent: a second close returns immediately.  Queries admitted
        before close complete (their workers are drained, their merges run);
        new submits raise.
        """
        with self._lock:
            if self._close_done:
                return
            self._closed = True
        workers = list(self.pool.workers)
        # drains fan out (each is a flush round-trip): close latency is the
        # slowest worker's, not the sum over shards
        with ThreadPoolExecutor(max_workers=max(len(workers), 1)) as ex:
            list(ex.map(lambda w: w.drain(timeout), workers))
        deadline = time.monotonic() + timeout
        with self._idle:
            while self._active > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._idle.wait(remaining)
            retired = list(self._retired)
            self._retired.clear()
        self._merge_exec.shutdown(wait=True)
        for w in retired:
            w.close(timeout)
        self.pool.close(timeout)
        for p in self._owned_servers:  # from_tree(remote)'s local servers
            p.terminate()
        for p in self._owned_servers:
            try:
                p.wait(5.0)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(5.0)
        if self._owned_dir is not None:
            shutil.rmtree(self._owned_dir, ignore_errors=True)
        with self._lock:
            self._close_done = True

    def __enter__(self) -> ClusterService:
        return self

    def __exit__(self, *exc) -> None:
        self.close()
