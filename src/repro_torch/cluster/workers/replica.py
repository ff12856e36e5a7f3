"""ReplicaSet: N interchangeable workers serving one shard.

One shard, N replicas, one Worker-protocol facade.  The router keeps
fanning out over ``pool.workers`` and never learns that a "worker" is
actually a set; everything tail-latency- and availability-related lives
here:

  * **Hedged dispatch** — every ``submit``/``doc_stats`` goes to one
    replica immediately; if no answer arrives within the hedge delay (an
    adaptive latency percentile over recent wins, or a fixed
    ``hedge_ms``), the same request is fired at the next replica and the
    first result wins.  The loser's Future is cancelled — its worker-side
    result is dropped on delivery, so a stalled or GC-pausing replica
    bounds p99 instead of setting it.
  * **Failover** — a replica that fails an attempt (typed
    :class:`~repro_torch.cluster.workers.base.WorkerDied`, a protocol error, a
    dead connection) is skipped and the attempt moves to the next live
    replica.  The caller sees ``WorkerDied`` only when *every* replica of
    the shard is gone — a single kill mid-query is invisible.
  * **Replica resurrection** — each dead replica is rebuilt through the
    pool-provided ``factory`` with exponential backoff, bounded by a
    per-slot respawn budget (same discipline as
    :class:`~repro_torch.cluster.workers.pool.SupervisedPool`).

Selection is round-robin over live replicas, so read load spreads across
the set between hedges.
"""
from __future__ import annotations

import math
import threading
import time
from collections import deque
from concurrent.futures import CancelledError, Future, InvalidStateError

import numpy as np

from repro_torch.core.engine import QueryStats
from repro_torch.obs import TRACER

from ..partition import ShardSpec
from .base import Worker, WorkerDied

# hedge after this long while the latency buffer is still cold
DEFAULT_COLD_HEDGE_MS = 50.0
HEDGE_PERCENTILE = 95.0
HEDGE_FLOOR_MS = 2.0
_MIN_SAMPLES = 20  # below this, stick with the cold default
_LATENCY_WINDOW = 512


class _HedgedCall:
    """One logical request fanned across a ReplicaSet's live replicas.

    At most one attempt is launched per replica; attempts are added by the
    hedge timer or by a failed attempt (failover).  The first successful
    attempt resolves the outer Future and cancels the rest; the outer
    Future fails only when every launched attempt has failed and no
    replica remains to try.
    """

    __slots__ = (
        "rs", "call", "slots", "outer", "lock", "next_slot", "inflight",
        "done", "timer", "t0", "inners", "last_exc", "failed_over", "parent",
    )

    def __init__(self, rs: ReplicaSet, call, slots: list[int], parent=None):
        self.rs = rs
        self.call = call
        self.slots = slots
        self.parent = parent  # TraceContext/traceparent of the caller's span
        self.outer: Future = Future()
        self.lock = threading.Lock()
        self.next_slot = 0  # next index into slots to try
        self.inflight = 0
        self.done = False
        self.timer: threading.Timer | None = None
        self.t0 = time.perf_counter()
        self.inners: list[Future] = []
        self.last_exc: Exception | None = None
        self.failed_over = False

    def start(self, hedge_delay_s: float | None) -> Future:
        self._launch_next()
        if hedge_delay_s is not None and math.isfinite(hedge_delay_s):
            with self.lock:
                if not self.done and self.next_slot < len(self.slots):
                    self.timer = threading.Timer(hedge_delay_s, self._hedge)
                    self.timer.daemon = True
                    self.timer.start()
        return self.outer

    def _launch_next(self, kind: str = "first") -> bool:
        """Launch one attempt on the next untried replica.

        Returns True when an attempt went out.  Synchronous launch
        failures (dead replica) roll over to the next slot inline; when
        the slots are exhausted and nothing is in flight, the outer
        Future fails with the last error seen.  Each attempt that goes
        out (or fails synchronously) gets its own ``replica.attempt``
        span annotated with how it was launched (first/hedge/failover).
        """
        while True:
            with self.lock:
                if self.done:
                    return False
                if self.next_slot >= len(self.slots):
                    if self.inflight > 0:
                        return False  # a live attempt may still win
                    self.done = True
                    exc = self.last_exc or self.rs._all_dead_error()
                    break
                attempt = self.next_slot
                slot = self.slots[self.next_slot]
                self.next_slot += 1
                self.inflight += 1
            worker = self.rs._worker_at(slot)
            span = TRACER.start(
                self.parent, "replica.attempt",
                shard=self.rs.spec.index, slot=slot, attempt=attempt,
                kind=kind,
            )
            try:
                ctx = span.ctx
                inner = (
                    self.call(worker, ctx) if ctx is not None
                    else self.call(worker, None)
                )
            except Exception as e:
                span.end(error=f"{type(e).__name__}: {e}")
                self.rs._note_sync_failure(slot, e)
                with self.lock:
                    self.inflight -= 1
                    self.last_exc = e
                kind = "failover"
                continue
            with self.lock:
                self.inners.append(inner)
            inner.add_done_callback(
                lambda f, s=slot, sp=span: self._attempt_done(s, f, sp)
            )
            return True
        self._finish_exc(exc)
        return False

    def _hedge(self) -> None:
        with self.lock:
            if self.done or self.next_slot >= len(self.slots):
                return
        if self._launch_next(kind="hedge"):
            self.rs._count("hedges_fired")

    def _attempt_done(self, slot: int, f: Future, span=None) -> None:
        try:
            exc = f.exception()
        except CancelledError:
            if span is not None:
                span.end(cancelled=True)  # the losing hedge attempt
            return  # we cancelled it as the loser
        if exc is None:
            if span is not None:
                span.end()
            self._win(slot, f.result())
            return
        if span is not None:
            span.end(error=f"{type(exc).__name__}: {exc}")
        with self.lock:
            self.inflight -= 1
            self.last_exc = exc
            if self.done:
                return
            self.failed_over = True
        if self._launch_next(kind="failover"):
            self.rs._count("failovers")

    def _win(self, slot: int, result) -> None:
        with self.lock:
            if self.done:
                return  # a faster attempt already won
            self.done = True
            timer = self.timer
            losers = [x for x in self.inners if not x.done()]
        if timer is not None:
            timer.cancel()
        for loser in losers:
            loser.cancel()
        self.rs._record_latency((time.perf_counter() - self.t0) * 1e3)
        if slot != self.slots[0] and not self.failed_over:
            self.rs._count("hedge_wins")
        try:
            self.outer.set_result(result)
        except InvalidStateError:
            pass  # caller cancelled the outer future

    def _finish_exc(self, exc: Exception) -> None:
        with self.lock:
            timer = self.timer
        if timer is not None:
            timer.cancel()
        try:
            self.outer.set_exception(exc)
        except InvalidStateError:
            pass


class ReplicaSet:
    """Worker-protocol facade over N replicas of one shard.

    ``factory(slot, on_death)`` builds one replica worker (the pool
    supplies it, closing over endpoint/artifact configuration); the set
    builds all N up front and rebuilds dead slots through the same
    factory.  ``hedge_ms`` fixes the hedge delay; None adapts it to the
    ``HEDGE_PERCENTILE`` of recent winning latencies; ``float("inf")``
    disables hedging (failover still applies).
    """

    transport = "replicas"

    def __init__(
        self,
        spec: ShardSpec,
        factory,
        n: int,
        *,
        hedge_ms: float | None = None,
        hedge_percentile: float = HEDGE_PERCENTILE,
        hedge_floor_ms: float = HEDGE_FLOOR_MS,
        max_respawns: int = 3,
        respawn_backoff: float = 0.1,
        spawn_timeout: float = 300.0,
    ):
        if n < 1:
            raise ValueError(f"a ReplicaSet needs >= 1 replica, got {n}")
        self.spec = spec
        self._factory = factory
        self._hedge_ms = hedge_ms
        self._hedge_percentile = float(hedge_percentile)
        self._hedge_floor_ms = float(hedge_floor_ms)
        self._max_respawns = int(max_respawns)
        self._backoff = float(respawn_backoff)
        self._spawn_timeout = float(spawn_timeout)
        self._lock = threading.Lock()
        self._closing = False
        self._rr = 0
        self._lat_ms: deque = deque(maxlen=_LATENCY_WINDOW)
        self._respawns_left = [self._max_respawns] * n
        self._counters = {
            "hedges_fired": 0,
            "hedge_wins": 0,
            "failovers": 0,
            "replica_deaths": 0,
            "replica_respawns": 0,
        }
        self._live = [True] * n
        self.replicas: list[Worker] = [
            factory(slot, self._death_cb(slot)) for slot in range(n)
        ]

    # ------------------------------------------------------------------ #
    # Worker protocol
    # ------------------------------------------------------------------ #
    def submit(self, keywords: list[str], semantics: str, trace=None) -> Future:
        # each attempt gets its own span ctx; trace= is only passed down
        # when the attempt is actually traced, so replica fakes/stubs with
        # the legacy two-arg signature keep working
        def call(w, ctx):
            if ctx is not None:
                return w.submit(keywords, semantics, trace=ctx)
            return w.submit(keywords, semantics)

        return self._dispatch(call, trace)

    def doc_stats(self, kw_ids: list[int], trace=None) -> Future:
        # hedged like submit: a stalled replica must not set the ELCA
        # residual's tail either
        def call(w, ctx):
            if ctx is not None:
                return w.doc_stats(kw_ids, trace=ctx)
            return w.doc_stats(kw_ids)

        return self._dispatch(call, trace)

    def health(self) -> tuple[int, int]:
        """(configured, live) replica counts for this shard."""
        with self._lock:
            return len(self.replicas), sum(1 for ok in self._live if ok)

    def stats(self) -> QueryStats:
        with self._lock:
            workers = [
                w for w, live in zip(self.replicas, self._live) if live
            ]
            counters = dict(self._counters)
            live = len(workers)
        parts = []
        for w in workers:
            try:
                parts.append(w.stats())
            except Exception:
                parts.append(QueryStats(data={"worker_dead": 1}))
        merged = QueryStats.merge(parts)
        merged.data.update(counters)
        merged.data["replicas"] = len(self.replicas)
        merged.data["replicas_live"] = live
        return merged

    def drain(self, timeout: float = 30.0) -> None:
        for w, live in zip(list(self.replicas), list(self._live)):
            if not live:
                continue
            try:
                w.drain(timeout)
            except Exception:
                pass  # a dead replica must not block draining the rest

    def close(self, timeout: float = 30.0) -> None:
        with self._lock:
            self._closing = True
            workers = list(self.replicas)
        for w in workers:
            w.close(timeout)

    # ------------------------------------------------------------------ #
    # Pool-facing lifecycle (spawn verification + remote reload)
    # ------------------------------------------------------------------ #
    def wait_ready(self, timeout: float) -> bool:
        """True once *every* replica is ready (initial spawn verification)."""
        deadline = time.monotonic() + timeout
        for w in list(self.replicas):
            if not _wait_one(w, max(0.0, deadline - time.monotonic())):
                return False
        return True

    @property
    def _dead(self) -> WorkerDied | None:
        """A typed post-mortem when the whole set is unusable (pool hook)."""
        for w in self.replicas:
            err = getattr(w, "_dead", None)
            if err is not None:
                return err
        return None

    def reload(self, shard_dir: str, timeout: float = 300.0) -> None:
        """Hot-swap every replica onto a new artifact (remote replicas)."""
        for w in list(self.replicas):
            w.reload(shard_dir, timeout=timeout)

    # ------------------------------------------------------------------ #
    # Dispatch plumbing
    # ------------------------------------------------------------------ #
    def _dispatch(self, call, trace=None) -> Future:
        slots = self._pick_order()
        if not slots:
            raise self._all_dead_error()
        return _HedgedCall(self, call, slots, trace).start(self._hedge_delay_s())

    def _pick_order(self) -> list[int]:
        """Live replica slots, rotated round-robin for load spreading."""
        with self._lock:
            live = [s for s, ok in enumerate(self._live) if ok]
            if not live:
                return []
            start = self._rr % len(live)
            self._rr += 1
        return live[start:] + live[:start]

    def _hedge_delay_s(self) -> float | None:
        if len(self.replicas) < 2:
            return None
        if self._hedge_ms is not None:
            return float(self._hedge_ms) / 1e3
        with self._lock:
            samples = list(self._lat_ms)
        if len(samples) < _MIN_SAMPLES:
            return DEFAULT_COLD_HEDGE_MS / 1e3
        p = float(np.percentile(np.asarray(samples), self._hedge_percentile))
        return max(p, self._hedge_floor_ms) / 1e3

    def _worker_at(self, slot: int) -> Worker:
        with self._lock:
            return self.replicas[slot]

    def _record_latency(self, ms: float) -> None:
        with self._lock:
            self._lat_ms.append(float(ms))

    def _count(self, key: str) -> None:
        with self._lock:
            self._counters[key] += 1

    def _note_sync_failure(self, slot: int, exc: Exception) -> None:
        if isinstance(exc, WorkerDied):
            with self._lock:
                self._live[slot] = False

    def _all_dead_error(self) -> WorkerDied:
        return self._dead or WorkerDied(
            self.spec.index, "no live replica in the set"
        )

    # ------------------------------------------------------------------ #
    # Replica supervision
    # ------------------------------------------------------------------ #
    def _death_cb(self, slot: int):
        return lambda w: self._on_replica_death(slot, w)

    def _on_replica_death(self, slot: int, worker: Worker) -> None:
        """Reader-thread callback: mark the slot dead, rebuild it bounded.

        Runs on the dead replica's reader thread — sleeping here blocks
        nobody, and the replica's in-flight Futures were already failed
        (the hedged dispatch fails over on them).
        """
        with self._lock:
            if self.replicas[slot] is not worker:
                return  # a rebuild already replaced this slot
            self._live[slot] = False
            self._counters["replica_deaths"] += 1
            if self._closing:
                return
        while True:
            with self._lock:
                if self._closing or self.replicas[slot] is not worker:
                    return
                if self._respawns_left[slot] <= 0:
                    return
                self._respawns_left[slot] -= 1
                attempt = self._max_respawns - self._respawns_left[slot]
            time.sleep(min(self._backoff * (2 ** (attempt - 1)), 2.0))
            try:
                fresh = self._build_slot(slot)
            except WorkerDied:
                continue  # the per-slot budget bounds this loop
            with self._lock:
                if self._closing or self.replicas[slot] is not worker:
                    stale = fresh
                else:
                    self.replicas[slot] = fresh
                    self._live[slot] = True
                    self._counters["replica_respawns"] += 1
                    stale = None
            if stale is not None:
                threading.Thread(
                    target=stale.close, args=(5.0,), daemon=True
                ).start()
            return

    def _build_slot(self, slot: int) -> Worker:
        """Fresh, verified-ready replica for ``slot`` (raises WorkerDied)."""
        w = self._factory(slot, self._death_cb(slot))
        if not _wait_one(w, self._spawn_timeout):
            err = getattr(w, "_dead", None) or WorkerDied(
                self.spec.index,
                f"replica {slot} not ready after {self._spawn_timeout}s",
            )
            w.close(timeout=5.0)
            raise err
        return w


def _wait_one(w, timeout: float) -> bool:
    wait = getattr(w, "wait_ready", None)
    if wait is None:
        return True  # thread workers are ready by construction
    return wait(timeout)
