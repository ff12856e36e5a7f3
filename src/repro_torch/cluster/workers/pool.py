"""Worker pools: construction, supervision, and hot-swap of shard workers.

A pool owns the ``workers`` list the router fans out over and knows how to
build a *replacement* worker for one shard (``spawn`` + ``install`` — the
primitive under ``ClusterService.reload_shard`` and crash recovery).  The
router handles query-level lifetime (admission, worker refcounts, retiring
swapped-out workers only when idle); the pool handles process/engine-level
lifetime.

Every pool takes ``device`` (``"cuda"`` unless the caller names the CPU)
and every shard engine it builds or spawns searches there; ``backends``
are the port's names (``scalar | torch | fused | chained``, default
``"torch"``), checked before any worker starts.

:class:`ThreadPool` builds ThreadWorkers from in-process engines.
:class:`ProcessPool` spawns one subprocess per shard over its artifact dir.
:class:`RemotePool` connects to standalone shard servers
(:mod:`~repro_torch.cluster.workers.server`) by endpoint, falling back to a local
ProcessWorker for any shard with no endpoint configured — locality is a
per-shard deployment choice, not a pool-wide one.

Both supervised pools share the same crash contract: a worker that dies
outside an intentional shutdown is replaced in place — respawned
(ProcessPool) or reconnected with exponential backoff (RemotePool) —
bounded per shard so a crash-looping artifact or a downed server cannot
fork-bomb or spin the host, while the queries that were in flight fail
fast with the typed ``WorkerDied`` (never a hang).
"""
from __future__ import annotations

import threading
import time

import torch

from repro_torch.api import resolve_device, validate_backend
from repro_torch.core.engine import KeywordSearchEngine

from ..partition import ShardSpec
from .base import DEFAULT_OP_TIMEOUT, Worker, WorkerDied
from .process import ProcessWorker
from .remote import RemoteWorker
from .replica import ReplicaSet
from .thread import ThreadWorker


class WorkerPool:
    """Shared swap/close plumbing; subclasses implement ``spawn``."""

    transport = "?"

    def __init__(self) -> None:
        self.workers: list[Worker] = []
        self._lock = threading.Lock()
        self._closed = False

    @property
    def locality(self) -> list[str]:
        """Per-shard transport actually in use (pools may mix them)."""
        return [getattr(w, "transport", self.transport) for w in self.workers]

    def spawn(self, i: int, path: str | None = None) -> Worker:
        """Build (but do not install) a replacement worker for shard ``i``,
        loading from artifact ``path`` when given."""
        raise NotImplementedError

    def install(self, i: int, worker: Worker) -> Worker:
        """Swap shard ``i``'s worker; returns the one swapped out."""
        with self._lock:
            old = self.workers[i]
            self.workers[i] = worker
        return old

    def rebuild(
        self, entries: list[tuple[ShardSpec, str]], manifest: dict
    ) -> WorkerPool:
        """A *new* pool of the same transport + settings over a new layout.

        The repartition primitive: ``entries`` are the (spec, artifact dir)
        pairs of the freshly published layout — possibly a different shard
        count at different boundaries.  The current pool keeps serving
        untouched; the caller swaps pools atomically and then retires this
        one via :meth:`detach`.
        """
        raise NotImplementedError(
            f"{type(self).__name__} cannot rebuild for a new layout"
        )

    def detach(self) -> list[Worker]:
        """Stop supervising and hand over the live workers *without* closing.

        Marks the pool closed so crash callbacks stop respawning (a respawn
        of an old-layout worker after the swap would leak a process), empties
        ``workers`` so a late ``close()`` is a no-op, and returns the workers
        for the caller (the router's layout transaction) to retire — each
        one is closed only after its last in-flight gather completes.
        """
        with self._lock:
            self._closed = True
            workers, self.workers = list(self.workers), []
        return workers

    def close(self, timeout: float = 30.0) -> None:
        with self._lock:
            self._closed = True
        for w in self.workers:
            w.close(timeout)


class ThreadPool(WorkerPool):
    """In-process engines behind QueryService drain threads, all on one
    device (``device`` must be where every given engine searches)."""

    transport = "thread"

    def __init__(
        self,
        shards: list[tuple[ShardSpec, KeywordSearchEngine]],
        *,
        backends: str | list[str] = "torch",
        max_batch: int = 64,
        batch_window_ms: float = 2.0,
        device: str | torch.device = "cuda",
    ):
        super().__init__()
        backends = _per_shard(backends, len(shards))
        self._device = resolve_device(device)
        for spec, engine in shards:
            if engine.device != self._device:
                raise ValueError(
                    f"shard {spec.index} engine runs on {engine.device}, "
                    f"the pool on {self._device}"
                )
        self._backends = backends
        self._max_batch = max_batch
        self._batch_window_ms = batch_window_ms
        self.workers = [
            ThreadWorker(
                spec,
                engine,
                backend=be,
                max_batch=max_batch,
                batch_window_ms=batch_window_ms,
            )
            for (spec, engine), be in zip(shards, backends)
        ]

    def spawn(self, i: int, path: str | None = None) -> ThreadWorker:
        if path is None:
            raise ValueError("thread transport reloads need an artifact path")
        old = self.workers[i]
        engine = KeywordSearchEngine.load(path, mmap=True, device=self._device)
        return ThreadWorker(
            old.spec,
            engine,
            backend=self._backends[i],
            max_batch=self._max_batch,
            batch_window_ms=self._batch_window_ms,
        )

    def rebuild(
        self, entries: list[tuple[ShardSpec, str]], manifest: dict
    ) -> ThreadPool:
        shards = [
            (spec, KeywordSearchEngine.load(d, mmap=True, device=self._device))
            for spec, d in entries
        ]
        return ThreadPool(
            shards,
            backends=_rebuild_backends(self._backends, len(entries)),
            max_batch=self._max_batch,
            batch_window_ms=self._batch_window_ms,
            device=self._device,
        )


class SupervisedPool(WorkerPool):
    """Bounded in-place replacement, shared by the process + remote pools.

    The budget discipline: each shard gets ``max_respawns`` replacement
    attempts; a successful ``install`` (a *new* artifact) resets the
    shard's budget.  ``_take_respawn_budget`` / ``_install_replacement``
    are the race-safe halves every supervisor callback is built from — a
    respawn that lost to a reload or a close is discarded, never leaked.
    """

    def __init__(
        self, n: int, *, max_respawns: int, spawn_timeout: float
    ) -> None:
        super().__init__()
        self._max_respawns = int(max_respawns)
        self._respawns_left = [self._max_respawns] * n
        self._spawn_timeout = float(spawn_timeout)
        self.respawns = 0  # total, for the stats rollup

    def install(self, i: int, worker: Worker) -> Worker:
        old = super().install(i, worker)
        with self._lock:
            # a fresh artifact gets a fresh crash budget
            self._respawns_left[i] = self._max_respawns
        return old

    def _ready_or_raise(self, worker, timeout: float):
        """Wait for a freshly built worker; on failure close it and raise
        the typed ``WorkerDied`` (spawn verification, not supervision)."""
        if not worker.wait_ready(timeout):
            err = worker._dead or WorkerDied(
                worker.spec.index, f"not ready after {timeout}s"
            )
            worker.close(timeout=5.0)
            raise err
        return worker

    def _take_respawn_budget(self, worker) -> int | None:
        """Claim one replacement attempt for ``worker``'s shard.

        Returns the attempt ordinal (1-based), or None when no respawn
        should happen: the pool is closing, the dead worker already lost a
        race to a reload, or the shard's budget is spent.
        """
        i = worker.spec.index
        with self._lock:
            if (
                self._closed
                or self.workers[i] is not worker  # raced a reload: obsolete
                or self._respawns_left[i] <= 0
            ):
                return None
            self._respawns_left[i] -= 1
            self.respawns += 1
            return self._max_respawns - self._respawns_left[i]

    def _install_replacement(self, worker, replacement) -> bool:
        """Swap ``replacement`` in for ``worker`` unless the world moved on
        (close or reload raced us), in which case the replacement is
        discarded on a background thread."""
        i = worker.spec.index
        with self._lock:
            if self._closed or self.workers[i] is not worker:
                threading.Thread(
                    target=replacement.close, args=(5.0,), daemon=True
                ).start()
                return False
            self.workers[i] = replacement
            return True


class ProcessPool(SupervisedPool):
    """Per-shard subprocesses over mmap'd artifact dirs, supervised.

    ``replicas=N`` (N > 1) runs each shard as a
    :class:`~repro_torch.cluster.workers.replica.ReplicaSet` of N subprocesses
    over the *same* mmap'd artifact (index pages shared through the page
    cache) — the socket-free way to get hedged dispatch and kill-tolerant
    failover, used by the tests and the open-loop benchmark.  Replica
    supervision then lives inside the set; the pool supervises only
    unreplicated shards.  Each subprocess opens its own context on
    ``device``; a child that cannot (``cuda`` on a host without CUDA) is
    reported not ready with its own error, never served on the CPU.
    """

    transport = "process"

    def __init__(
        self,
        shards: list[tuple[ShardSpec, str]],  # (spec, artifact dir)
        *,
        backends: str | list[str] = "torch",
        max_batch: int = 64,
        batch_window_ms: float = 2.0,
        max_respawns: int = 3,
        spawn_timeout: float = 300.0,
        op_timeout: float = DEFAULT_OP_TIMEOUT,
        replicas: int = 1,
        hedge_ms: float | None = None,
        device: str | torch.device = "cuda",
    ):
        super().__init__(
            len(shards), max_respawns=max_respawns, spawn_timeout=spawn_timeout
        )
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        backends = _per_shard(backends, len(shards))
        self._device = str(device)
        self._backends = backends
        self._max_batch = max_batch
        self._batch_window_ms = batch_window_ms
        self._op_timeout = float(op_timeout)
        self._replicas = int(replicas)
        self._hedge_ms = hedge_ms
        # spawn everything first (children load their artifacts in
        # parallel), then wait for readiness
        self.workers = [
            self._spawn_worker(spec, d, be)
            for (spec, d), be in zip(shards, backends)
        ]
        try:
            for w in self.workers:
                self._ready_or_raise(w, self._spawn_timeout)
        except WorkerDied:
            self.close(timeout=5.0)
            raise

    def _one_process(
        self, spec: ShardSpec, shard_dir: str, backend: str, on_death
    ) -> ProcessWorker:
        return ProcessWorker(
            spec,
            shard_dir,
            backend=backend,
            max_batch=self._max_batch,
            batch_window_ms=self._batch_window_ms,
            op_timeout=self._op_timeout,
            on_death=on_death,
            device=self._device,
        )

    def _spawn_worker(
        self, spec: ShardSpec, shard_dir: str, backend: str
    ) -> Worker:
        if self._replicas == 1:
            return self._one_process(spec, shard_dir, backend, self._on_death)

        def factory(slot, on_death, _spec=spec, _dir=shard_dir, _be=backend):
            return self._one_process(_spec, _dir, _be, on_death)

        rs = ReplicaSet(
            spec,
            factory,
            self._replicas,
            hedge_ms=self._hedge_ms,
            max_respawns=self._max_respawns,
            spawn_timeout=self._spawn_timeout,
        )
        rs.shard_dir = shard_dir  # reload bookkeeping, like ProcessWorker
        return rs

    def spawn(self, i: int, path: str | None = None) -> Worker:
        """Replacement worker for shard ``i`` — *verified* loadable.

        Blocks until the child reports ready (symmetric with
        ThreadPool.spawn, which loads the engine synchronously) so a bad
        artifact path raises :class:`WorkerDied` at the reload call site
        instead of silently burning the shard's respawn budget."""
        cur = self.workers[i]
        worker = self._spawn_worker(
            cur.spec, path or cur.shard_dir, self._backends[i]
        )
        return self._ready_or_raise(worker, self._spawn_timeout)

    def rebuild(
        self, entries: list[tuple[ShardSpec, str]], manifest: dict
    ) -> ProcessPool:
        return ProcessPool(
            entries,
            backends=_rebuild_backends(self._backends, len(entries)),
            max_batch=self._max_batch,
            batch_window_ms=self._batch_window_ms,
            max_respawns=self._max_respawns,
            spawn_timeout=self._spawn_timeout,
            op_timeout=self._op_timeout,
            replicas=self._replicas,
            hedge_ms=self._hedge_ms,
            device=self._device,
        )

    def _on_death(self, worker: ProcessWorker) -> None:
        """Reader-thread callback on unexpected death: bounded respawn.

        The dead worker's in-flight Futures were already failed with
        ``WorkerDied`` (fail-fast, the callers retry or surface the error);
        respawning here restores capacity for everything that follows.
        """
        if self._take_respawn_budget(worker) is None:
            return
        replacement = self._spawn_worker(
            worker.spec, worker.shard_dir, self._backends[worker.spec.index]
        )
        self._install_replacement(worker, replacement)


class RemotePool(SupervisedPool):
    """Shard workers behind TCP endpoints, with local process fallback.

    ``endpoints[i]`` is ``"host:port"`` for a shard served by a standalone
    shard server, or None to run that shard as a local subprocess over its
    artifact dir — when both a local artifact and no endpoint are
    configured the pool prefers the local worker (no network hop, shared
    page cache).  Supervision is per-locality: a dead local worker is
    respawned like ProcessPool; a dead connection is *re-dialed* with
    exponential backoff (the server owns the engine; reconnecting is
    cheap), bounded by the same per-shard budget so a downed server
    surfaces as a typed ``WorkerDied`` instead of a spin or a hang.

    ``spawn(i, path)`` — the reload primitive — asks a remote shard's
    server to hot-swap via the ``reload`` op (``path`` names a directory on
    the *server's* host) and returns a fresh connection; in-flight queries
    on the old connection finish on the old engine, exactly the process
    transport's contract.

    ``endpoints[i]`` may also be a *list* of ``"host:port"`` strings: the
    shard is then served by a :class:`ReplicaSet` over one connection per
    endpoint — hedged dispatch, failover, and per-replica reconnect all
    live in the set (see :mod:`~repro_torch.cluster.workers.replica`); the
    pool-level budget applies only to unreplicated shards.

    ``device`` is where the pool's *local* workers search; a remote shard
    searches wherever its server was started (``--device``).
    """

    transport = "remote"

    def __init__(
        self,
        shards: list[tuple[ShardSpec, str]],  # (spec, artifact dir)
        *,
        endpoints: list[str | list[str] | None],
        backends: str | list[str] = "torch",
        max_batch: int = 64,
        batch_window_ms: float = 2.0,
        max_respawns: int = 3,
        spawn_timeout: float = 300.0,
        connect_timeout: float = 30.0,
        op_timeout: float = DEFAULT_OP_TIMEOUT,
        reconnect_backoff: float = 0.1,
        hedge_ms: float | None = None,
        device: str | torch.device = "cuda",
    ):
        super().__init__(
            len(shards), max_respawns=max_respawns, spawn_timeout=spawn_timeout
        )
        self._device = str(device)
        if len(endpoints) != len(shards):
            raise ValueError(
                f"{len(shards)} shards but {len(endpoints)} endpoints"
            )
        self._specs = [spec for spec, _ in shards]
        self._dirs = [d for _, d in shards]
        self._endpoints = [_norm_endpoints(e) for e in endpoints]
        self._hedge_ms = hedge_ms
        self._backends = _per_shard(backends, len(shards))
        self._max_batch = max_batch
        self._batch_window_ms = batch_window_ms
        self._connect_timeout = float(connect_timeout)
        self._op_timeout = float(op_timeout)
        self._backoff = float(reconnect_backoff)
        try:
            for i in range(len(shards)):
                self.workers.append(self._build(i))
            for w in self.workers:
                self._ready_or_raise(w, self._spawn_timeout)
        except WorkerDied:
            self.close(timeout=5.0)
            raise

    def _local_worker(self, i: int, shard_dir: str) -> ProcessWorker:
        """The single construction site for this pool's local workers, so
        initial builds, reload spawns, and crash respawns can never drift
        out of configuration sync."""
        return ProcessWorker(
            self._specs[i],
            shard_dir,
            backend=self._backends[i],
            max_batch=self._max_batch,
            batch_window_ms=self._batch_window_ms,
            op_timeout=self._op_timeout,
            on_death=self._on_death,
            device=self._device,
        )

    def _dial(self, i: int, endpoint: str, on_death) -> RemoteWorker:
        return RemoteWorker(
            self._specs[i],
            endpoint,
            connect_timeout=self._connect_timeout,
            op_timeout=self._op_timeout,
            on_death=on_death,
        )

    def _build(self, i: int) -> Worker:
        """Fresh worker for shard ``i`` at its configured locality.

        Raises :class:`WorkerDied` when the endpoint does not answer (the
        supervisor's reconnect loop treats that as one burned attempt)."""
        eps = self._endpoints[i]
        if eps is None:
            return self._local_worker(i, self._dirs[i])
        if len(eps) == 1:
            return self._dial(i, eps[0], self._on_death)

        def factory(slot, on_death, _i=i, _eps=eps):
            return self._dial(_i, _eps[slot], on_death)

        return ReplicaSet(
            self._specs[i],
            factory,
            len(eps),
            hedge_ms=self._hedge_ms,
            max_respawns=self._max_respawns,
            respawn_backoff=self._backoff,
            spawn_timeout=self._spawn_timeout,
        )

    def spawn(self, i: int, path: str | None = None) -> Worker:
        if self._endpoints[i] is None:
            worker = self._local_worker(i, path or self._dirs[i])
            return self._ready_or_raise(worker, self._spawn_timeout)
        worker = self._ready_or_raise(self._build(i), self._spawn_timeout)
        if path is not None:
            try:
                worker.reload(path, timeout=self._spawn_timeout)
            except Exception as e:
                worker.close(timeout=5.0)
                raise WorkerDied(
                    i, f"remote reload onto {path} failed: {e}"
                ) from e
        return worker

    def rebuild(
        self, entries: list[tuple[ShardSpec, str]], manifest: dict
    ) -> RemotePool:
        # endpoints for the new layout come from the committed manifest: a
        # repartitioned shard with no placement yet (endpoint null) runs
        # locally over its fresh artifact dir, exactly like from_dir
        from ..manifest import manifest_endpoints

        return RemotePool(
            entries,
            endpoints=manifest_endpoints(manifest),
            backends=_rebuild_backends(self._backends, len(entries)),
            max_batch=self._max_batch,
            batch_window_ms=self._batch_window_ms,
            max_respawns=self._max_respawns,
            spawn_timeout=self._spawn_timeout,
            connect_timeout=self._connect_timeout,
            op_timeout=self._op_timeout,
            reconnect_backoff=self._backoff,
            hedge_ms=self._hedge_ms,
            device=self._device,
        )

    def redirect(self, i: int, endpoint: str | list[str] | None) -> Worker:
        """Re-point shard ``i`` at a new endpoint and dial it (shard move).

        Updates the pool's endpoint config so crash reconnects go to the new
        host, then returns a ready worker for the caller to ``install`` —
        the old worker keeps serving its in-flight queries until the router
        retires it, the standard hot-swap contract.
        """
        if not 0 <= i < len(self._specs):
            raise IndexError(f"shard {i} out of range")
        with self._lock:
            if self._closed:
                raise RuntimeError("redirect() on a closed pool")
            self._endpoints[i] = _norm_endpoints(endpoint)
        return self._ready_or_raise(self._build(i), self._spawn_timeout)

    def _on_death(self, worker) -> None:
        """Reader-thread callback: respawn locally, reconnect remotely."""
        i = worker.spec.index
        if self._endpoints[i] is None:
            if self._take_respawn_budget(worker) is None:
                return
            self._install_replacement(
                worker, self._local_worker(i, worker.shard_dir)
            )
            return
        while True:
            attempt = self._take_respawn_budget(worker)
            if attempt is None:
                return
            # runs on the dead worker's reader thread — sleeping here blocks
            # nobody; in-flight futures already failed with WorkerDied
            time.sleep(min(self._backoff * (2 ** (attempt - 1)), 2.0))
            try:
                replacement = self._ready_or_raise(
                    self._build(i), self._spawn_timeout
                )
            except WorkerDied:
                continue  # the per-shard budget bounds this loop
            self._install_replacement(worker, replacement)
            return


def _norm_endpoints(e: str | list[str] | None) -> list[str] | None:
    """One shard's endpoint config: None (local), "h:p", or a replica list."""
    if e is None:
        return None
    if isinstance(e, str):
        return [e]
    eps = [str(x) for x in e]
    return eps or None  # an empty replica list means "run it locally"


def _per_shard(backends: str | list[str], n: int) -> list[str]:
    """One port backend name per shard; reference names (``jax``, ``xla``,
    ``pallas``) and None are refused with the port's own message."""
    if isinstance(backends, str):
        backends = [backends] * n
    if len(backends) != n:
        raise ValueError(f"{n} shards but {len(backends)} backends")
    for be in backends:
        if be is None:
            raise ValueError("a shard needs a concrete backend, got None")
        validate_backend(be)
    return list(backends)


def _rebuild_backends(backends: list[str], n: int) -> list[str]:
    """Backend list for a rebuilt pool over ``n`` shards.

    A homogeneous pool carries its backend to any shard count; a
    heterogeneous per-shard assignment has no meaningful mapping onto new
    boundaries, so repartitioning such a pool is refused out loud.
    """
    uniq = set(backends)
    if len(uniq) > 1:
        raise ValueError(
            "cannot rebuild a pool with heterogeneous per-shard backends "
            f"({backends}) for a new layout — the old assignment has no "
            "mapping onto the new shard boundaries"
        )
    return [backends[0] if backends else "torch"] * n
