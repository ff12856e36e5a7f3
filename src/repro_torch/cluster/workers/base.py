"""The worker seam: transport-agnostic per-shard execution.

A :class:`Worker` answers three questions about its shard — "run this
query" (``submit``), "how many of your documents contain these keywords"
(``doc_stats``, the router's corpus-root ELCA residual input) and "how are
you doing" (``stats``) — plus a two-phase shutdown (``drain`` flushes
queued queries while keeping the worker answerable, ``close`` terminates).
The router (:mod:`repro_torch.cluster.router`) is pure routing/merge logic over a
list of Workers; transports differ only in where the engine lives:

  * :class:`~repro_torch.cluster.workers.thread.ThreadWorker` — engine
    in-process behind a QueryService drain thread (every shard's drain
    launches on the same device, all on its default stream);
  * :class:`~repro_torch.cluster.workers.process.ProcessWorker` — engine in a
    spawned subprocess over the shard's mmap'd artifact (index pages shared
    across workers through the page cache), speaking the
    :mod:`~repro_torch.cluster.workers.proto` pipe RPC with request pipelining;
  * :class:`~repro_torch.cluster.workers.remote.RemoteWorker` — engine on another
    host behind a standalone shard server
    (:mod:`~repro_torch.cluster.workers.server`), same framing over TCP;
  * :class:`~repro_torch.cluster.workers.pool.ProcessPool` /
    :class:`~repro_torch.cluster.workers.pool.RemotePool` — the supervisors that
    build those workers, detect crashes and respawn/reconnect (bounded).

``submit`` and ``doc_stats`` both return Futures so the router can overlap
requests across shards regardless of transport; a worker that dies fails
its outstanding Futures with the typed :class:`WorkerDied`, which the
gather path surfaces to every caller instead of hanging them.

:class:`RpcWorker` is the shared client half of the frame RPC: the process
and remote transports differ only in what carries the bytes (a pipe pair vs
a socket), so the pipelined request registry, the response reader thread,
and the death bookkeeping live here once.
"""
from __future__ import annotations

import threading
from concurrent.futures import Future, InvalidStateError
from typing import Protocol, runtime_checkable

import numpy as np

from repro_torch.core.engine import QueryStats
from repro_torch.core.idlist import ContainmentTable
from repro_torch.obs import TRACER, HeatSketch, LatencyHistogram, parse_traceparent

from ..partition import ShardSpec
from .proto import load_array, read_frame, write_frame

# Default per-op deadline for blocking RPC round-trips (stats, reload,
# drain acks, the router's gather-side waits).  One knob, threaded through
# pools and the router, so a peer that stops answering mid-operation fails
# typed after a bounded wait instead of hanging its caller forever.
DEFAULT_OP_TIMEOUT = 60.0


class WorkerDied(RuntimeError):
    """A shard worker process/thread is gone (crash, kill, failed spawn).

    Raised synchronously by ``submit`` on a dead worker and set on every
    Future that was in flight when the worker died — callers always get a
    typed error, never a hang.
    """

    def __init__(self, shard: int, detail: str):
        self.shard = shard
        self.detail = detail
        super().__init__(f"shard {shard} worker died: {detail}")


@runtime_checkable
class Worker(Protocol):
    """What the router needs from one shard, whatever the transport."""

    spec: ShardSpec

    def submit(self, keywords: list[str], semantics: str, trace=None) -> Future:
        """Run one query; Future resolves to sorted shard-local node ids.

        ``trace`` (a traceparent string or TraceContext, always optional —
        the router only passes it for traced queries) parents the worker's
        spans.  Implementations may ignore it.
        """
        ...

    def doc_stats(self, kw_ids: list[int], trace=None) -> Future:
        """Future of ``(docs-per-keyword counts, #docs containing all)``."""
        ...

    def stats(self) -> QueryStats:
        """Snapshot of the worker's service counters."""
        ...

    def drain(self, timeout: float = 30.0) -> None:
        """Flush queued queries; the worker stays answerable afterwards."""
        ...

    def close(self, timeout: float = 30.0) -> None:
        """Drain and terminate.  Must be idempotent."""
        ...


def shard_doc_stats(
    containment: ContainmentTable, doc_roots: np.ndarray, kw_ids: list[int]
) -> tuple[np.ndarray, int]:
    """(#docs containing each keyword, #docs containing all of them).

    Pure reads of the shard's containment table (thread-safe); one
    searchsorted of the doc-root set per keyword.  Shared by both
    transports — the thread worker calls it in-process, the subprocess
    entrypoint calls it behind the RPC.
    """
    present = np.zeros((len(kw_ids), doc_roots.size), dtype=bool)
    for j, k in enumerate(kw_ids):
        nodes, _ = containment.slice_for(k)
        if nodes.size:
            pos = np.minimum(np.searchsorted(nodes, doc_roots), nodes.size - 1)
            present[j] = nodes[pos] == doc_roots
    return present.sum(axis=1).astype(np.int64), int(present.all(axis=0).sum())


def _stamp_trace(msg: dict, trace) -> None:
    """Attach the optional ``"tp"`` trace field to an outgoing RPC header.

    Old servers ignore unknown header fields, so stamping is always safe;
    anything unparsable is simply not stamped (tracing never fails an op).
    """
    ctx = parse_traceparent(trace) if trace is not None else None
    if ctx is not None:
        msg["tp"] = ctx.traceparent


class RpcWorker:
    """Client half of the pipelined frame RPC, shared by process + remote.

    Subclasses own the byte carrier: they set ``self._rfile`` /
    ``self._wfile`` (binary streams speaking :mod:`.proto` frames), call
    :meth:`_start_reader` once both exist, and implement ``close``.
    Everything else — request ids, the pending-Future registry, response
    matching on the reader thread, typed death — is identical whether the
    peer is a child process on a pipe or a shard server on a socket.

    Requests are *pipelined*: ``submit``/``doc_stats`` assign an id,
    register a Future, write one frame, and return; the single reader
    thread matches response frames (completion order, not request order)
    back to their Futures.  Death is a first-class outcome, not a hang:
    EOF, a broken carrier, or a corrupt frame
    (:class:`~repro_torch.cluster.workers.proto.ProtocolError`) fails every
    in-flight Future with the typed :class:`WorkerDied`, subsequent
    requests raise it synchronously, and the ``on_death`` callback lets the
    supervising pool respawn or reconnect.
    """

    def __init__(
        self,
        spec: ShardSpec,
        *,
        op_timeout: float = DEFAULT_OP_TIMEOUT,
        on_death=None,
    ):
        self.spec = spec
        self.op_timeout = float(op_timeout)
        self.on_death = on_death
        self.pid: int | None = None
        self.ready = threading.Event()
        self._lock = threading.Lock()  # pending registry + frame writes
        self._pending: dict[int, tuple[str, Future]] = {}
        self._next_id = 0
        self._dead: WorkerDied | None = None
        self._closing = False
        self._rfile = None  # set by the subclass before _start_reader
        self._wfile = None
        self._reader: threading.Thread | None = None

    # ------------------------------------------------------------------ #
    # Worker protocol (close/drain are transport-specific)
    # ------------------------------------------------------------------ #
    def submit(self, keywords: list[str], semantics: str, trace=None) -> Future:
        msg = {"op": "submit", "keywords": list(keywords), "semantics": semantics}
        _stamp_trace(msg, trace)
        return self._request(msg)

    def doc_stats(self, kw_ids: list[int], trace=None) -> Future:
        msg = {"op": "doc_stats", "kw_ids": [int(k) for k in kw_ids]}
        _stamp_trace(msg, trace)
        return self._request(msg)

    def health(self) -> tuple[int, int]:
        """(configured, live) replica counts — one connection, dead or not."""
        return 1, 0 if self._dead is not None else 1

    def stats(self) -> QueryStats:
        try:
            return self._request({"op": "stats"}).result(self.op_timeout)
        except Exception:
            # dead/hung worker: stats collection must never take the
            # cluster rollup down with it
            return QueryStats(data={"worker_dead": 1})

    def call(self, op: str, **fields) -> Future:
        """Generic op round-trip (``reload``, ``drain`` acks, ...)."""
        return self._request(dict(fields, op=op))

    # ------------------------------------------------------------------ #
    # Plumbing
    # ------------------------------------------------------------------ #
    def wait_ready(self, timeout: float) -> bool:
        """True once the peer announced itself; False = dead/timed out."""
        self.ready.wait(timeout)
        return self.ready.is_set() and self._dead is None

    def _start_reader(self, name: str) -> None:
        self._reader = threading.Thread(
            target=self._read_loop, name=name, daemon=True
        )
        self._reader.start()

    def _request(self, msg: dict) -> Future:
        fut: Future = Future()
        with self._lock:
            if self._dead is not None:
                raise self._dead
            rid = self._next_id
            self._next_id += 1
            self._pending[rid] = (msg["op"], fut)
            try:
                write_frame(self._wfile, dict(msg, id=rid))
            except (OSError, ValueError) as e:
                self._pending.pop(rid, None)
                raise WorkerDied(
                    self.spec.index, f"rpc write failed: {e}"
                ) from e
        return fut

    def _read_loop(self) -> None:
        detail = "rpc stream closed (EOF)"
        try:
            while True:
                msg, payload = read_frame(self._rfile)
                if msg is None:
                    break
                if msg.get("op") == "ready":
                    self.pid = msg.get("pid")
                    self.ready.set()
                    continue
                if msg.get("op") == "error" and msg.get("id") == -1:
                    # the peer could not start (subproc): carry its reason
                    detail = (
                        f"worker failed to start: {msg.get('etype', 'Error')}: "
                        f"{msg.get('error', '?')}"
                    )
                    break
                with self._lock:
                    op, fut = self._pending.pop(msg["id"], (None, None))
                if fut is None:
                    continue
                self._resolve(op, fut, msg, payload)
        except Exception as e:
            detail = f"rpc stream error: {e!r}"
        self._mark_dead(self._death_detail(detail))

    def _death_detail(self, detail: str) -> str:
        """Subclass hook: append carrier-specific post-mortem info."""
        return detail

    def _resolve(self, op: str, fut: Future, msg: dict, payload: bytes) -> None:
        # traced requests carry their worker-side spans home in the reply
        # header; adopt them into this process's tracer *before* resolving,
        # so a caller that collects the trace after .result() sees them
        spans = msg.get("spans")
        if spans:
            TRACER.adopt(spans)
        try:
            if not msg.get("ok", False):
                fut.set_exception(
                    RuntimeError(
                        f"shard {self.spec.index} worker "
                        f"{msg.get('etype', 'Error')}: {msg.get('error', '?')}"
                    )
                )
            elif op == "submit":
                fut.set_result(load_array(payload))
            elif op == "doc_stats":
                fut.set_result((load_array(payload), int(msg["full"])))
            elif op == "stats":
                hist = msg.get("hist")
                heat = msg.get("heat")
                fut.set_result(
                    QueryStats(
                        data=dict(msg["data"]),
                        latencies_ms=list(msg.get("latencies", ())),
                        # new peers send the histogram (authoritative); an
                        # old peer's sample window folds in via __post_init__
                        **(
                            {"hist": LatencyHistogram.from_dict(hist)}
                            if hist
                            else {}
                        ),
                        heat=HeatSketch.from_dict(heat) if heat else None,
                        slow=list(msg.get("slow", ())),
                    )
                )
            else:
                fut.set_result(True)  # drain/reload acks and friends
        except InvalidStateError:
            pass  # caller cancelled; nothing to deliver
        except Exception as e:  # malformed payload: fail the one request
            try:
                fut.set_exception(e)
            except InvalidStateError:
                pass

    def _mark_dead(self, detail: str) -> None:
        err = WorkerDied(self.spec.index, detail)
        with self._lock:
            if self._dead is None:
                self._dead = err
            pending = [fut for _, fut in self._pending.values()]
            self._pending.clear()
            closing = self._closing
        self.ready.set()  # unblock wait_ready; it re-checks _dead
        for fut in pending:
            try:
                fut.set_exception(err)
            except InvalidStateError:
                pass
        if not closing and self.on_death is not None:
            try:
                self.on_death(self)
            except Exception:  # supervision must never kill the reader
                pass
