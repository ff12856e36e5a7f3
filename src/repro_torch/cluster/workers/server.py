"""Standalone shard server: the remote transport's host-side entrypoint.

    python -m repro_torch.cluster.workers.server --dir SHARD_DIR \
        --host 0.0.0.0 --port 9701 --backend fused --device cuda

Speaks the :mod:`~repro_torch.cluster.workers.proto` frame protocol over TCP —
the very same framing, ops, and drain loop the process transport runs over
a pipe (:mod:`~repro_torch.cluster.workers.subproc` imports them from here).  The
serving machinery is exactly :class:`~repro_torch.serve.service.QueryService`
over ``KeywordSearchEngine.load(dir, mmap=True, device=...)`` (``--device``,
default ``cuda``; a server asked for ``cuda`` on a host without CUDA
announces the failure and exits, it never serves on the CPU); request
pipelining falls
out of the architecture because each ``submit`` frame becomes a
``QueryService.submit`` and the reply is written from the Future's
done-callback, so many queries ride one socket concurrently and complete
out of order.

Differences from the pipe flavor, all deployment-driven:

  * **many connections** — N routers (or a router plus its replacement
    worker during a reload) can hold sockets to one server; every
    connection shares the single engine/service, so index pages and plan
    caches are paid once per host;
  * **``reload`` op** — swaps the served artifact in place
    (``{"op": "reload", "dir": ...}``; the path is resolved on *this*
    host).  In-flight queries finish on the old service (closed in the
    background once drained); everything after the swap runs on the new
    artifact.  This is how remote shards participate in
    ``reload_shard``/``rolling_publish``;
  * **lifecycle** — a client closing its socket ends that connection only;
    the server runs until killed.  On startup it prints one JSON line
    (``{"event": "listening", "host": ..., "port": ...}``) to stdout so
    supervisors — and :func:`launch_server` — can discover an ephemeral
    port (or ``{"event": "failed", "error": ...}`` when the engine cannot
    load, which :func:`launch_server` raises as ``WorkerDied``).

The frames are the reference package's byte for byte (same header JSON,
same ``.npy`` payloads), so a router of either package can talk to a shard
server of either package.  Result ids leave this process only as numpy
``int64`` arrays (:func:`_ids_payload`); anything else — a device tensor
included — fails that request loudly.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import threading
from collections.abc import Callable
from concurrent.futures import ThreadPoolExecutor
from typing import BinaryIO

import numpy as np
import torch

from repro_torch.core.engine import KeywordSearchEngine
from repro_torch.kernels import elca_segsum, fused_search, intersect, searchsorted
from repro_torch.obs import TRACER
from repro_torch.serve.service import QueryService

from ..partition import doc_roots
from .base import WorkerDied, shard_doc_stats
from .proto import dump_array, read_frame, write_frame


def kernel_launches() -> dict[str, int]:
    """This process's launches of each search kernel (its wrapper's
    ``LAUNCHES``), as ``kernel_launches_<kernel>`` stats counters.  A shard
    server or worker process serves one shard, so these are that shard's."""
    return {
        f"kernel_launches_{mod.__name__.rsplit('.', 1)[-1]}": mod.LAUNCHES
        for mod in (fused_search, searchsorted, intersect, elca_segsum)
    }


class EngineState:
    """The served (engine, service, doc roots) triple, swappable via reload.

    ``parts()`` returns one consistent snapshot — ops must read engine and
    roots from the same snapshot or a concurrent reload could pair a new
    containment table with old doc roots.
    """

    def __init__(
        self,
        shard_dir: str,
        *,
        backend: str = "torch",
        max_batch: int = 64,
        batch_window_ms: float = 2.0,
        device: str | torch.device = "cuda",
    ):
        self._backend = backend
        self._device = device
        self._max_batch = int(max_batch)
        self._batch_window_ms = float(batch_window_ms)
        self._lock = threading.Lock()
        self._drained = False
        self._cur = self._build(shard_dir)

    def _build(self, shard_dir: str):
        engine = KeywordSearchEngine.load(
            os.fspath(shard_dir), mmap=True, device=self._device
        )
        svc = QueryService(
            engine,
            max_batch=self._max_batch,
            batch_window_ms=self._batch_window_ms,
            backend=self._backend,
            device=engine.device,
        )
        return (os.fspath(shard_dir), engine, svc, doc_roots(engine.tree))

    def parts(self):
        """(dir, engine, svc, roots) — one consistent snapshot."""
        return self._cur

    @property
    def engine(self) -> KeywordSearchEngine:
        return self._cur[1]

    @property
    def svc(self) -> QueryService:
        return self._cur[2]

    def reload(self, shard_dir: str) -> None:
        """Serve ``shard_dir`` from now on; drain the old service behind.

        Queries already submitted complete on the old engine (their done
        callbacks hold their own reply handles); the old service is closed
        on a background thread so the reload ack never waits on a drain.
        """
        new = self._build(shard_dir)
        with self._lock:
            old = self._cur
            self._cur = new
        threading.Thread(
            target=old[2].close, name="engine-state-retire", daemon=True
        ).start()

    def drain_service(self) -> None:
        """Flush the service (terminally — the pipe transport's drain op)."""
        with self._lock:
            if self._drained:
                return
            self._drained = True
        self._cur[2].close()

    def close(self) -> None:
        self._cur[2].close()


def serve_stream(
    rpc_in: BinaryIO,
    reply: Callable[..., None],
    state: EngineState,
    *,
    allow_reload: bool = False,
    drain_closes: bool = True,
) -> None:
    """Serve one frame stream until EOF, a ``close`` op, or corrupt framing.

    ``reply(header, payload=b"")`` must be safe to call from any thread
    (submit replies come from the service's drain thread, everything else
    from this one) and must swallow carrier errors — a peer gone mid-reply
    ends the stream via this loop's next read, not via a reply crash.

    ``drain_closes`` picks the drain-op semantics: the pipe transport's
    single client owns the whole process, so ``drain`` terminally flushes
    the service; a socket server stays answerable for its other clients and
    just acks (the remote client drains by waiting out its own in-flight
    requests).  ``allow_reload`` gates the artifact hot-swap op the same
    way.
    """
    while True:
        try:
            msg, _payload = read_frame(rpc_in)
        except (OSError, ValueError):
            break  # corrupt framing (ProtocolError) or dead carrier
        if msg is None:  # peer is gone
            break
        op = msg.get("op", "?")
        rid = int(msg.get("id", -1))
        try:
            if op == "submit":
                _d, _eng, svc, _roots = state.parts()
                # traced requests carry "tp"; the span parents everything
                # this process records for the query, and the reply header
                # ships the finished spans home (old clients ignore them)
                sp = TRACER.start(
                    msg.get("tp"), "worker.rpc", op="submit", pid=os.getpid()
                )

                def done(f, rid=rid, sp=sp):
                    exc = f.exception()
                    sp.end()
                    # the service recorded its spans before resolving the
                    # Future, so collecting here sees the complete subtree
                    spans = (
                        TRACER.collect(sp.trace_id)
                        if sp.ctx is not None
                        else None
                    )
                    if exc is None:
                        hdr = {"id": rid, "op": "submit", "ok": True}
                        if spans:
                            hdr["spans"] = spans
                        try:
                            reply(hdr, _ids_payload(f.result()))
                            return
                        except Exception as e:  # un-dumpable result
                            exc = e
                    _fail(reply, rid, "submit", exc, spans)

                svc.submit(
                    msg["keywords"], msg["semantics"], trace=sp.ctx
                ).add_done_callback(done)
            elif op == "doc_stats":
                _d, engine, _svc, roots = state.parts()
                sp = TRACER.start(
                    msg.get("tp"), "worker.rpc", op="doc_stats",
                    pid=os.getpid(),
                )
                docs_k, full = shard_doc_stats(
                    engine.base.containment, roots, msg["kw_ids"]
                )
                sp.end()
                hdr = {"id": rid, "op": "doc_stats", "ok": True, "full": full}
                if sp.ctx is not None:
                    spans = TRACER.collect(sp.trace_id)
                    if spans:
                        hdr["spans"] = spans
                reply(hdr, dump_array(docs_k))
            elif op == "stats":
                snap = state.svc.stats()
                hdr = {
                    "id": rid, "op": "stats", "ok": True,
                    "data": {**snap.data, **kernel_launches()},
                    # kept for old clients; "hist" is authoritative
                    "latencies": snap.latencies_ms,
                    "hist": snap.hist.to_dict(),
                }
                # workload heat + slow-query entries ride the same header;
                # unknown fields are ignored by older peers
                if snap.heat is not None:
                    hdr["heat"] = snap.heat.to_dict()
                if snap.slow:
                    hdr["slow"] = snap.slow
                reply(hdr)
            elif op == "drain":
                if drain_closes:
                    state.drain_service()  # flushes; replies already sent
                reply({"id": rid, "op": "drain", "ok": True})
            elif op == "reload":
                if not allow_reload:
                    raise ValueError("reload is not supported on this transport")
                state.reload(msg["dir"])
                reply(
                    {
                        "id": rid, "op": "reload", "ok": True,
                        "num_nodes": int(state.engine.tree.num_nodes),
                    }
                )
            elif op == "close":
                break
            else:
                raise ValueError(f"unknown op {op!r}")
        except Exception as e:  # a bad request must not kill the worker
            _fail(reply, rid, op, e)


def _ids_payload(ids) -> bytes:
    """The ``.npy`` bytes of one result: numpy ``int64`` ids and nothing else.

    The wire format is the reference package's; a tensor (on any device) or
    another dtype would change the bytes, so it fails the request instead.
    """
    if not isinstance(ids, np.ndarray) or ids.dtype != np.int64:
        raise TypeError(
            "shard results cross the wire as numpy int64 ids, got "
            f"{type(ids).__name__} of {getattr(ids, 'dtype', '?')}"
        )
    return dump_array(ids)


def _fail(
    reply, rid: int, op: str, exc: BaseException, spans: list | None = None
) -> None:
    hdr = {
        "id": rid, "op": op, "ok": False,
        "etype": type(exc).__name__, "error": str(exc),
    }
    if spans:
        hdr["spans"] = spans  # a failed traced request still returns its tree
    reply(hdr)


# ---------------------------------------------------------------------- #
# TCP entrypoint
# ---------------------------------------------------------------------- #


def _serve_conn(conn: socket.socket, state: EngineState, shard: int) -> None:
    conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    rpc_in = conn.makefile("rb")
    rpc_out = conn.makefile("wb")
    wlock = threading.Lock()  # submit replies race doc_stats/acks

    def reply(header: dict, payload: bytes = b"") -> None:
        with wlock:
            try:
                write_frame(rpc_out, header, payload)
            except (OSError, ValueError):
                pass  # client gone mid-reply: the read loop ends on EOF

    reply(
        {
            "op": "ready", "id": -1, "pid": os.getpid(), "shard": shard,
            "num_nodes": int(state.engine.tree.num_nodes),
        }
    )
    try:
        serve_stream(rpc_in, reply, state, allow_reload=True, drain_closes=False)
    finally:
        try:
            conn.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        conn.close()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", required=True, help="shard index artifact dir")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0, help="0 = ephemeral")
    ap.add_argument("--shard", type=int, default=0)
    ap.add_argument("--backend", default="torch")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--batch-window-ms", type=float, default=2.0)
    ap.add_argument(
        "--no-trace", action="store_true",
        help="disable span recording on this worker (overhead benchmarks)",
    )
    args = ap.parse_args(argv)

    if args.no_trace:
        TRACER.enabled = False
    try:
        state = EngineState(
            args.dir,
            backend=args.backend,
            max_batch=args.max_batch,
            batch_window_ms=args.batch_window_ms,
            device=args.device,
        )
    except Exception as e:
        # launch_server raises this text as WorkerDied; the traceback goes
        # to stderr as well
        print(
            json.dumps(
                {
                    "event": "failed", "pid": os.getpid(), "shard": args.shard,
                    "error": f"{type(e).__name__}: {e}",
                }
            ),
            flush=True,
        )
        raise
    srv = socket.create_server((args.host, args.port), backlog=64)
    host, port = srv.getsockname()[:2]
    print(
        json.dumps(
            {
                "event": "listening", "host": host, "port": port,
                "pid": os.getpid(), "shard": args.shard, "dir": args.dir,
            }
        ),
        flush=True,
    )
    # stdout's job is done (launch_server stops reading after the announce
    # line): point it at stderr so a stray print() later in the process's
    # life can never fill a 64KB supervisor pipe and wedge a serving
    # thread — the same defense subproc.py applies before its frames
    os.dup2(sys.stderr.fileno(), sys.stdout.fileno())
    try:
        while True:
            conn, _addr = srv.accept()
            threading.Thread(
                target=_serve_conn,
                args=(conn, state, args.shard),
                name="shard-server-conn",
                daemon=True,
            ).start()
    except KeyboardInterrupt:
        pass
    finally:
        srv.close()
        state.close()
    return 0


def launch_server(
    shard_dir: str,
    *,
    shard: int = 0,
    backend: str = "torch",
    max_batch: int = 64,
    batch_window_ms: float = 2.0,
    host: str = "127.0.0.1",
    port: int = 0,
    ready_timeout: float = 300.0,
    device: str = "cuda",
) -> tuple[subprocess.Popen, str]:
    """Spawn a shard server on this machine; return ``(proc, "host:port")``.

    Blocks until the server announces it is listening (engine loaded, port
    bound) or ``ready_timeout`` elapses — a dead-on-arrival server raises
    the typed :class:`~repro_torch.cluster.workers.base.WorkerDied` here
    instead of as a connect failure later, carrying the server's own error
    when it announced one (a ``cuda`` server on a host without CUDA).  The
    caller owns ``proc`` (terminate it to stop the server); tests,
    benchmarks, and ``ClusterService.from_tree(transport="remote")`` all go
    through this.
    """
    from .process import _pythonpath_for_child

    env = dict(os.environ, PYTHONPATH=_pythonpath_for_child())
    proc = subprocess.Popen(
        [
            sys.executable, "-m", "repro_torch.cluster.workers.server",
            "--dir", os.fspath(shard_dir),
            "--shard", str(int(shard)),
            "--backend", backend,
            "--max-batch", str(int(max_batch)),
            "--batch-window-ms", repr(float(batch_window_ms)),
            "--device", str(device),
            "--host", host,
            "--port", str(int(port)),
        ],
        stdout=subprocess.PIPE,
        env=env,  # stderr inherited: server tracebacks stay visible
    )
    box: dict = {}

    def _scan() -> None:
        # scan past any stray import-time stdout chatter for the one
        # announce line; EOF (child died) leaves the box empty
        for line in proc.stdout:
            try:
                info = json.loads(line)
            except ValueError:
                continue
            if isinstance(info, dict) and info.get("event") in (
                "listening", "failed"
            ):
                box["info"] = info
                return

    t = threading.Thread(target=_scan, daemon=True)
    t.start()
    t.join(ready_timeout)
    info = box.get("info")
    if info is None or info["event"] == "failed":
        proc.kill()
        proc.wait(5.0)
        raise WorkerDied(
            shard,
            f"shard server for {shard_dir} did not announce within "
            f"{ready_timeout}s"
            if info is None
            else f"shard server for {shard_dir} failed to start: {info.get('error')}",
        )
    return proc, f"{info['host']}:{info['port']}"


def launch_cluster_servers(
    path: str,
    manifest: dict | None = None,
    *,
    backends: str | list[str] = "torch",
    max_batch: int = 64,
    batch_window_ms: float = 2.0,
    host: str = "127.0.0.1",
    ready_timeout: float = 300.0,
    device: str = "cuda",
) -> tuple[list[subprocess.Popen], list[str]]:
    """One local server per shard of the cluster at ``path``, in parallel.

    Each :func:`launch_server` call blocks on its server's engine load, so
    launching serially would cost the *sum* of N cold starts instead of
    the max — tests, benchmarks, examples, and
    ``ClusterService.from_tree(transport="remote")`` all share this
    helper.  Returns ``(procs, endpoints)`` in shard order; on failure
    every server already launched is killed before the error propagates.
    """
    if manifest is None:
        from repro_torch.core.io import load_cluster_manifest

        manifest = load_cluster_manifest(path)
    n = len(manifest["shards"])
    per_be = [backends] * n if isinstance(backends, str) else list(backends)
    procs: list[subprocess.Popen] = []

    def _one(i: int) -> str:
        proc, ep = launch_server(
            os.path.join(path, manifest["shards"][i]["dir"]),
            shard=i,
            backend=per_be[i],
            max_batch=max_batch,
            batch_window_ms=batch_window_ms,
            host=host,
            ready_timeout=ready_timeout,
            device=device,
        )
        procs.append(proc)  # list.append is atomic: safe across launches
        return ep

    try:
        with ThreadPoolExecutor(max_workers=n) as ex:
            endpoints = list(ex.map(_one, range(n)))
    except BaseException:
        # the executor's __exit__ waited for every in-flight launch, so
        # procs holds all survivors of the failed batch
        for p in procs:
            p.kill()
        raise
    return procs, endpoints


if __name__ == "__main__":
    sys.exit(main())
