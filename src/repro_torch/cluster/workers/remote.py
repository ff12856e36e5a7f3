"""RemoteWorker: a shard on another host behind the TCP shard server.

The third transport on the :class:`~repro_torch.cluster.workers.base.Worker`
seam.  The byte carrier is a socket to a running
:mod:`~repro_torch.cluster.workers.server`; everything above it — the pipelined
request registry, the response reader thread, typed
:class:`~repro_torch.cluster.workers.base.WorkerDied` on EOF / corrupt framing —
is the shared :class:`~repro_torch.cluster.workers.base.RpcWorker`, identical to
the process transport.  Differences are purely lifecycle:

  * the engine's life is the *server's*, not ours: ``close`` just closes
    this socket (other routers may be connected), and ``drain`` waits out
    our own in-flight requests client-side instead of closing the remote
    service;
  * a dead connection is *reconnected*, not respawned: the supervising
    :class:`~repro_torch.cluster.workers.pool.RemotePool` dials the same endpoint
    again with backoff;
  * artifact reloads go through the server's ``reload`` op (the path names
    a directory on the *server's* host).
"""
from __future__ import annotations

import socket
import time

from ..partition import ShardSpec
from .base import DEFAULT_OP_TIMEOUT, RpcWorker, WorkerDied


def parse_endpoint(endpoint: str) -> tuple[str, int]:
    """``"host:port"`` → ``(host, port)`` (IPv6 hosts may be bracketed)."""
    host, sep, port = endpoint.rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError(f"endpoint must be host:port, got {endpoint!r}")
    return host.strip("[]"), int(port)


class RemoteWorker(RpcWorker):
    """Worker seam over a socket to a standalone shard server.

    Construction dials the endpoint (bounded by ``connect_timeout``) and
    starts the reader thread; the server's per-connection ``ready`` frame
    resolves :meth:`~repro_torch.cluster.workers.base.RpcWorker.wait_ready`.  A
    server that is down raises the typed :class:`WorkerDied` right here —
    the pool turns that into bounded reconnect-with-backoff.
    """

    transport = "remote"

    def __init__(
        self,
        spec: ShardSpec,
        endpoint: str,
        *,
        connect_timeout: float = 30.0,
        op_timeout: float = DEFAULT_OP_TIMEOUT,
        on_death=None,
    ):
        super().__init__(spec, op_timeout=op_timeout, on_death=on_death)
        self.endpoint = endpoint
        host, port = parse_endpoint(endpoint)
        try:
            self._sock = socket.create_connection(
                (host, port), timeout=connect_timeout
            )
        except OSError as e:
            raise WorkerDied(
                spec.index, f"connect to {endpoint} failed: {e}"
            ) from e
        self._sock.settimeout(None)  # blocking reads; death arrives as EOF
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._rfile = self._sock.makefile("rb")
        self._wfile = self._sock.makefile("wb")
        self._start_reader(f"shard{spec.index}-remote-reader")

    # ------------------------------------------------------------------ #
    # Worker protocol (the RPC ops live on RpcWorker)
    # ------------------------------------------------------------------ #
    def reload(self, shard_dir: str, timeout: float | None = None) -> None:
        """Ask the server to hot-swap onto ``shard_dir`` (a server path)."""
        self.call("reload", dir=shard_dir).result(
            self.op_timeout if timeout is None else timeout
        )

    def drain(self, timeout: float = 30.0) -> None:
        """Wait out *our* in-flight requests; the server stays up for its
        other clients, so there is nothing remote to flush."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if not self._pending or self._dead is not None:
                    return
            time.sleep(0.01)

    def close(self, timeout: float = 30.0) -> None:
        """Close this connection; the server (and its engine) live on."""
        with self._lock:
            self._closing = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass  # already dead/closed
        try:
            self._sock.close()
        except OSError:
            pass
        if self._reader is not None:
            self._reader.join(timeout)

    def _death_detail(self, detail: str) -> str:
        return f"{detail} (endpoint {self.endpoint})"
