"""ProcessWorker: one spawned subprocess per shard over its mmap'd artifact.

The parent side of the :mod:`~repro_torch.cluster.workers.subproc` RPC — the
pipelined client machinery (request registry, reader thread, typed death)
is the shared :class:`~repro_torch.cluster.workers.base.RpcWorker`; this class
owns the ``Popen`` carrier.  The subprocess loads the shard with
``KeywordSearchEngine.load(mmap=True, device=...)``, so N workers + the
publisher share one page-cache copy of every index page; nothing crosses the
pipe but keyword strings in and result ``.npy`` vectors out.  Each child is a
fresh interpreter (``Popen``, never a fork), so a child on ``cuda`` opens its
own CUDA context; a child asked for ``cuda`` on a host without CUDA exits
with the error from ``resolve_device`` and is reported ``WorkerDied``.

Death is a first-class outcome, not a hang: EOF / a broken pipe / a
nonzero exit fails every in-flight Future with the typed
:class:`~repro_torch.cluster.workers.base.WorkerDied`, subsequent submits raise
it synchronously, and the ``on_death`` callback lets the
:class:`~repro_torch.cluster.workers.pool.ProcessPool` respawn the shard.
"""
from __future__ import annotations

import os
import subprocess
import sys

import repro_torch

from ..partition import ShardSpec
from .base import DEFAULT_OP_TIMEOUT, RpcWorker
from .proto import write_frame


def _pythonpath_for_child() -> str:
    """The child must resolve ``repro_torch`` exactly like this process did
    (built from this package's own location, never the reference's)."""
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(repro_torch.__file__)))
    prev = os.environ.get("PYTHONPATH", "")
    return pkg_root + (os.pathsep + prev if prev else "")


class ProcessWorker(RpcWorker):
    """Worker seam over a per-shard subprocess (spawned immediately).

    Construction is non-blocking: the Popen + reader thread start here, and
    requests written before the child finishes loading simply sit in the
    pipe — callers who want spawn failures surfaced eagerly wait on
    :meth:`~repro_torch.cluster.workers.base.RpcWorker.wait_ready` (the pool
    does, with a timeout).
    """

    transport = "process"

    def __init__(
        self,
        spec: ShardSpec,
        shard_dir: str,
        *,
        backend: str = "torch",
        max_batch: int = 64,
        batch_window_ms: float = 2.0,
        op_timeout: float = DEFAULT_OP_TIMEOUT,
        on_death=None,
        device: str = "cuda",
    ):
        super().__init__(spec, op_timeout=op_timeout, on_death=on_death)
        self.shard_dir = os.fspath(shard_dir)
        self.backend = backend
        self.device = str(device)
        self.max_batch = max_batch
        self.batch_window_ms = batch_window_ms
        self._drained = False
        env = dict(os.environ, PYTHONPATH=_pythonpath_for_child())
        self._proc = subprocess.Popen(
            [
                sys.executable, "-m", "repro_torch.cluster.workers.subproc",
                "--dir", self.shard_dir,
                "--shard", str(spec.index),
                "--backend", backend,
                "--max-batch", str(int(max_batch)),
                "--batch-window-ms", repr(float(batch_window_ms)),
                "--device", self.device,
            ],
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            env=env,  # stderr inherited: worker tracebacks stay visible
        )
        self._rfile = self._proc.stdout
        self._wfile = self._proc.stdin
        self._start_reader(f"shard{spec.index}-rpc-reader")

    # ------------------------------------------------------------------ #
    # Worker protocol (the RPC ops live on RpcWorker)
    # ------------------------------------------------------------------ #
    def drain(self, timeout: float = 30.0) -> None:
        with self._lock:
            if self._drained:
                return
            self._drained = True
        try:
            self._request({"op": "drain"}).result(timeout)
        except Exception:
            pass  # dead worker: its pending Futures already carry WorkerDied

    def close(self, timeout: float = 30.0) -> None:
        with self._lock:
            already = self._closing
            self._closing = True
            if not already and self._dead is None:
                try:
                    write_frame(self._proc.stdin, {"op": "close", "id": -1})
                except (OSError, ValueError):
                    pass  # pipe gone: the child is exiting anyway
        try:
            self._proc.stdin.close()
        except OSError:
            pass
        try:
            self._proc.wait(timeout)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait(5.0)
        self._reader.join(5.0)

    def _death_detail(self, detail: str) -> str:
        return f"{detail} (exit code {self._proc.poll()})"
