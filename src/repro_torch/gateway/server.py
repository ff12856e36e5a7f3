"""Gateway CLI entrypoint + supervised local launcher.

    python -m repro_torch.gateway --dir CLUSTER_DIR --transport remote --port 8080

Builds a :class:`~repro_torch.cluster.router.ClusterService` over the
published cluster at ``--dir`` (endpoints — including per-shard replica
lists — come from the v4 manifest) and serves the HTTP front door until
killed.  Local shards search on ``--device`` (default ``cuda``); on the card
the kernels that the backend's shard drains launch are loaded first, built
if they are missing, so no request pays a build inside its gather deadline.
On startup it prints one JSON announce line
(``{"event": "listening", "host": ..., "port": ...}``) to stdout, same
contract as the shard server, so :func:`launch_gateway` and CI
supervisors can discover an ephemeral port — or
``{"event": "failed", "error": ...}`` when the device cannot be opened or
the cluster cannot be loaded, and then it exits: nothing serves on the CPU
unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading

from repro_torch.api import resolve_device, validate_backend
from repro_torch.cluster.router import ClusterService
from repro_torch.cluster.workers.base import WorkerDied
from repro_torch.serve.service import load_kernels

from .http import Gateway


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", required=True, help="published cluster artifact")
    ap.add_argument(
        "--transport", default="thread", choices=("thread", "process", "remote")
    )
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0, help="0 = ephemeral")
    ap.add_argument("--backend", default="torch")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--batch-window-ms", type=float, default=2.0)
    ap.add_argument("--cache-entries", type=int, default=1024)
    ap.add_argument(
        "--hedge-ms", type=float, default=None,
        help="fixed hedge delay for replicated shards (default: adaptive)",
    )
    args = ap.parse_args(argv)

    pool_kw = {}
    if args.hedge_ms is not None and args.transport in ("process", "remote"):
        pool_kw["hedge_ms"] = args.hedge_ms
    try:
        if resolve_device(args.device).type == "cuda":
            # built here once, so the process and remote transports' shard
            # children on this host find the kernel built
            load_kernels(args.backend)
        service = ClusterService.from_dir(
            args.dir,
            transport=args.transport,
            backends=args.backend,
            max_batch=args.max_batch,
            batch_window_ms=args.batch_window_ms,
            device=args.device,
            **pool_kw,
        )
    except Exception as e:
        # launch_gateway raises this text as WorkerDied; the traceback goes
        # to stderr as well
        print(
            json.dumps(
                {
                    "event": "failed", "pid": os.getpid(),
                    "error": f"{type(e).__name__}: {e}",
                }
            ),
            flush=True,
        )
        raise
    gw = Gateway(
        service,
        host=args.host,
        port=args.port,
        cache_entries=args.cache_entries,
        own_service=True,
    ).start()
    print(
        json.dumps(
            {
                "event": "listening", "host": gw.host, "port": gw.port,
                "pid": os.getpid(), "dir": args.dir,
                "transport": args.transport,
                "shards": service.num_shards,
            }
        ),
        flush=True,
    )
    # announce done: point stdout at stderr so later prints can never fill
    # a supervisor pipe (same defense as the shard server)
    os.dup2(sys.stderr.fileno(), sys.stdout.fileno())
    try:
        gw._thread.join()  # serve until killed
    except KeyboardInterrupt:
        pass
    finally:
        gw.close()
    return 0


def launch_gateway(
    cluster_dir: str,
    *,
    transport: str = "thread",
    host: str = "127.0.0.1",
    port: int = 0,
    backend: str = "torch",
    cache_entries: int = 1024,
    hedge_ms: float | None = None,
    ready_timeout: float = 300.0,
    device: str = "cuda",
) -> tuple[subprocess.Popen, str]:
    """Spawn a gateway process; return ``(proc, "host:port")``.

    Blocks until the announce line (cluster loaded, port bound) or raises
    the typed :class:`~repro_torch.cluster.workers.base.WorkerDied` — the
    same contract as :func:`~repro_torch.cluster.workers.server.launch_server`:
    a child that announces a failure (``cuda`` on a host without CUDA, a
    cluster it cannot load) is raised at once with its own error.  The
    reference's backend names are refused before anything is spawned.  The
    caller owns ``proc``.
    """
    from repro_torch.cluster.workers.process import _pythonpath_for_child

    validate_backend(backend)
    cmd = [
        sys.executable, "-m", "repro_torch.gateway",
        "--dir", os.fspath(cluster_dir),
        "--transport", transport,
        "--host", host,
        "--port", str(int(port)),
        "--backend", backend,
        "--device", str(device),
        "--cache-entries", str(int(cache_entries)),
    ]
    if hedge_ms is not None:
        cmd += ["--hedge-ms", repr(float(hedge_ms))]
    env = dict(os.environ, PYTHONPATH=_pythonpath_for_child())
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, env=env)
    box: dict = {}

    def _scan() -> None:
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
            -1,
            f"gateway for {cluster_dir} did not announce within "
            f"{ready_timeout}s"
            if info is None
            else f"gateway for {cluster_dir} failed to start: {info.get('error')}",
        )
    return proc, f"{info['host']}:{info['port']}"


if __name__ == "__main__":
    sys.exit(main())
