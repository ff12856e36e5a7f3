"""Per-shard worker subprocess: a QueryService drain over one mmap'd artifact.

    python -m repro_torch.cluster.workers.subproc --dir SHARD_DIR --shard I \
        --backend fused --device cuda --max-batch 64 --batch-window-ms 2.0

Speaks the :mod:`~repro_torch.cluster.workers.proto` frame protocol on
stdin/stdout.  The serving machinery — engine state and the op drain loop —
is shared with the standalone TCP shard server
(:func:`repro_torch.cluster.workers.server.serve_stream` over
:class:`~repro_torch.cluster.workers.server.EngineState`); this entrypoint is the
single-client pipe flavor: ``drain`` terminally flushes the service (the
parent owns this whole process), ``reload`` is gated off (the ProcessPool
swaps artifacts by spawning a fresh subprocess), and ``close`` or EOF
(the parent died) drains and exits.

``--device`` (default ``cuda``) is where the shard searches: a child asked
for ``cuda`` on a host without CUDA exits with ``resolve_device``'s error
on stderr, so the parent sees ``WorkerDied`` and never a CPU fallback.
Nothing heavy is imported before :func:`main` has moved stdout: the
package ``__init__`` modules above this one load their names lazily, so
``torch``, the CUDA context and any kernel build all start after the dup.

Request pipelining falls out of the architecture: each ``submit`` frame
becomes a ``QueryService.submit`` (which returns immediately) and the reply
is written from the Future's done-callback on the drain thread, so many
queries ride the pipe concurrently, microbatch inside the service, and
complete out of order.
"""
from __future__ import annotations

import argparse
import os
import sys
import threading


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", required=True, help="shard index artifact dir")
    ap.add_argument("--shard", type=int, default=0)
    ap.add_argument("--backend", default="torch")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--batch-window-ms", type=float, default=2.0)
    ap.add_argument(
        "--no-trace", action="store_true",
        help="disable span recording in this worker (overhead benchmarks)",
    )
    args = ap.parse_args(argv)

    # Claim the RPC channel before the heavyweight imports: anything that
    # print()s during torch/CUDA/engine init or a kernel build (warnings,
    # sitecustomize, nvcc) must land on stderr, never inside a frame.
    rpc_out = os.fdopen(os.dup(sys.stdout.fileno()), "wb")
    os.dup2(sys.stderr.fileno(), sys.stdout.fileno())
    rpc_in = os.fdopen(os.dup(sys.stdin.fileno()), "rb")

    from repro_torch.obs import TRACER

    from .proto import write_frame
    from .server import EngineState, serve_stream

    if args.no_trace:
        TRACER.enabled = False
    wlock = threading.Lock()  # replies come from this thread AND the drain

    def reply(header: dict, payload: bytes = b"") -> None:
        with wlock:
            write_frame(rpc_out, header, payload)

    try:
        state = EngineState(
            args.dir,
            backend=args.backend,
            max_batch=args.max_batch,
            batch_window_ms=args.batch_window_ms,
            device=args.device,
        )
    except Exception as e:
        # the parent reports this text in its WorkerDied; the traceback
        # goes to stderr (inherited) as well
        reply({"op": "error", "id": -1, "etype": type(e).__name__, "error": str(e)})
        raise

    reply(
        {
            "op": "ready", "id": -1, "pid": os.getpid(),
            "shard": args.shard, "num_nodes": int(state.engine.tree.num_nodes),
        }
    )
    serve_stream(rpc_in, reply, state, allow_reload=False, drain_closes=True)
    state.close()  # EOF before an explicit drain: flush what we have
    return 0


if __name__ == "__main__":
    sys.exit(main())
