"""Transport-agnostic shard worker layer (the cluster's execution seam).

    router  ->  WorkerPool  ->  ThreadWorker | ProcessWorker | RemoteWorker
                                 (in-process)  (subprocess      (TCP to a
                                                over the mmap'd  standalone
                                                shard artifact)  shard server)

See :mod:`.base` for the Worker protocol, the shared RPC client, and the
architecture story, :mod:`.proto` for the frame protocol (pipe and socket),
:mod:`.subproc` for the worker subprocess entrypoint, :mod:`.server` for
the standalone TCP shard server (+ :func:`~.server.launch_server`), and
:mod:`.pool` for supervision (crash detection, bounded respawn/reconnect,
hot-swap installs).  Every engine-building worker and pool takes ``device``
(``"cuda"`` unless the caller names the CPU).
"""
import importlib

# name -> submodule, loaded on first access (PEP 562): the subprocess
# entrypoint (:mod:`.subproc`) must be importable without torch, so that it
# moves stdout off its RPC pipe before anything heavy loads.
_EXPORTS = {
    **{n: ".base" for n in ("RpcWorker", "Worker", "WorkerDied", "shard_doc_stats")},
    **{
        n: ".pool"
        for n in ("ProcessPool", "RemotePool", "SupervisedPool", "ThreadPool", "WorkerPool")
    },
    "ProcessWorker": ".process",
    "MAX_FRAME_BYTES": ".proto",
    "ProtocolError": ".proto",
    "RemoteWorker": ".remote",
    "ReplicaSet": ".replica",
    "ThreadWorker": ".thread",
}


def __getattr__(name: str):
    try:
        module = _EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    value = getattr(importlib.import_module(module, __name__), name)
    globals()[name] = value
    return value


def __dir__() -> list[str]:
    return sorted(set(globals()) | set(_EXPORTS))


__all__ = sorted(_EXPORTS)
