"""Sharded serving cluster: partitioned DAG indices behind one front door.

    tree = generate_discogs_tree(n_releases=2000)
    build_cluster(tree, num_shards=4, path="/var/idx/cluster")

    with ClusterService.from_dir("/var/idx/cluster", transport="process") as svc:
        fut = svc.submit(["vinyl", "electronic"], semantics="slca")
        print(fut.result())
        print(svc.stats().summary())

Every entry point that builds or loads a shard engine takes ``device``,
``"cuda"`` unless the caller names the CPU; each shard's ``QueryService``
drain reaches the port's kernels (``backends="fused"`` or ``"chained"``).
See :mod:`repro_torch.cluster.partition` for the partitioning/exactness
story, :mod:`repro_torch.cluster.router` for scatter-gather semantics,
:mod:`repro_torch.cluster.workers` for the transport-agnostic worker layer
(thread, process-isolated, and remote shard workers over mmap'd
artifacts — the remote server entrypoint is
``python -m repro_torch.cluster.workers.server``), and
:mod:`repro_torch.cluster.admission` for overload behaviour.  The frame RPC
is the reference package's, byte for byte, so shard servers of either
package can serve one router.
"""
import importlib

# name -> (module, attribute).  Loaded on first access (PEP 562), so that
# ``python -m repro_torch.cluster.workers.subproc`` imports nothing heavy
# (torch, the engine) before the worker has moved stdout off its RPC pipe.
_EXPORTS = {
    "migrate_cluster": ("repro_torch.core.io", "migrate_cluster"),
    **{n: (".admission", n) for n in ("AdmissionController", "Overloaded")},
    **{
        n: (".manifest", n)
        for n in (
            "RoutingTable", "build_cluster", "load_cluster",
            "load_cluster_layout", "manifest_endpoints", "rolling_publish",
            "set_cluster_endpoints", "write_layout_artifacts",
        )
    },
    **{
        n: (".partition", n)
        for n in (
            "ShardSpec", "balanced_bounds", "heat_weighted_bounds",
            "partition_corpus", "shard_tree", "specs_from_bounds",
            "split_doc_ranges",
        )
    },
    **{
        n: (".rebalance", n)
        for n in (
            "Action", "PlacementPlan", "apply_actions", "doc_heat_weights",
            "move_shard", "plan_rebalance", "repartition_publish",
        )
    },
    "ClusterService": (".router", "ClusterService"),
    **{
        n: (".workers", n)
        for n in (
            "ProcessPool", "ProcessWorker", "ProtocolError", "RemotePool",
            "RemoteWorker", "ThreadPool", "ThreadWorker", "Worker",
            "WorkerDied", "WorkerPool",
        )
    },
    # the reference's older name for the in-process shard worker
    "ShardWorker": (".workers", "ThreadWorker"),
}


def __getattr__(name: str):
    try:
        module, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    value = getattr(importlib.import_module(module, __name__), attr)
    globals()[name] = value
    return value


def __dir__() -> list[str]:
    return sorted(set(globals()) | set(_EXPORTS))


__all__ = sorted(_EXPORTS)
