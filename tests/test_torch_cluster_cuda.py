"""The port's sharded cluster on the card: every shard's drain reaches the
hand-written kernels, and every answer equals the scalar backend's.

``ClusterService`` over 4 shards of a 30-release corpus on ``cuda``, on the
thread, process and remote transports, with ``backends="fused"`` (the
fused_search kernel) and ``"chained"`` (the searchsorted kernel as the
drain's membership step).  A shard child that is told ``cuda`` but sees no
card fails typed and never serves on the CPU.

Runs only where a CUDA device is present; on a host without one every test
here skips.  Imports nothing of the JAX package:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cluster_cuda.py
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro_torch.cluster import ClusterService, WorkerDied, build_cluster
from repro_torch.cluster.manifest import load_cluster_layout
from repro_torch.cluster.workers.server import launch_server
from repro_torch.core import KeywordSearchEngine
from repro_torch.data import QUERIES, generate_discogs_tree
from repro_torch.kernels import fused_search, searchsorted

QUERY_SET = [kws for _, kws in QUERIES.values()] + [
    ["releases"], ["release"], ["uk", "japan"], ["img-3.jpg", "vinyl"], ["vinyl"],
]
KERNEL = {"fused": fused_search, "chained": searchsorted}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cluster's kernels have no CPU mode")
    return "cuda"


@pytest.fixture(scope="module")
def corpus():
    return generate_discogs_tree(n_releases=30, seed=5)


@pytest.fixture(scope="module")
def expected(corpus, cuda):
    mono = KeywordSearchEngine(corpus, device=cuda)
    return {
        (i, sem): mono.query(q, semantics=sem, backend="scalar")
        for i, q in enumerate(QUERY_SET)
        for sem in ("slca", "elca")
    }


@pytest.fixture(scope="module")
def artifact(corpus, cuda, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cluster") / "c4")
    build_cluster(corpus, 4, path, device=cuda)
    return path


@pytest.mark.parametrize("backend", ["fused", "chained"])
@pytest.mark.parametrize("transport", ["thread", "process", "remote"])
def test_cluster_on_card_matches_scalar(artifact, expected, cuda, transport, backend):
    procs, endpoints = [], None
    if transport == "remote":
        from repro_torch.cluster.workers.server import launch_cluster_servers

        procs, endpoints = launch_cluster_servers(artifact, backends=backend, device=cuda)
    kernel = KERNEL[backend]
    try:
        with ClusterService.from_dir(artifact, transport=transport, backends=backend,
                                     endpoints=endpoints, batch_window_ms=1.0,
                                     device=cuda) as svc:
            name = kernel.__name__.rsplit(".", 1)[-1]
            before = [w.stats().data for w in svc.workers]
            torch.cuda.synchronize()
            kernel.LAUNCHES = 0
            for sem in ("slca", "elca"):
                for i, res in enumerate(svc.map(QUERY_SET, semantics=sem)):
                    assert res.dtype == np.int64
                    np.testing.assert_array_equal(
                        res, expected[(i, sem)],
                        err_msg=f"{transport} {backend} {sem} {QUERY_SET[i]}")
            torch.cuda.synchronize()
            launched = kernel.LAUNCHES
            after = [w.stats().data for w in svc.workers]

            def counted(key):
                return [a[key] - b[key] for a, b in zip(after, before)]

            runs = counted("plan_launches_total")
            assert min(runs) > 0, runs
            if transport == "thread":  # the shards' drains run in this process
                launched = [launched]
                runs = [sum(runs)]
            else:  # ... or in their own processes, each counting its own
                assert launched == 0
                launched = counted(f"kernel_launches_{name}")
            assert min(launched) > 0, launched
            # a fused run is one fused_search launch; a chained run launches
            # searchsorted once when its queries have two keywords or more
            if backend == "fused":
                assert launched == runs
            else:
                assert all(k <= r for k, r in zip(launched, runs)), (launched, runs)
            assert svc.stats().summary()["fused_fallbacks"] == 0
    finally:
        for p in procs:
            p.kill()
            p.wait(10)


def test_cuda_shard_without_a_card_fails_typed(artifact, cuda, monkeypatch):
    """A child told ``cuda`` that sees no card exits with resolve_device's
    error: the pool and the server launcher raise WorkerDied with it."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    shard0 = load_cluster_layout(artifact)[2][0][1]
    with ThreadPoolExecutor(2) as ex:
        starts = [
            ex.submit(ClusterService.from_dir, artifact, transport="process",
                      backends="fused", device=cuda),
            ex.submit(launch_server, shard0, shard=0, backend="fused", device=cuda),
        ]
    for fut in starts:
        with pytest.raises(WorkerDied, match="CUDA is not available"):
            fut.result()
