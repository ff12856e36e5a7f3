"""The port's HTTP gateway and rebalancer on the card: every answer over HTTP
equals the scalar backend's, and every shard's drain reaches its kernel.

A 30-release corpus in 4 shards on ``cuda``: an in-process ``Gateway`` over
the thread transport with ``backends="fused"`` (the fused_search kernel, the
edge cache, every route, then a live split 4 -> 5 through
``repartition_publish``); a gateway over 4 shard servers with ``"chained"``
(the searchsorted kernel) whose shard 0 ``move_shard`` moves to a new
server; and a gateway child (``launch_gateway``) over shard processes.  A
gateway child told ``cuda`` that sees no card fails typed, at once.

Runs only where a CUDA device is present; on a host without one every test
here skips.  Imports nothing of the JAX package:

    PYTHONPATH=src python -m pytest -q tests/test_torch_gateway_cuda.py
"""
import http.client
import json
import shutil
import signal
import time

import numpy as np
import pytest
import torch

from repro_torch.cluster import (
    ClusterService,
    PlacementPlan,
    WorkerDied,
    build_cluster,
    move_shard,
    repartition_publish,
)
from repro_torch.cluster.workers.server import launch_cluster_servers
from repro_torch.core import KeywordSearchEngine
from repro_torch.data import QUERIES, generate_discogs_tree
from repro_torch.gateway import Gateway, launch_gateway
from repro_torch.kernels import fused_search

N_RELEASES = 30
QUERY_SET = [kws for _, kws in QUERIES.values()] + [
    ["releases"], ["release"], ["uk", "japan"], ["img-3.jpg", "vinyl"], ["vinyl"],
]
CASES = [(i, sem) for i in range(len(QUERY_SET)) for sem in ("slca", "elca")]
ROUTES = ("/healthz", "/stats", "/metrics", "/debug/slow", "/debug/heat")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the gateway's shards search with kernels "
                    "that have no CPU mode")
    return "cuda"


@pytest.fixture(scope="module")
def corpus():
    return generate_discogs_tree(n_releases=N_RELEASES, seed=5)


@pytest.fixture(scope="module")
def expected(corpus, cuda):
    mono = KeywordSearchEngine(corpus, device=cuda)
    return {(i, sem): mono.query(QUERY_SET[i], semantics=sem, backend="scalar")
            for i, sem in CASES}


@pytest.fixture(scope="module")
def artifact(corpus, cuda, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cluster") / "c4")
    build_cluster(corpus, 4, path, device=cuda)
    return path


@pytest.fixture()
def copy_of(artifact, tmp_path):
    """A private copy of the 4-shard artifact (a publish or a move rewrites
    its manifest)."""
    path = str(tmp_path / "c4")
    shutil.copytree(artifact, path)
    return path


class Client:
    def __init__(self, endpoint: str):
        host, port = endpoint.rsplit(":", 1)
        self.conn = http.client.HTTPConnection(host, int(port), timeout=120)

    def request(self, method, path, body=None):
        self.conn.request(method, path, body=None if body is None else json.dumps(body))
        resp = self.conn.getresponse()
        return resp.status, resp.read()

    def query_all(self, expected, cached=None):
        for i, sem in CASES:
            status, raw = self.request(
                "POST", "/query", {"keywords": QUERY_SET[i], "semantics": sem})
            assert status == 200, raw
            obj = json.loads(raw)
            np.testing.assert_array_equal(np.asarray(obj["ids"], dtype=np.int64),
                                          expected[(i, sem)],
                                          err_msg=f"{QUERY_SET[i]} {sem}")
            if cached is not None:
                assert obj["cached"] is cached, (QUERY_SET[i], sem)

    def heat(self) -> dict:
        status, raw = self.request("GET", "/debug/heat")
        assert status == 200
        return json.loads(raw)


def test_gateway_fused_in_process_and_split(copy_of, corpus, expected, cuda):
    svc = ClusterService.from_dir(copy_of, transport="thread", backends="fused",
                                  batch_window_ms=1.0, device=cuda)
    with Gateway(svc, own_service=True).start() as gw:
        client = Client(gw.endpoint)
        torch.cuda.synchronize()
        fused_search.LAUNCHES = 0
        client.query_all(expected, cached=False)
        torch.cuda.synchronize()
        assert fused_search.LAUNCHES > 0
        client.query_all(expected, cached=True)
        for route in ROUTES:
            assert client.request("GET", route)[0] == 200, route
        heat = client.heat()
        assert "proposal" in heat and "proposal_error" not in heat
        m = repartition_publish(copy_of, corpus, PlacementPlan((0, 4, 9, 15, 22, 30)),
                                service=svc, device=cuda)
        assert m["num_shards"] == 5 and svc.num_shards == 5
        health = json.loads(client.request("GET", "/healthz")[1])
        assert (health["layout_epoch"], health["shards"]) == (1, 5)
        launched = fused_search.LAUNCHES
        client.query_all(expected, cached=False)
        torch.cuda.synchronize()
        assert fused_search.LAUNCHES > launched
        assert svc.stats().summary()["fused_fallbacks"] == 0


def test_gateway_chained_remote_with_move(copy_of, expected, cuda):
    procs, endpoints = launch_cluster_servers(copy_of, backends="chained", device=cuda)
    try:
        svc = ClusterService.from_dir(copy_of, transport="remote", backends="chained",
                                      endpoints=endpoints, batch_window_ms=1.0,
                                      device=cuda)
        with Gateway(svc, own_service=True).start() as gw:
            client = Client(gw.endpoint)
            client.query_all(expected, cached=False)
            proc, endpoint, m = move_shard(copy_of, 0, service=svc, backend="chained",
                                           device=cuda)
            procs.append(proc)
            assert m["shards"][0]["endpoint"] == endpoint
            assert svc.pool.locality[0] == "remote"
            client.query_all(expected, cached=True)  # same artifact, same stamp
            gw.cache.clear()
            before = svc.workers[0].stats().data["kernel_launches_searchsorted"]
            client.query_all(expected, cached=False)
            after = svc.workers[0].stats().data["kernel_launches_searchsorted"]
            assert after > before
    finally:
        for p in procs:
            p.kill()
            p.wait(10)


def test_gateway_child_over_shard_processes(artifact, expected, cuda):
    proc, endpoint = launch_gateway(artifact, transport="process", backend="fused",
                                    device=cuda)
    try:
        client = Client(endpoint)
        before = [r["kernel_launches"]["fused_search"] for r in client.heat()["shards"]]
        client.query_all(expected, cached=False)
        after = [r["kernel_launches"]["fused_search"] for r in client.heat()["shards"]]
        launched = [a - b for a, b in zip(after, before)]
        assert min(launched) > 0, launched
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            assert proc.wait(60) == 0
        finally:
            proc.kill()


def test_gateway_child_without_a_card_fails_typed(artifact, cuda, monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    t0 = time.perf_counter()
    with pytest.raises(WorkerDied, match="CUDA is not available"):
        launch_gateway(artifact, transport="thread", backend="fused", device=cuda)
    assert time.perf_counter() - t0 < 60.0
