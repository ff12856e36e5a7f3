"""Port HTTP gateway (device="cpu") == the reference gateway, request for request.

Both packages generate the same corpus from the same seed and serve it from
a 2-shard ``ClusterService`` behind their own ``Gateway``: the port's with
``backends="torch"``, the reference's with ``"jax"``.  The same requests
must give the same ids, generation vectors and ``cached`` flags, the same
``stats`` keys, the same error statuses and messages (the port's backend
names aside), equal ``/healthz`` bodies, the same ``/stats`` structure and
``/metrics`` families, and the same span names and attribute keys under
``/debug/slow`` (on the fused backends too, where the port adds ``route``).  No
tolerance anywhere: ids are integers.

The edge cache must drop the touched entries on a ``rolling_publish``
(generation bump), every entry on a ``repartition_publish`` (epoch bump)
and nothing on a ``move_shard`` (same artifact, same generation).  A
gateway child asked for ``cuda`` without a card fails typed at once.
"""
import http.client
import json
import os
import signal
import time

import numpy as np
import pytest

from repro.cluster import ClusterService as RefClusterService
from repro.data import generate_discogs_tree as ref_generate
from repro.gateway import EdgeCache as RefEdgeCache
from repro.gateway import Gateway as RefGateway
from repro_torch.api import validate_backend
from repro_torch.cluster import (
    ClusterService,
    PlacementPlan,
    WorkerDied,
    build_cluster,
    move_shard,
    repartition_publish,
    rolling_publish,
)
from repro_torch.core import KeywordSearchEngine
from repro_torch.data import QUERIES, generate_discogs_tree
from repro_torch.gateway import EdgeCache, Gateway, launch_gateway

N_RELEASES = 16
SEMS = ("slca", "elca")
# tests/test_gateway.py's set: four paper queries, a single-shard fanout,
# a root-only keyword and an unknown one
SMOKE_QUERIES = [kws for _, kws in QUERIES.values()][:4] + [
    ["img-3.jpg", "vinyl"],
    ["releases"],
    ["zzz-not-a-word"],
]


@pytest.fixture(scope="module")
def corpus():
    return generate_discogs_tree(n_releases=N_RELEASES, seed=5)


@pytest.fixture(scope="module")
def ref_corpus():
    return ref_generate(n_releases=N_RELEASES, seed=5)


@pytest.fixture(scope="module")
def mono(corpus):
    return KeywordSearchEngine(corpus, device="cpu")


@pytest.fixture()
def pair(corpus, ref_corpus):
    """(port gateway, reference gateway), each over its own 2-shard cluster."""
    port = Gateway(
        ClusterService.from_tree(corpus, 2, batch_window_ms=0.5, device="cpu"),
        own_service=True,
    ).start()
    ref = RefGateway(
        RefClusterService.from_tree(
            ref_corpus, 2, batch_window_ms=0.5, backends="jax"
        ),
        own_service=True,
    ).start()
    try:
        yield port, ref
    finally:
        port.close()
        ref.close()


def _req(gw, method, path, body=None, raw=None):
    """(status, parsed JSON or text) of one request on a fresh connection."""
    conn = http.client.HTTPConnection(gw.host, gw.port, timeout=60)
    try:
        payload = raw if raw is not None else (
            None if body is None else json.dumps(body)
        )
        conn.request(method, path, body=payload)
        resp = conn.getresponse()
        text = resp.read().decode()
    finally:
        conn.close()
    try:
        return resp.status, json.loads(text)
    except ValueError:
        return resp.status, text


def _structure(obj):
    """Nested keys and value types, values left out."""
    if isinstance(obj, dict):
        return {k: _structure(v) for k, v in obj.items()}
    return type(obj).__name__


def _span_names(tree) -> list[str]:
    out = []
    for node in tree:
        out.append(node["name"])
        out += _span_names(node.get("children", []))
    return sorted(out)


def _span_keys(tree, extra=frozenset()) -> list[tuple]:
    """(name, sorted attribute keys) of every span, ``extra`` keys left out."""
    out = []
    for node in tree:
        keys = set(node.get("attrs", {})) - set(extra)
        out.append((node["name"], tuple(sorted(keys))))
        out += _span_keys(node.get("children", []), extra)
    return sorted(out)


def _debug_slow_trees(pair, keywords) -> list:
    """The span tree of one traced request on each gateway of ``pair``."""
    trees = []
    for gw in pair:
        _, out = _req(gw, "POST", "/query", {"keywords": keywords})
        status, slow = _req(gw, "GET", "/debug/slow?n=10")
        assert status == 200
        (entry,) = [e for e in slow["slowest"] if e["trace_id"] == out["trace_id"]]
        trees.append(entry["spans"])
    return trees


def _families(text: str) -> list[str]:
    return sorted(
        line.split()[2] for line in text.splitlines() if line.startswith("# TYPE")
    )


# --------------------------------------------------------------------------- #
# Round trips against the reference
# --------------------------------------------------------------------------- #


def test_http_answers_equal_reference(pair, mono):
    port, ref = pair
    for kws in SMOKE_QUERIES:
        for sem in SEMS:
            want = mono.query(kws, semantics=sem, backend="scalar")
            for _repeat in range(2):  # the second is an edge-cache hit
                body = {"keywords": kws, "semantics": sem}
                (ps, p), (rs, r) = _req(port, "POST", "/query", body), _req(
                    ref, "POST", "/query", body
                )
                assert ps == rs == 200, (p, r)
                assert p["ids"] == r["ids"], (kws, sem)
                np.testing.assert_array_equal(np.asarray(p["ids"]), want)
                assert all(type(i) is int for i in p["ids"])
                assert p["generations"] == r["generations"] == [0, 0]
                assert p["cached"] is r["cached"] is bool(_repeat)
                assert set(p["stats"]) == set(r["stats"]) == {"latency_ms"}
                assert set(p) == set(r)
    # the string form shares the list form's cache entry in both
    body = {"keywords": " ".join(SMOKE_QUERIES[0])}
    (_, p), (_, r) = _req(port, "POST", "/query", body), _req(
        ref, "POST", "/query", body
    )
    assert p["ids"] == r["ids"] and p["cached"] is r["cached"] is True


@pytest.mark.parametrize(
    "raw",
    [
        b"{not json",
        json.dumps({"kw": "x"}).encode(),
        json.dumps({"keywords": "x", "semantics": "no"}).encode(),
        json.dumps([1]).encode(),
        json.dumps({"keywords": 5}).encode(),
        json.dumps({"keywords": "x", "index": "tree"}).encode(),
    ],
    ids=["json", "unknown-field", "semantics", "not-object", "keywords-type",
         "index"],
)
def test_http_error_paths_equal_reference(pair, raw):
    port, ref = pair
    got = _req(port, "POST", "/query", raw=raw)
    want = _req(ref, "POST", "/query", raw=raw)
    assert got == want
    assert got[0] == 400


@pytest.mark.parametrize(
    "method,path",
    [("GET", "/nope"), ("GET", "/query"), ("POST", "/healthz"),
     ("POST", "/stats"), ("POST", "/debug/heat")],
)
def test_http_404_405_equal_reference(pair, method, path):
    port, ref = pair
    got = _req(port, method, path)
    assert got == _req(ref, method, path)
    assert got[0] in (404, 405)
    assert port.counters["errors"] == ref.counters["errors"] == 1


@pytest.mark.parametrize("name", ["jax", "xla", "pallas", "cuda"])
def test_http_backend_names_are_the_ports(pair, name):
    """A backend name outside the port's is a 400 with the port's own
    message (the reference accepts its own ``jax``, ``xla`` and ``pallas``)."""
    port, _ref = pair
    status, obj = _req(port, "POST", "/query", {"keywords": "x", "backend": name})
    assert status == 400
    with pytest.raises(ValueError) as exc:
        validate_backend(name)
    assert obj["error"] == str(exc.value)


@pytest.mark.parametrize("backend", ["fused", "chained"])
def test_http_port_backends_accepted(corpus, mono, backend):
    """A body naming the drain's own backend is served (the kernels' plain
    versions here); naming another is the router's mismatch, a 400."""
    svc = ClusterService.from_tree(
        corpus, 2, backends=backend, batch_window_ms=0.5, device="cpu"
    )
    with Gateway(svc, own_service=True).start() as gw:
        for kws in SMOKE_QUERIES[:3]:
            status, obj = _req(
                gw, "POST", "/query",
                {"keywords": kws, "semantics": "elca", "backend": backend},
            )
            assert status == 200, obj
            np.testing.assert_array_equal(
                np.asarray(obj["ids"]),
                mono.query(kws, semantics="elca", backend="scalar"),
            )
        status, obj = _req(
            gw, "POST", "/query", {"keywords": "vinyl", "backend": "torch"}
        )
        assert status == 400 and "backend mismatch" in obj["error"]


def test_http_introspection_equal_reference(pair):
    port, ref = pair
    for gw in pair:
        for kws in (["vinyl", "reissue"], ["vinyl"], ["vinyl"]):
            assert _req(gw, "POST", "/query", {"keywords": kws})[0] == 200
    # /healthz: equal bodies
    assert _req(port, "GET", "/healthz") == _req(ref, "GET", "/healthz")
    # /stats: the same keys and value types at every level, equal counters
    (ps, p), (rs, r) = _req(port, "GET", "/stats"), _req(ref, "GET", "/stats")
    assert ps == rs == 200
    assert _structure(p) == _structure(r)
    assert p["gateway"] == r["gateway"]
    for key in ("queries", "fanout_submits", "coalesced", "num_shards"):
        assert p["service"][key] == r["service"][key], key
    # /metrics: the same metric families
    (ps, p), (rs, r) = _req(port, "GET", "/metrics"), _req(ref, "GET", "/metrics")
    assert ps == rs == 200
    assert _families(p) == _families(r)
    assert "xks_gateway_request_latency_ms" in _families(p)


def test_http_debug_slow_span_names_equal_reference(pair):
    """One traced request: the same span names in both trees, and each span
    with the same attribute keys."""
    trees = _debug_slow_trees(pair, ["vinyl", "reissue"])
    assert _span_names(trees[0]) == _span_names(trees[1])
    assert "router.submit" in _span_names(trees[0])
    assert _span_keys(trees[0]) == _span_keys(trees[1])


def test_http_debug_slow_fused_span_attrs_equal_reference(corpus, ref_corpus):
    """Both gateways on ``backends="fused"``: the ``kernel.fused_round``
    spans carry the reference's roofline byte attributes (the port adds the
    kernel's ``route``), and every other span the same keys."""
    port = Gateway(ClusterService.from_tree(
        corpus, 2, batch_window_ms=0.5, backends="fused", device="cpu"), own_service=True)
    ref = RefGateway(RefClusterService.from_tree(
        ref_corpus, 2, batch_window_ms=0.5, backends="fused"), own_service=True)
    with port.start(), ref.start():
        trees = _debug_slow_trees((port, ref), ["vinyl", "reissue"])
    assert "kernel.fused_round" in _span_names(trees[0])
    assert _span_names(trees[0]) == _span_names(trees[1])
    assert _span_keys(trees[0], extra={"route"}) == _span_keys(trees[1])
    fused = [keys for name, keys in _span_keys(trees[0]) if name == "kernel.fused_round"]
    assert all({"route", "fused_bytes", "chained_bytes", "bytes_ratio"} <= set(k)
               for k in fused)


def test_http_debug_heat_carries_proposal(pair):
    port, _ref = pair
    for _ in range(4):
        _req(port, "POST", "/query", {"keywords": "vinyl"})
    status, heat = _req(port, "GET", "/debug/heat?top=5")
    assert status == 200
    assert "proposal_error" not in heat
    assert set(heat["proposal"]) == {"actions", "plan"}
    assert heat["layout"]["num_shards"] == 2


def test_http_debug_heat_planner_failure_equal_reference(pair, monkeypatch):
    """A planner that fails on a report (here a KeyError, as a layout
    converging under it could give) leaves /debug/heat a 200 carrying
    ``proposal_error``, on both gateways."""
    import repro.cluster.rebalance as ref_rebalance
    import repro_torch.gateway.http as port_http

    def broken(report):
        raise KeyError("doc_bounds")

    monkeypatch.setattr(port_http, "plan_rebalance", broken)
    monkeypatch.setattr(ref_rebalance, "plan_rebalance", broken)
    got = [_req(gw, "GET", "/debug/heat?top=5") for gw in pair]
    assert [status for status, _ in got] == [200, 200]
    assert [(h.get("proposal_error"), "proposal" in h) for _, h in got] == [
        ("'doc_bounds'", False)
    ] * 2


def test_drain_kernels_load_from_one_place(monkeypatch):
    """The serve layer alone maps a drain to the kernel it launches; the
    gateway's warm-up is that same function."""
    from repro_torch.gateway import server as gateway_server
    from repro_torch.kernels import _build, fused_search, searchsorted
    from repro_torch.serve import service

    loaded = []
    monkeypatch.setattr(_build, "load", loaded.append)
    got = {}
    for backend in ("scalar", "torch", "chained", "fused"):
        loaded.clear()
        service.load_kernels(backend)
        got[backend] = list(loaded)
    assert got == {"scalar": [], "torch": [], "chained": [searchsorted._SOURCE],
                   "fused": [fused_search._SOURCE]}
    assert gateway_server.load_kernels is service.load_kernels


def test_edge_cache_equal_reference():
    """The same operations on both caches give the same answers and counters."""
    ops = [
        ("put", "a", 1, (0,), (0, 0), 0), ("get", "a", (0, 0), 0),
        ("get", "a", (0, 5), 0), ("get", "a", (1, 5), 0),
        ("put", "b", 2, (0,), (0,), 0), ("get", "b", (0, 0), 0),
        ("put", "e", 5, (0,), (0, 0), 1), ("get", "e", (0, 0), 1),
        ("get", "e", (0, 0), 2), ("put", "x", 1, (), (0,), 0),
        ("put", "y", 2, (), (0,), 0), ("put", "z", 3, (), (0,), 0),
        ("get", "x", (0,), 0), ("put", "w", 4, (3,), (0, 0), 0),
        ("get", "w", (0, 0), 0), ("get", "z", (0,), 0),
    ]
    caches = [EdgeCache(max_entries=2), RefEdgeCache(max_entries=2)]
    for op, *args in ops:
        got = [getattr(c, op)(*args) for c in caches]
        assert got[0] == got[1], (op, args)
        assert len(caches[0]) == len(caches[1])
    assert caches[0].snapshot() == caches[1].snapshot()
    for cls in (EdgeCache, RefEdgeCache):
        with pytest.raises(ValueError, match="max_entries"):
            cls(0)


# --------------------------------------------------------------------------- #
# Edge-cache coherence under the rebalancer and the republisher
# --------------------------------------------------------------------------- #


def test_cache_invalidated_by_rolling_publish(tmp_path, corpus, mono):
    path = str(tmp_path / "cluster")
    build_cluster(corpus, 2, path, device="cpu")
    svc = ClusterService.from_dir(path, batch_window_ms=0.5, device="cpu")
    with Gateway(svc, own_service=True).start() as gw:
        body = {"keywords": "vinyl reissue"}
        _, r1 = _req(gw, "POST", "/query", body)
        _, r2 = _req(gw, "POST", "/query", body)
        assert (r1["cached"], r2["cached"]) == (False, True)
        rolling_publish(path, corpus, service=svc, device="cpu")
        assert _req(gw, "GET", "/healthz")[1]["generations"] == [1, 1]
        _, r3 = _req(gw, "POST", "/query", body)
        assert r3["cached"] is False and r3["generations"] == [1, 1]
        assert r3["ids"] == r1["ids"]
        assert _req(gw, "POST", "/query", body)[1]["cached"] is True
        assert gw.cache.snapshot()["invalidations"] >= 1
        np.testing.assert_array_equal(
            np.asarray(r3["ids"]), mono.query("vinyl reissue", backend="scalar")
        )


def test_cache_invalidated_by_repartition(tmp_path, corpus, mono):
    """A repartition bumps the layout epoch and resets every generation to 0:
    every entry dies, the 3-shard stamps included."""
    path = str(tmp_path / "cluster")
    build_cluster(corpus, 2, path, device="cpu")
    svc = ClusterService.from_dir(path, batch_window_ms=0.5, device="cpu")
    bodies = [{"keywords": kws, "semantics": "elca"} for kws in SMOKE_QUERIES]
    with Gateway(svc, own_service=True).start() as gw:
        first = [_req(gw, "POST", "/query", b)[1] for b in bodies]
        assert all(_req(gw, "POST", "/query", b)[1]["cached"] for b in bodies)
        for plan in (PlacementPlan((0, 5, 11, N_RELEASES)),
                     PlacementPlan((0, 4, 9, N_RELEASES))):  # 3 -> 3 shards
            m = repartition_publish(path, corpus, plan, service=svc, device="cpu")
            _, health = _req(gw, "GET", "/healthz")
            assert health["layout_epoch"] == m["layout_epoch"]
            assert health["shards"] == 3 and health["generations"] == [0, 0, 0]
            again = [_req(gw, "POST", "/query", b)[1] for b in bodies]
            assert [r["cached"] for r in again] == [False] * len(bodies)
            assert [r["ids"] for r in again] == [r["ids"] for r in first]
            assert all(_req(gw, "POST", "/query", b)[1]["cached"] for b in bodies)
        for b, r in zip(bodies, first):
            np.testing.assert_array_equal(
                np.asarray(r["ids"]),
                mono.query(b["keywords"], semantics="elca", backend="scalar"),
            )


def test_cache_survives_move_shard(tmp_path, corpus, mono):
    """A move serves the same artifact at the same generation: entries stay."""
    path = str(tmp_path / "cluster")
    build_cluster(corpus, 2, path, device="cpu")
    svc = ClusterService.from_dir(
        path, transport="remote", batch_window_ms=0.5, device="cpu"
    )
    proc = None
    bodies = [{"keywords": kws} for kws in SMOKE_QUERIES]
    with Gateway(svc, own_service=True).start() as gw:
        try:
            first = [_req(gw, "POST", "/query", b)[1] for b in bodies]
            proc, endpoint, m = move_shard(path, 0, service=svc, device="cpu")
            assert m["shards"][0]["endpoint"] == endpoint
            assert svc.pool.locality == ["remote", "process"]
            after = [_req(gw, "POST", "/query", b)[1] for b in bodies]
            assert [r["cached"] for r in after] == [True] * len(bodies)
            assert [r["ids"] for r in after] == [r["ids"] for r in first]
            assert gw.cache.snapshot()["invalidations"] == 0
            # the moved shard answers new queries
            _, fresh = _req(gw, "POST", "/query",
                            {"keywords": SMOKE_QUERIES[0], "semantics": "elca"})
            assert fresh["cached"] is False
            np.testing.assert_array_equal(
                np.asarray(fresh["ids"]),
                mono.query(SMOKE_QUERIES[0], semantics="elca", backend="scalar"),
            )
        finally:
            if proc is not None:
                proc.kill()
                proc.wait(10)


# --------------------------------------------------------------------------- #
# The supervised child (python -m repro_torch.gateway)
# --------------------------------------------------------------------------- #


def _shard_children(marker: str) -> list[int]:
    """Pids of the shard processes serving a cluster dir named ``marker``."""
    pids = []
    for entry in os.listdir("/proc"):
        try:
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode()
        except (OSError, ValueError):
            continue
        if "repro_torch.cluster.workers" in cmd and marker in cmd:
            pids.append(int(entry))
    return pids


@pytest.mark.parametrize("transport", ["thread", "process"])
def test_launch_gateway_cpu(tmp_path, corpus, mono, transport):
    """A gateway child answers as the mono engine; over the process
    transport ``/debug/heat`` carries each shard process's own kernel
    launches, and SIGINT stops the child and its shard processes."""
    path = str(tmp_path / f"cluster-{transport}")
    build_cluster(corpus, 2, path, device="cpu")
    proc, ep = launch_gateway(path, transport=transport, device="cpu")
    host, port = ep.rsplit(":", 1)
    try:
        conn = http.client.HTTPConnection(host, int(port), timeout=120)
        try:
            for kws in SMOKE_QUERIES:
                conn.request("POST", "/query", body=json.dumps({"keywords": kws}))
                resp = conn.getresponse()
                obj = json.loads(resp.read().decode())
                assert resp.status == 200, obj
                np.testing.assert_array_equal(
                    np.asarray(obj["ids"]), mono.query(kws, backend="scalar")
                )
            conn.request("GET", "/debug/heat")
            rows = json.loads(conn.getresponse().read().decode())["shards"]
        finally:
            conn.close()
        kernels = {"fused_search", "searchsorted", "intersect", "elca_segsum"}
        want = kernels if transport == "process" else set()
        assert [set(r["kernel_launches"]) for r in rows] == [want, want]
        # the plain versions run here: no launch is counted
        assert all(n == 0 for r in rows for n in r["kernel_launches"].values())
        assert len(_shard_children(os.path.basename(path))) == (
            2 if transport == "process" else 0)
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            assert proc.wait(30) == 0
        finally:
            proc.kill()
    deadline = time.monotonic() + 30
    while _shard_children(os.path.basename(path)) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert _shard_children(os.path.basename(path)) == []


def test_launch_gateway_defaults_to_cuda(tmp_path, corpus, monkeypatch):
    """Without a card the child announces its failure and the parent raises
    it at once, not after ``ready_timeout``; nothing serves on the CPU.
    The reference's backend names are refused before any child starts."""
    path = str(tmp_path / "cluster")
    build_cluster(corpus, 1, path, device="cpu")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    t0 = time.perf_counter()
    with pytest.raises(WorkerDied, match="CUDA is not available"):
        launch_gateway(path, ready_timeout=300.0)
    assert time.perf_counter() - t0 < 60.0
    with pytest.raises(ValueError, match="backend must be one of"):
        launch_gateway(path, backend="jax", device="cpu")
