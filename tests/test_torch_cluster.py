"""Port cluster (device="cpu") == the reference cluster == the monolith.

Both packages generate the same corpus from the same seed.  The port's
``ClusterService`` over {1, 2, 4} shards x the thread, process and remote
transports x every port backend must return ids byte-identical to the
reference's ``ClusterService(transport="thread", backends="jax")`` and to
the monolithic scalar engine, on the paper's queries plus the cross-shard /
root-only cases of ``tests/test_cluster.py``, for both semantics; the
generation vector and ``touched()`` must match the reference's too.  Cluster
artifacts built by either package are served by the other, and one router
serves a fleet of a reference shard server and a port shard server.

On the CPU the port's kernels run their plain versions.  The matrix's
clusters are built a few ahead of the case that needs them and closed
behind it (``_Farm``), so child start-up overlaps the previous case.
"""
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from repro.cluster import ClusterService as RefClusterService
from repro.cluster import build_cluster as ref_build_cluster
from repro.cluster.workers.server import launch_server as ref_launch_server
from repro.core import KeywordSearchEngine as RefEngine
from repro.core import NodeSpec as RefNodeSpec
from repro.core import build_tree as ref_build_tree
from repro.data import generate_discogs_tree as ref_generate
from repro_torch.cluster import (
    ClusterService,
    WorkerDied,
    build_cluster,
    rolling_publish,
)
from repro_torch.cluster.workers.server import launch_server
from repro_torch.core import KeywordSearchEngine, NodeSpec, build_tree
from repro_torch.data import QUERIES, generate_discogs_tree

N_RELEASES = 30
SEMS = ("slca", "elca")
EXTRA_QUERIES = [  # tests/test_cluster.py's cross-shard / root-only cases
    ["releases"],
    ["release"],
    ["uk", "japan"],
    ["electronic", "jazz", "reggae"],
    ["img-3.jpg", "vinyl"],
    ["zzz-not-a-word"],
    ["vinyl"],
]
ALL_QUERIES = [kws for _, kws in QUERIES.values()] + EXTRA_QUERIES
SHARDS = (1, 2, 4)
TRANSPORTS = ("thread", "process", "remote")
BACKENDS = ("scalar", "torch", "fused", "chained")
# the stats counters a shard process keeps of its own kernel launches
KERNEL_COUNTERS = [f"kernel_launches_{k}" for k in
                   ("fused_search", "searchsorted", "intersect", "elca_segsum")]
# transport-major, so the farm starts each transport's children together
CASES = [(n, t, b) for t in TRANSPORTS for n in SHARDS for b in BACKENDS]


@pytest.fixture(scope="module")
def corpus():
    return generate_discogs_tree(n_releases=N_RELEASES, seed=5)


@pytest.fixture(scope="module")
def ref_corpus():
    return ref_generate(n_releases=N_RELEASES, seed=5)


@pytest.fixture(scope="module")
def mono(corpus):
    return KeywordSearchEngine(corpus, device="cpu")


@pytest.fixture(scope="module")
def expected(mono):
    return {
        (i, sem): mono.query(q, semantics=sem, backend="scalar")
        for i, q in enumerate(ALL_QUERIES)
        for sem in SEMS
    }


@pytest.fixture(scope="module")
def reference(ref_corpus):
    """Per shard count: the reference's ids, generation vector and touched()."""
    out = {}
    for n in SHARDS:
        with RefClusterService.from_tree(
            ref_corpus, n, transport="thread", backends="jax", batch_window_ms=1.0
        ) as svc:
            out[n] = {
                "ids": {
                    (i, sem): res
                    for sem in SEMS
                    for i, res in enumerate(svc.map(ALL_QUERIES, semantics=sem))
                },
                "generations": svc.generation_vector(),
                "touched": [svc.touched(q) for q in ALL_QUERIES],
            }
    return out


class _Farm:
    """Clusters of the matrix, built ``ahead`` cases in advance on background
    threads and closed in the background once their case is done."""

    def __init__(self, keys, build, ahead: int = 2):
        self._keys = list(keys)
        self._build = build
        self._ahead = ahead
        self._starter = ThreadPoolExecutor(ahead + 1)
        self._closer = ThreadPoolExecutor(4)
        self._futs = {}
        self._closes = []
        self._lock = threading.Lock()

    def get(self, key) -> ClusterService:
        i = self._keys.index(key)
        with self._lock:
            for k in self._keys[i : i + self._ahead + 1]:
                if k not in self._futs:
                    self._futs[k] = self._starter.submit(self._build, *k)
        return self._futs[key].result()

    def done(self, key) -> None:
        fut = self._futs[key]
        if fut.exception() is None:
            self._closes.append(self._closer.submit(fut.result().close))

    def close(self) -> None:
        self._starter.shutdown(wait=True)
        for fut in self._futs.values():  # close() is idempotent
            if fut.exception() is None:
                self._closes.append(self._closer.submit(fut.result().close))
        for c in self._closes:
            c.result()
        self._closer.shutdown(wait=True)


@pytest.fixture(scope="module")
def farm(corpus):
    def build(n, transport, backend):
        return ClusterService.from_tree(
            corpus, n, transport=transport, backends=backend,
            batch_window_ms=1.0, device="cpu",
        )

    f = _Farm(CASES, build)
    yield f
    f.close()


def _same_bytes(got: np.ndarray, want: np.ndarray, msg: str) -> None:
    assert got.dtype == np.int64 and want.dtype == np.int64, msg
    assert got.tobytes() == want.tobytes(), msg


@pytest.mark.parametrize(
    "num_shards,transport,backend", CASES, ids=[f"{n}-{t}-{b}" for n, t, b in CASES]
)
def test_cluster_matches_reference(farm, expected, reference, num_shards,
                                   transport, backend):
    key = (num_shards, transport, backend)
    svc = farm.get(key)
    try:
        assert svc.num_shards == num_shards
        assert svc.pool.transport == transport
        ref = reference[num_shards]
        for sem in SEMS:
            for i, res in enumerate(svc.map(ALL_QUERIES, semantics=sem)):
                msg = f"shards={num_shards} {transport} {backend} {sem} {ALL_QUERIES[i]}"
                _same_bytes(res, ref["ids"][(i, sem)], msg)
                _same_bytes(res, expected[(i, sem)], msg)
        assert svc.generation_vector() == ref["generations"]
        assert [svc.touched(q) for q in ALL_QUERIES] == ref["touched"]
        launches = svc.stats().summary()["plan_launches_total"]
        assert (launches == 0) if backend == "scalar" else (launches > 0)
        if transport != "thread":  # on the CPU every wrapper ran its plain version
            for w in svc.workers:
                data = w.stats().data
                assert [data[k] for k in KERNEL_COUNTERS] == [0] * 4, data
    finally:
        farm.done(key)


def test_reference_artifact_served_by_port(tmp_path, ref_corpus, expected):
    """A cluster built by the reference's build_cluster, served by the
    port's process transport."""
    path = str(tmp_path / "ref-cluster")
    ref_build_cluster(ref_corpus, 2, path)
    with ClusterService.from_dir(
        path, transport="process", backends="fused", batch_window_ms=1.0,
        device="cpu",
    ) as svc:
        for sem in SEMS:
            for i, res in enumerate(svc.map(ALL_QUERIES, semantics=sem)):
                _same_bytes(res, expected[(i, sem)], f"{sem} {ALL_QUERIES[i]}")


def test_port_artifact_served_by_reference(tmp_path, corpus, expected):
    """A cluster built by the port's build_cluster, served by the
    reference's thread transport."""
    path = str(tmp_path / "port-cluster")
    manifest = build_cluster(corpus, 2, path, device="cpu")
    assert manifest["num_shards"] == 2 and manifest["num_docs"] == N_RELEASES
    with RefClusterService.from_dir(path, backends="jax", batch_window_ms=1.0) as svc:
        for sem in SEMS:
            for i, res in enumerate(svc.map(ALL_QUERIES, semantics=sem)):
                _same_bytes(res, expected[(i, sem)], f"{sem} {ALL_QUERIES[i]}")


def test_mixed_fleet_reference_and_port_servers(tmp_path, corpus, expected,
                                                monkeypatch):
    """One port router on the remote transport: shard 0 a reference server
    (jax drain), shard 1 a port server (fused drain, CPU)."""
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    path = str(tmp_path / "fleet")
    manifest = build_cluster(corpus, 2, path, device="cpu")
    dirs = [str(tmp_path / "fleet" / s["dir"]) for s in manifest["shards"]]
    with ThreadPoolExecutor(2) as ex:  # both servers start at once
        launches = [
            ex.submit(ref_launch_server, dirs[0], shard=0, backend="jax",
                      batch_window_ms=1.0),
            ex.submit(launch_server, dirs[1], shard=1, backend="fused",
                      batch_window_ms=1.0, device="cpu"),
        ]
    procs = [f.result()[0] for f in launches if f.exception() is None]
    try:
        (_, ep0), (_, ep1) = (f.result() for f in launches)
        with ClusterService.from_dir(
            path, transport="remote", endpoints=[ep0, ep1], backends="fused",
            batch_window_ms=1.0, device="cpu",
        ) as svc:
            assert svc.pool.locality == ["remote", "remote"]
            for sem in SEMS:
                for i, res in enumerate(svc.map(ALL_QUERIES, semantics=sem)):
                    _same_bytes(res, expected[(i, sem)], f"{sem} {ALL_QUERIES[i]}")
            stats = svc.stats().summary()
            assert stats["queries"] == 2 * len(ALL_QUERIES)
    finally:
        for p in procs:
            p.kill()
            p.wait(10)


def _doc(ns, label, words):
    return ns(label, children=[ns("w", w) for w in words])


ROOT_CASES = [  # tests/test_cluster.py's crafted corpus-root edge cases
    ([("d", "a b"), ("d", "a"), ("d", "b")], ["a", "b"]),
    ([("d", "a b"), ("d", "a")], ["a", "b"]),
    ([("d", "a"), ("d", "b")], ["a", "b"]),
    ([("d", "a"), ("d", "a")], ["a", "b"]),
    ([("d", "a"), ("d", "b"), ("d", "c")], ["a", "b", "c"]),
    ([("d", "a b c"), ("d", "b"), ("d", "c")], ["b", "c"]),
    ([("d", "a"), ("d", "b")], ["root", "a"]),
]


@pytest.mark.parametrize("docs,query", ROOT_CASES)
@pytest.mark.parametrize("num_shards", [2, 3])
def test_root_fixup_matches_reference(docs, query, num_shards):
    def tree_of(ns, build):
        return build(ns("root", children=[_doc(ns, lab, t.split()) for lab, t in docs]))

    tree = tree_of(NodeSpec, build_tree)
    ref_mono = RefEngine(tree_of(RefNodeSpec, ref_build_tree))
    num_shards = min(num_shards, len(docs))
    with ClusterService.from_tree(tree, num_shards, batch_window_ms=0.5,
                                  device="cpu") as svc:
        for sem in SEMS:
            want = ref_mono.query(query, semantics=sem, backend="scalar")
            got = svc.query(query, semantics=sem)
            _same_bytes(got, want, f"{docs} {query} {sem} shards={num_shards}")


def test_rolling_publish_bumps_generations(tmp_path, corpus, expected):
    path = str(tmp_path / "cluster")
    m0 = build_cluster(corpus, 2, path, device="cpu")
    assert [s["generation"] for s in m0["shards"]] == [0, 0]
    with ClusterService.from_dir(path, batch_window_ms=1.0, device="cpu") as svc:
        assert svc.generation_vector() == (0, 0)
        m1 = rolling_publish(path, corpus, service=svc, device="cpu")
        assert [s["generation"] for s in m1["shards"]] == [1, 1]
        assert svc.generation_vector() == (1, 1)
        assert svc.stats().summary()["reloads"] == 2
        for i in (0, 3, len(ALL_QUERIES) - 1):
            _same_bytes(svc.query(ALL_QUERIES[i], "elca"), expected[(i, "elca")],
                        str(ALL_QUERIES[i]))


def test_entry_points_default_to_cuda(tmp_path, corpus, monkeypatch):
    """Without CUDA, every cluster entry point that is not told the CPU
    fails typed: in this process, in a shard subprocess, in a shard server.
    Nothing serves on the CPU in its place."""
    import torch

    from repro_torch.cluster import load_cluster, load_cluster_layout, partition_corpus

    path = str(tmp_path / "cluster")
    build_cluster(corpus, 1, path, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
        lambda: ClusterService.from_tree(corpus, 2),
        lambda: ClusterService.from_dir(path),
        lambda: build_cluster(corpus, 2, str(tmp_path / "other")),
        lambda: partition_corpus(corpus, 2),
        lambda: load_cluster(path),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # children are fresh interpreters: hide every card from them
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    shard0 = load_cluster_layout(path)[2][0][1]
    with ThreadPoolExecutor(2) as ex:  # both children start at once
        starts = [
            ex.submit(ClusterService.from_dir, path, transport="process",
                      batch_window_ms=1.0),
            ex.submit(launch_server, shard0, shard=0),
        ]
    for fut in starts:
        with pytest.raises(WorkerDied, match="CUDA is not available"):
            fut.result()


@pytest.mark.parametrize("name", ["jax", "xla", "pallas"])
def test_reference_backend_names_rejected(tmp_path, corpus, name):
    """The reference's names are refused with the port's message, before
    any drain thread or child starts."""
    path = str(tmp_path / "cluster")
    build_cluster(corpus, 2, path, device="cpu")
    for transport in ("thread", "process", "remote"):
        with pytest.raises(ValueError, match="backend must be one of"):
            ClusterService.from_dir(path, transport=transport, backends=name,
                                    endpoints=[None, None], device="cpu")
