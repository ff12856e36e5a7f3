"""Port rebalancer (device="cpu") == the reference rebalancer.

The planner is pure host code: on every load report of
``tests/test_rebalance.py`` and on 50 reports drawn from a numpy seed (2-8
shards, skewed qps, idle windows, doc-range heat, single-document shards,
spare hosts, the shard cap) the port's ``plan_rebalance`` must return the
reference's plan and actions field for field, as JSON.  The plan
constructors, ``doc_heat_weights`` and ``apply_actions`` must agree on the
same corpus.  ``repartition_publish`` must commit the reference's manifest
(token names aside), and a cluster either package repartitioned is served
by the other.  A live split 2 -> 4 and merge 4 -> 2 under a query stream
loses nothing, the process transport rebuilds its children, and a shard
moves between servers on the remote transport.
"""
import copy
import dataclasses
import json
import os
import threading

import numpy as np
import pytest

from repro.cluster import ClusterService as RefClusterService
from repro.cluster import build_cluster as ref_build_cluster
from repro.cluster import rebalance as ref
from repro.data import generate_discogs_tree as ref_generate
from repro_torch.cluster import (
    Action,
    ClusterService,
    PlacementPlan,
    WorkerDied,
    apply_actions,
    build_cluster,
    doc_heat_weights,
    move_shard,
    plan_rebalance,
    repartition_publish,
)
from repro_torch.cluster.partition import MAX_SHARDS
from repro_torch.core import KeywordSearchEngine
from repro_torch.core.io import load_cluster_manifest
from repro_torch.data import QUERIES, generate_discogs_tree

N_RELEASES = 30
SEMS = ("slca", "elca")
EXTRA_QUERIES = [  # tests/test_rebalance.py's cross-shard / root-only cases
    ["releases"],
    ["release"],
    ["img-3.jpg", "vinyl"],
    ["zzz-not-a-word"],
    ["vinyl"],
]
ALL_QUERIES = [kws for _, kws in QUERIES.values()] + EXTRA_QUERIES


@pytest.fixture(scope="module")
def corpus():
    return generate_discogs_tree(n_releases=N_RELEASES, seed=5)


@pytest.fixture(scope="module")
def ref_corpus():
    return ref_generate(n_releases=N_RELEASES, seed=5)


@pytest.fixture(scope="module")
def expected(corpus):
    mono = KeywordSearchEngine(corpus, device="cpu")
    return {
        (i, sem): mono.query(q, semantics=sem, backend="scalar")
        for i, q in enumerate(ALL_QUERIES)
        for sem in SEMS
    }


def _outcome(result) -> str:
    """(plan, actions) as one JSON text: every field, floats unrounded."""
    plan, actions = result
    return json.dumps(
        {
            "plan": None if plan is None else dataclasses.asdict(plan),
            "plan_json": None if plan is None else plan.to_json(),
            "actions": [dataclasses.asdict(a) for a in actions],
            "actions_json": [a.to_json() for a in actions],
        },
        sort_keys=True,
    )


def _both_plan(report, plan=None, **kw):
    """(port outcome, reference outcome) on copies of the same report."""
    port_plan = ref_plan = None
    if plan is not None:
        port_plan = PlacementPlan(*plan)
        ref_plan = ref.PlacementPlan(*plan)
    got = plan_rebalance(copy.deepcopy(report), port_plan, **kw)
    want = ref.plan_rebalance(copy.deepcopy(report), ref_plan, **kw)
    return _outcome(got), _outcome(want)


# --------------------------------------------------------------------------- #
# Planner parity
# --------------------------------------------------------------------------- #


def _report(loads, bounds, doc_heat=None):
    """tests/test_rebalance.py's report builder."""
    rows = [
        {
            "shard": i,
            "qps": float(load),
            "queries": int(load * 10),
            "doc_heat": list(doc_heat[i]) if doc_heat else [],
        }
        for i, load in enumerate(loads)
    ]
    return {
        "version": 1,
        "shards": rows,
        "layout": {"doc_bounds": list(bounds), "num_shards": len(loads)},
    }


REFERENCE_REPORTS = {  # tests/test_rebalance.py's planner cases
    "split-hot": (_report([90.0, 10.0], [0, 10, 30]), {}),
    "split-heat-median": (
        _report([90.0, 10.0], [0, 10, 30],
                doc_heat=[[0.0] * 63 + [50.0], [0.0] * 64]),
        {},
    ),
    "merge-cold": (_report([50.0, 1.0, 1.0, 48.0], [0, 8, 16, 24, 30]), {}),
    "balanced": (_report([10.0, 11.0, 9.0], [0, 10, 20, 30]), {}),
    "idle": (_report([0, 0, 0], [0, 10, 20, 30]), {}),
    "move-spare": (
        _report([90.0, 10.0], [0, 1, 30]), {"spare_endpoints": ("spare:9999",)}
    ),
    "move-no-spare": (_report([90.0, 10.0], [0, 1, 30]), {}),
    "shard-cap": (_report([90.0, 10.0], [0, 10, 30]), {"max_shards": 2}),
}


@pytest.mark.parametrize("case", sorted(REFERENCE_REPORTS))
def test_planner_equal_reference_on_reference_reports(case):
    report, kw = REFERENCE_REPORTS[case]
    got, want = _both_plan(report, **kw)
    assert got == want


def _random_case(seed: int):
    """One seeded load report, an optional explicit plan, and planner options."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 9))
    n_docs = int(rng.integers(n + 2, 400))
    cuts = sorted(int(c) for c in rng.choice(np.arange(1, n_docs), n - 1,
                                             replace=False))
    bounds = [0, *cuts, n_docs]
    if rng.random() < 0.3 and bounds[2] > 1:
        bounds[1] = 1  # a single-document shard: it can only move
    qps = rng.lognormal(0.0, 1.5, n) * (rng.random(n) < 0.85)
    qps[int(rng.integers(n))] *= float(rng.uniform(1.0, 12.0))  # the skew
    idle = rng.random() < 0.2  # no traffic in the window: lifetime heat
    rows = []
    for s in range(n):
        heat_kind = rng.integers(3)
        doc_heat = (
            [] if heat_kind == 0
            else [0.0] * 64 if heat_kind == 1
            else [float(x) for x in rng.poisson(rng.uniform(0.1, 20.0), 64)]
        )
        rows.append({
            "shard": s,
            "qps": 0.0 if idle else float(qps[s]),
            "queries": int(rng.integers(0, 1000)),
            "heat_queries": int(rng.integers(0, 500)),
            "doc_heat": doc_heat,
        })
    report = {"version": 1, "shards": rows,
              "layout": {"doc_bounds": bounds, "num_shards": n}}
    kw = {}
    if rng.random() < 0.5:
        kw["spare_endpoints"] = tuple(
            f"spare-{i}:{9000 + i}" for i in range(int(rng.integers(1, 3))))
    if rng.random() < 0.4:
        kw["max_shards"] = int(rng.choice([n, n + 1, n + 2, MAX_SHARDS]))
    if rng.random() < 0.3:
        kw["split_factor"] = float(rng.uniform(1.1, 2.5))
        kw["merge_factor"] = float(rng.uniform(0.2, 0.9))
        kw["cost_weight"] = float(rng.uniform(0.0, 1.0))
    plan = None
    if rng.random() < 0.4:  # an explicit plan with placements to inherit
        eps = tuple(
            None if k == 0 else f"h{s}:1" if k == 1 else (f"h{s}:1", f"r{s}:2")
            for s, k in enumerate(rng.integers(0, 3, n))
        )
        plan = (tuple(bounds), eps)
    return report, plan, kw


@pytest.mark.parametrize("seed", range(50))
def test_planner_equal_reference_on_random_reports(seed):
    report, plan, kw = _random_case(seed)
    got, want = _both_plan(report, plan, **kw)
    assert got == want


def test_random_reports_reach_every_rule():
    """The seeded reports exercise split, merge, move and no-op alike."""
    kinds = set()
    for seed in range(50):
        report, plan, kw = _random_case(seed)
        new, actions = plan_rebalance(
            report, None if plan is None else PlacementPlan(*plan), **kw)
        kinds |= {a.kind for a in actions} or {"noop"}
    assert kinds == {"split", "merge", "move", "noop"}


@pytest.mark.parametrize(
    "bad",
    [(0, 5, 5), (1, 5, 10), (0,), tuple(range(66))],
    ids=["repeat", "start", "empty", "cap"],
)
def test_plan_validation_equal_reference(bad):
    with pytest.raises(ValueError) as got:
        PlacementPlan(bad).validate()
    with pytest.raises(ValueError) as want:
        ref.PlacementPlan(bad).validate()
    assert str(got.value) == str(want.value)


# --------------------------------------------------------------------------- #
# Plans and heat on the corpus
# --------------------------------------------------------------------------- #


def test_plans_and_heat_equal_reference(corpus, ref_corpus):
    for n in (1, 2, 3, 4, 7):
        assert (PlacementPlan.balanced(corpus, n).doc_bounds
                == ref.PlacementPlan.balanced(ref_corpus, n).doc_bounds)
    rng = np.random.default_rng(7)
    for smoothing in (0.0, 0.1, 1.0):
        heat = rng.exponential(1.0, N_RELEASES)
        heat[:5] *= 50.0
        got = PlacementPlan.heat_balanced(corpus, 4, heat, smoothing=smoothing)
        want = ref.PlacementPlan.heat_balanced(ref_corpus, 4, heat,
                                               smoothing=smoothing)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for bounds in ([0, 15, N_RELEASES], [0, 4, 11, 23, N_RELEASES]):
        rows = [[float(x) for x in rng.poisson(3.0, 64)] for _ in bounds[1:]]
        rows[0] = [100.0] + [0.0] * 63
        got = doc_heat_weights(corpus, bounds, rows)
        want = ref.doc_heat_weights(ref_corpus, bounds, rows)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_apply_actions_equal_reference():
    plan = ((0, 10, 20, 30), ("h:1", "h:2", None))
    cases = [
        [("split", 2, {"cut_doc": 25})],
        [("merge", 0, {})],
        [("move", 1, {"endpoint": "spare:1"})],
        [("split", 0, {"cut_doc": 3}), ("merge", 1, {}),
         ("move", 2, {"endpoint": "spare:2"})],
    ]
    for actions in cases:
        got = apply_actions(PlacementPlan(*plan),
                            [Action(k, s, **kw) for k, s, kw in actions])
        want = ref.apply_actions(ref.PlacementPlan(*plan),
                                 [ref.Action(k, s, **kw) for k, s, kw in actions])
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for bad, frag in ((("split", 0, {}), "cut_doc"),
                      (("explode", 0, {}), "unknown action"),
                      (("merge", 2, {}), "out of range")):
        with pytest.raises(ValueError, match=frag):
            apply_actions(PlacementPlan(*plan), [Action(bad[0], bad[1], **bad[2])])


def test_plan_from_manifest_equal_reference(tmp_path, corpus, ref_corpus):
    m = build_cluster(corpus, 3, str(tmp_path / "port"), device="cpu")
    r = ref_build_cluster(ref_corpus, 3, str(tmp_path / "ref"))
    for man in (m, r):
        man["shards"][1]["endpoint"] = "h:1"
        man["shards"][2]["endpoint"] = "h:2"
        man["shards"][2]["replicas"] = ["h:3"]
    got = PlacementPlan.from_manifest(m)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        ref.PlacementPlan.from_manifest(r))
    assert got.endpoints == (None, "h:1", ("h:2", "h:3"))
    assert PlacementPlan.from_json(got.to_json()) == got


# --------------------------------------------------------------------------- #
# repartition_publish
# --------------------------------------------------------------------------- #


def _without_tokens(manifest: dict) -> dict:
    out = {k: v for k, v in manifest.items() if k != "routing_file"}
    out["shards"] = [{k: v for k, v in s.items() if k != "dir"}
                     for s in manifest["shards"]]
    return out


def _assert_serves(svc, expected, sems=SEMS):
    for sem in sems:
        for i, res in enumerate(svc.map(ALL_QUERIES, semantics=sem)):
            np.testing.assert_array_equal(res, expected[(i, sem)],
                                          err_msg=f"{ALL_QUERIES[i]} {sem}")


def test_repartition_equal_reference_and_cross_served(
    tmp_path, corpus, ref_corpus, expected
):
    """Both packages repartition their own 2-shard cluster to the same plan:
    equal manifests, old dirs reclaimed, and each serves the other's."""
    port_path, ref_path = str(tmp_path / "port"), str(tmp_path / "ref")
    old = {
        port_path: {s["dir"] for s in build_cluster(corpus, 2, port_path,
                                                     device="cpu")["shards"]},
        ref_path: {s["dir"] for s in ref_build_cluster(ref_corpus, 2,
                                                       ref_path)["shards"]},
    }
    plan = (0, 4, 11, N_RELEASES)
    got = repartition_publish(port_path, corpus, PlacementPlan(plan), device="cpu")
    want = ref.repartition_publish(ref_path, ref_corpus, ref.PlacementPlan(plan))
    assert _without_tokens(got) == _without_tokens(want)
    assert got["layout_epoch"] == 1 and got["num_shards"] == 3
    for path, dirs in old.items():
        assert not any(os.path.exists(os.path.join(path, d)) for d in dirs)
    with RefClusterService.from_dir(port_path, backends="jax",
                                    batch_window_ms=1.0) as svc:
        assert svc.layout_epoch == 1
        _assert_serves(svc, expected)
    with ClusterService.from_dir(ref_path, batch_window_ms=1.0,
                                 device="cpu") as svc:
        assert svc.layout_epoch == 1
        _assert_serves(svc, expected)
    # a plan that does not cover the corpus is refused before any write
    with pytest.raises(ValueError, match="corpus has"):
        repartition_publish(port_path, corpus, PlacementPlan((0, 4, 29)),
                            device="cpu")
    with open(os.path.join(port_path, "cluster.json")) as f:
        assert json.load(f)["layout_epoch"] == 1


def test_live_split_merge_under_traffic(tmp_path, corpus, expected):
    """Split 2 -> 4 and merge 4 -> 2 on a live thread-transport service while
    four clients query: no error, every answer equal to scalar."""
    path = str(tmp_path / "cluster")
    build_cluster(corpus, 2, path, device="cpu")
    svc = ClusterService.from_dir(path, batch_window_ms=0.5, device="cpu")
    errors: list[Exception] = []
    mismatches: list[int] = []
    stop = threading.Event()

    def hammer(offset: int):
        i = offset
        while not stop.is_set():
            qi, sem = i % len(ALL_QUERIES), SEMS[i % 2]
            try:
                got = svc.submit(ALL_QUERIES[qi], semantics=sem).result(30)
                if not np.array_equal(got, expected[(qi, sem)]):
                    mismatches.append(qi)
            except Exception as e:  # recorded and asserted == [] below
                errors.append(e)
            i += 1

    threads = [threading.Thread(target=hammer, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    try:
        m1 = repartition_publish(path, corpus, PlacementPlan((0, 7, 15, 22, 30)),
                                 service=svc, device="cpu")
        assert svc.layout_epoch == m1["layout_epoch"] == 1
        assert svc.num_shards == 4
        m2 = repartition_publish(path, corpus, PlacementPlan.balanced(corpus, 2),
                                 service=svc, device="cpu")
        assert svc.layout_epoch == m2["layout_epoch"] == 2
        assert svc.num_shards == 2
    finally:
        stop.set()
        for t in threads:
            t.join(30)
        alive = [t for t in threads if t.is_alive()]
    try:
        assert alive == []
        assert errors == []
        assert mismatches == []
        stats = svc.stats().data
        assert stats["repartitions"] == 2 and stats["queries"] > 0
        _assert_serves(svc, expected, sems=("elca",))
    finally:
        svc.close()


def test_repartition_process_transport(tmp_path, corpus, expected):
    """The layout transaction respawns the shard children at the new layout."""
    path = str(tmp_path / "cluster")
    build_cluster(corpus, 2, path, device="cpu")
    with ClusterService.from_dir(path, transport="process", batch_window_ms=1.0,
                                 device="cpu") as svc:
        np.testing.assert_array_equal(svc.query(ALL_QUERIES[0], "slca"),
                                      expected[(0, "slca")])
        m = repartition_publish(path, corpus, PlacementPlan((0, 10, 20, 30)),
                                service=svc, device="cpu")
        assert m["num_shards"] == 3 and svc.num_shards == 3
        assert svc.pool.locality == ["process"] * 3
        _assert_serves(svc, expected, sems=("slca",))


def test_planner_to_publish_pipeline(tmp_path, corpus, expected):
    """load_report -> plan_rebalance (equal to the reference's on the same
    report) -> repartition_publish on the live service."""
    path = str(tmp_path / "cluster")
    build_cluster(corpus, 2, path, device="cpu")
    with ClusterService.from_dir(path, batch_window_ms=0.5, device="cpu") as svc:
        for _ in range(8):  # heat up shard 0's range
            svc.query(ALL_QUERIES[0], "slca")
        report = svc.load_report()
        report["shards"][0]["qps"] = 50.0  # deterministic skew
        report["shards"][1]["qps"] = 1.0
        got, want = _both_plan(report)
        assert got == want
        plan, actions = plan_rebalance(report)
        assert [a.kind for a in actions] == ["split"]
        m = repartition_publish(path, corpus, plan, service=svc, device="cpu")
        assert m["num_shards"] == 3 and svc.num_shards == 3
        _assert_serves(svc, expected, sems=("slca",))


# --------------------------------------------------------------------------- #
# move_shard
# --------------------------------------------------------------------------- #


def test_move_shard_live(tmp_path, corpus, expected):
    path = str(tmp_path / "cluster")
    build_cluster(corpus, 2, path, device="cpu")
    with ClusterService.from_dir(path, transport="remote", batch_window_ms=1.0,
                                 device="cpu") as svc:
        assert svc.pool.locality == ["process", "process"]
        proc, endpoint, m = move_shard(path, 0, service=svc, backend="chained",
                                       device="cpu")
        try:
            assert m["shards"][0]["endpoint"] == endpoint
            assert svc.pool.locality == ["remote", "process"]
            assert svc.stats().data["moves"] == 1
            assert [s["generation"] for s in m["shards"]] == [0, 0]
            _assert_serves(svc, expected, sems=("elca",))
        finally:
            proc.kill()
            proc.wait(10)


def test_move_shard_needs_remote_transport(tmp_path, corpus):
    path = str(tmp_path / "cluster")
    build_cluster(corpus, 2, path, device="cpu")
    with ClusterService.from_dir(path, batch_window_ms=1.0, device="cpu") as svc:
        with pytest.raises(ValueError, match="remote transport"):
            svc.move_shard(0, "127.0.0.1:1")
        with pytest.raises(IndexError):
            svc.move_shard(9, "127.0.0.1:1")
        with pytest.raises(IndexError):
            move_shard(path, 9, service=svc, device="cpu")


def test_entry_points_default_to_cuda(tmp_path, corpus, monkeypatch):
    """Without CUDA the rebalancer's actuators fail typed and leave the
    committed cluster as it was; the reference's backend names are refused
    before a server starts."""
    import torch

    path = str(tmp_path / "cluster")
    build_cluster(corpus, 2, path, device="cpu")
    before = load_cluster_manifest(path)
    listing = sorted(os.listdir(path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        repartition_publish(path, corpus, PlacementPlan((0, 10, 20, 30)))
    with pytest.raises(ValueError, match="backend must be one of"):
        move_shard(path, 0, backend="jax", device="cpu")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")  # the server is a child
    with pytest.raises(WorkerDied, match="CUDA is not available"):
        move_shard(path, 0)
    assert load_cluster_manifest(path) == before
    assert sorted(os.listdir(path)) == listing
