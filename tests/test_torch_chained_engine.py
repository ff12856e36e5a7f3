"""Port engine and service on ``backend="chained"`` == the reference's ``"pallas"``.

Both packages build their own indices from the same synthetic discogs
corpus.  The port (``device="cpu"``, so each chained kernel runs its plain
version) answers the paper's queries through the engine's tree and DAG
routes, the batched DAG search and a ``QueryService``; the reference runs
its Pallas kernels in interpret mode.  Ids must equal the reference's and the
port's ``"scalar"`` backend, with no tolerance.
"""
import numpy as np
import pytest

from repro.api import Query as RefQuery
from repro.core import KeywordSearchEngine as RefEngine
from repro.data import QUERIES
from repro.data import generate_discogs_tree as ref_generate
from repro.serve.service import QueryService as RefService
from repro_torch.api import Query
from repro_torch.core import KeywordSearchEngine
from repro_torch.core.search_dag import dag_search_vec, dag_search_vec_multi
from repro_torch.data import generate_discogs_tree
from repro_torch.kernels import ops  # noqa: F401  (registers "chained")
from repro_torch.serve.service import QueryService

WORDS = [kws for _, kws in QUERIES.values()]


@pytest.fixture(scope="module")
def engines():
    ref = RefEngine(ref_generate(n_releases=60, seed=3))
    port = KeywordSearchEngine(generate_discogs_tree(n_releases=60, seed=3), device="cpu")
    return ref, port


@pytest.mark.parametrize("index", ["tree", "dag"])
def test_chained_engine_matches_reference_pallas(engines, index):
    ref, port = engines
    for q, (_cat, kws) in QUERIES.items():
        for sem in ("slca", "elca"):
            err = f"{q} {sem} {index}"
            want = ref.query(RefQuery(kws, sem, index, "pallas"))
            got = port.query(Query(kws, sem, index, "chained"))
            scalar = port.query(Query(kws, sem, index, "scalar"))
            np.testing.assert_array_equal(got.ids, want.ids, err_msg=err)
            np.testing.assert_array_equal(got.ids, scalar.ids, err_msg=err)
            assert got.ids.dtype == np.int64
            assert set(got.stats) == set(want.stats)
            if index == "dag":  # one chained call per RC, as the reference
                for key in ("rounds", "rcs_searched", "launches"):
                    assert got.stats[key] == want.stats[key], (err, key)


def test_chained_dag_round_phases(engines):
    _, port = engines
    kws = port.keyword_ids(QUERIES["Q1"][1])
    stats, phases = {}, []
    dag_search_vec(
        port.cluster, kws, "elca", backend="chained", stats=stats,
        plan=port.plan_cache, phases=phases,
    )
    assert [p["name"] for p in phases] == ["kernel.chained_round"] * stats["rounds"]
    assert [p["attrs"]["round"] for p in phases] == list(range(1, stats["rounds"] + 1))
    assert sum(p["attrs"]["rcs"] for p in phases) == stats["launches"]
    assert stats["launches"] == stats["rcs_searched"]


@pytest.mark.parametrize("sem", ["slca", "elca"])
def test_chained_query_batch_matches_reference(engines, sem):
    """``query_batch`` runs "torch" as the reference's runs "xla"; the batched
    search with the chained membership step (a chained service's drain)
    answers the same batch with the same ids."""
    ref, port = engines
    want = ref.query_batch(WORDS, semantics=sem)
    got = port.query_batch(WORDS, semantics=sem)
    stats = {}
    chained = dag_search_vec_multi(
        port.cluster, [port.keyword_ids(w) for w in WORDS], sem,
        backend="chained", stats=stats, plan=port.plan_cache,
    )
    for kws, g, c, w in zip(WORDS, got, chained, want):
        np.testing.assert_array_equal(g, w, err_msg=f"{kws} {sem}")
        np.testing.assert_array_equal(c, w, err_msg=f"{kws} {sem} chained")
    assert port.last_stats.data["launches"] > 0
    assert stats["launches"] == port.last_stats.data["launches"]


def test_chained_service_matches_reference_pallas(engines):
    ref, port = engines
    with RefService(ref, backend="pallas") as rsvc, QueryService(
        port, backend="chained", device="cpu"
    ) as psvc:
        for sem in ("slca", "elca"):
            want = rsvc.map(WORDS, semantics=sem)
            got = psvc.map(WORDS, semantics=sem)
            for kws, g, w in zip(WORDS, got, want):
                np.testing.assert_array_equal(g, w, err_msg=f"{kws} {sem}")
            # the unified-API admission path answers the same ids
            res = psvc.submit(Query(WORDS[-1], sem, backend="chained")).result(60)
            np.testing.assert_array_equal(res.ids, want[-1])
        assert psvc.stats().data["launches"] > 0
        assert set(psvc.stats().to_dict()) == set(rsvc.stats().to_dict())
