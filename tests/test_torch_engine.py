"""Port engine + service (device="cpu") == the reference engine + service.

Both packages build their own indices from the same synthetic discogs
corpus and answer the paper's query set under each index, semantics and
backend pair: fused<->fused (the reference's Pallas kernel in interpret
mode, the port's plain version), torch<->jax, scalar<->scalar.  Ids must be
equal, with no tolerance.
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
from repro_torch.data import generate_discogs_tree
from repro_torch.serve.service import QueryService

PAIRS = [("fused", "fused"), ("torch", "jax"), ("scalar", "scalar")]
WORDS = [kws for _, kws in QUERIES.values()]


@pytest.fixture(scope="module")
def engines():
    ref = RefEngine(ref_generate(n_releases=40, seed=3))
    port = KeywordSearchEngine(generate_discogs_tree(n_releases=40, seed=3), device="cpu")
    return ref, port


@pytest.mark.parametrize("port_backend,ref_backend", PAIRS)
@pytest.mark.parametrize("index", ["tree", "dag"])
def test_engine_matches_reference(engines, index, port_backend, ref_backend):
    ref, port = engines
    for q, (_cat, kws) in QUERIES.items():
        for sem in ("slca", "elca"):
            want = ref.query(RefQuery(kws, sem, index, ref_backend))
            got = port.query(Query(kws, sem, index, port_backend))
            np.testing.assert_array_equal(
                got.ids, want.ids, err_msg=f"{q} {sem} {index} {port_backend}"
            )
            assert got.ids.dtype == np.int64
            assert set(got.stats) == set(want.stats)
            assert set(port.last_stats.to_dict()) == set(ref.last_stats.to_dict())


@pytest.mark.parametrize("sem", ["slca", "elca"])
def test_query_batch_matches_reference(engines, sem):
    ref, port = engines
    want = ref.query_batch(WORDS, semantics=sem)
    got = port.query_batch(WORDS, semantics=sem)
    for kws, g, w in zip(WORDS, got, want):
        np.testing.assert_array_equal(g, w, err_msg=f"{kws} {sem}")
    assert set(port.last_stats.to_dict()) == set(ref.last_stats.to_dict())


def test_fused_service_matches_reference(engines):
    ref, port = engines
    with RefService(ref, backend="fused") as rsvc, QueryService(
        port, backend="fused", device="cpu"
    ) as psvc:
        for sem in ("slca", "elca"):
            want = rsvc.map(WORDS, semantics=sem)
            got = psvc.map(WORDS, semantics=sem)
            for kws, g, w in zip(WORDS, got, want):
                np.testing.assert_array_equal(g, w, err_msg=f"{kws} {sem}")
            # the unified-API admission path answers the same ids
            res = psvc.submit(Query(WORDS[-1], sem, backend="fused")).result(60)
            np.testing.assert_array_equal(res.ids, want[-1])
        assert set(psvc.stats().to_dict()) == set(rsvc.stats().to_dict())
    assert port.plan_cache.snapshot()["fused_fallbacks"] == 0


def test_service_rejects_reference_backend_names(engines):
    _, port = engines
    for name in ("jax", "xla", "pallas", "cuda"):
        with pytest.raises(ValueError, match="backend"):
            QueryService(port, backend=name, device="cpu")
    with pytest.raises(ValueError, match="engine runs on cpu"):
        QueryService(port, backend="fused", device="meta")
