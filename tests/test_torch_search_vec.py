"""Port's vectorized search (``"torch"``) == the reference's (``"xla"``).

The same PlanCache-packed batches (built by the reference ``PlanCache.pack``
from seeded random ancestor-closed corpora) go through the reference's
jitted ``ca_search_batch`` and the port's batched torch version on the CPU.
Ids are integers: the outputs must be equal, with no tolerance.
"""
import numpy as np
import pytest
import torch
from test_fused import random_items

from repro.core.idlist import IDList
from repro.core.plan_cache import PlanCache as RefPlanCache
from repro.core.search_vec import ca_search_batch as ref_ca_search_batch
from repro.core.search_vec import run_query as ref_run_query
from repro_torch.core.idlist import IDList as PortIDList
from repro_torch.core.search_vec import ca_search_batch, run_query


def to_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def assert_same(batch, semantics, err=""):
    want_ids, want_mask = ref_ca_search_batch(
        **batch, semantics=semantics, backend="xla"
    )
    got_ids, got_mask = ca_search_batch(**to_torch(batch), semantics=semantics)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids), err_msg=err)
    np.testing.assert_array_equal(
        got_mask.numpy(), np.asarray(want_mask), err_msg=err
    )


@pytest.mark.parametrize("semantics", ["slca", "elca", "ca"])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_ca_search_batch_matches_reference(semantics, k):
    rng = np.random.default_rng(500 + k * 10 + len(semantics))
    cache = RefPlanCache(backend="xla")
    for trial in range(2):
        items = random_items(rng, int(rng.integers(1, 6)), k)
        batch, _, _ = cache.pack(items, list(range(len(items))), semantics, "xla")
        assert_same(batch, semantics, err=f"trial={trial} {semantics} k={k}")


@pytest.mark.parametrize("semantics", ["slca", "elca", "ca"])
def test_ca_search_batch_all_pad_rows(semantics):
    rng = np.random.default_rng(21)
    cache = RefPlanCache(backend="xla", min_rows=8)
    items = random_items(rng, 3, 2)  # rows bucket to 8 => 5 all-pad rows
    batch, kept, sig = cache.pack(items, [0, 1, 2], semantics, "xla")
    assert sig.rows == 8 and len(kept) == 3
    assert_same(batch, semantics)
    got_ids, got_mask = ca_search_batch(**to_torch(batch), semantics=semantics)
    assert not got_mask[3:].any()


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_ca_search_batch_single_element_lists(k):
    lists = [
        IDList(
            ids=np.array([0], np.int32),
            pidpos=np.array([-1], np.int32),
            ndesc=np.array([1], np.int32),
        )
        for _ in range(k)
    ]
    cache = RefPlanCache(backend="xla")
    for semantics in ("slca", "elca", "ca"):
        batch, _, _ = cache.pack([lists], [0], semantics, "xla")
        assert_same(batch, semantics, err=f"{semantics} k={k}")


def test_run_query_matches_reference():
    rng = np.random.default_rng(8)
    for k in (1, 2, 3):
        (ref_lists,) = random_items(rng, 1, k)
        port_lists = [PortIDList(l.ids, l.pidpos, l.ndesc) for l in ref_lists]
        for semantics in ("slca", "elca"):
            np.testing.assert_array_equal(
                run_query(port_lists, semantics, device="cpu"),
                ref_run_query(ref_lists, semantics, backend="xla"),
            )
