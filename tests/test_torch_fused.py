"""Port's fused search == the reference's Pallas ``fused_search_batch``.

On the CPU the port's ``fused_search_batch`` runs its plain PyTorch version;
the reference runs its Pallas kernel the way its own tests do (interpret
mode).  Both get the same reference-packed batches; ids and masks must be
equal with no tolerance.  The PlanCache pack arrays, plan keys and
``snapshot()`` counters are compared too.  The CUDA kernel itself is held
against the plain version in ``test_torch_fused_cuda.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch
from test_fused import random_items

from repro.core.idlist import IDList
from repro.core.plan_cache import PlanCache as RefPlanCache
from repro.kernels.fused_search import fused_search_batch as ref_fused
from repro_torch.core.idlist import IDList as PortIDList
from repro_torch.core.plan_cache import PlanCache
from repro_torch.kernels import fused_search
from repro_torch.kernels.fused_search import fused_search_batch, run_query_fused


def to_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def to_port(items):
    return [[PortIDList(l.ids, l.pidpos, l.ndesc) for l in ls] for ls in items]


def assert_same(batch, semantics, err="", **ref_kw):
    want_ids, want_mask = ref_fused(**batch, semantics=semantics, **ref_kw)
    launches = fused_search.LAUNCHES
    got_ids, got_mask = fused_search_batch(**to_torch(batch), semantics=semantics)
    assert fused_search.LAUNCHES == launches  # CPU tensors: plain version
    np.testing.assert_array_equal(got_ids.numpy(), want_ids, err_msg=err)
    np.testing.assert_array_equal(got_mask.numpy(), want_mask, err_msg=err)


@pytest.mark.parametrize("semantics", ["slca", "elca", "ca"])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_fused_matches_reference(semantics, k):
    rng = np.random.default_rng(900 + k * 10 + len(semantics))
    cache = RefPlanCache(backend="fused")
    for trial in range(2):
        items = random_items(rng, int(rng.integers(1, 6)), k)
        batch, _, _ = cache.pack(items, list(range(len(items))), semantics, "fused")
        assert_same(batch, semantics, err=f"trial={trial} {semantics} k={k}")


@pytest.mark.parametrize("semantics", ["slca", "elca"])
def test_fused_matches_reference_multi_block_window(semantics):
    """A small ``bo`` makes the reference walk several clamped blocks."""
    rng = np.random.default_rng(7)
    items = random_items(rng, 3, 3)
    batch, _, _ = RefPlanCache(backend="fused").pack(
        items, [0, 1, 2], semantics, "fused"
    )
    stats: dict = {}
    ref_fused(**batch, semantics=semantics, bo=16, stats=stats)
    assert stats["nob"] > 1
    assert_same(batch, semantics, bo=16)


def test_fused_all_pad_rows():
    rng = np.random.default_rng(11)
    items = random_items(rng, 3, 2)
    batch, kept, sig = RefPlanCache(backend="fused", min_rows=8).pack(
        items, [0, 1, 2], "elca", "fused"
    )
    assert sig.rows == 8 and len(kept) == 3
    assert_same(batch, "elca")
    ids, mask = fused_search_batch(**to_torch(batch), semantics="elca")
    assert not mask[3:].any()
    assert (ids[3:] == np.iinfo(np.int32).max).all()


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_fused_single_element_lists(k):
    lists = [
        PortIDList(
            ids=np.array([0], np.int32),
            pidpos=np.array([-1], np.int32),
            ndesc=np.array([1], np.int32),
        )
        for _ in range(k)
    ]
    for semantics in ("slca", "elca", "ca"):
        got = run_query_fused(lists, semantics=semantics, device="cpu")
        np.testing.assert_array_equal(got, np.array([0], np.int64))


def test_pack_arrays_and_plan_key_match_reference():
    rng = np.random.default_rng(5)
    ref_cache = RefPlanCache(backend="fused", min_rows=2)
    port_cache = PlanCache(backend="fused", min_rows=2, device="cpu")
    for k in (1, 2, 3):
        items = random_items(rng, 3, k)
        items.insert(1, [IDList(*(np.zeros(0, np.int32),) * 3)] * k)  # dropped
        keys = list(range(len(items)))
        want, want_kept, want_sig = ref_cache.pack(items, keys, "elca", "fused")
        got, got_kept, got_sig = port_cache.pack(to_port(items), keys, "elca", "fused")
        assert got_kept == want_kept
        assert dataclasses.asdict(got_sig) == dataclasses.asdict(want_sig)
        assert sorted(got) == sorted(want)
        for name, arr in want.items():
            assert got[name].dtype == torch.int32
            np.testing.assert_array_equal(got[name].numpy(), arr, err_msg=name)


def test_snapshot_counters_match_reference():
    rng = np.random.default_rng(6)
    ref_cache = RefPlanCache(backend="fused")
    port_cache = PlanCache(backend="fused", device="cpu")
    runs = [random_items(rng, n, k) for n, k in ((2, 2), (2, 2), (3, 1), (1, 3))]
    runs.append(runs[0])  # a repeated shape: a plan hit
    for items in runs:
        keys = list(range(len(items)))
        want = ref_cache.run(items, keys, "slca", backend="fused")
        got = port_cache.run(to_port(items), keys, "slca", backend="fused")
        for key in keys:
            assert got[key].dtype == np.int64
            np.testing.assert_array_equal(got[key], want[key])
    assert port_cache.snapshot() == ref_cache.snapshot()
    assert port_cache.snapshot()["fused_fallbacks"] == 0
    assert PlanCache.executable_count() == -1


def test_fused_rejects_bad_inputs():
    rng = np.random.default_rng(4)
    batch, _, _ = RefPlanCache(backend="fused").pack(
        random_items(rng, 2, 2), [0, 1], "slca", "fused"
    )
    t = to_torch(batch)
    with pytest.raises(ValueError, match="int32"):
        fused_search_batch(**dict(t, pid0=t["pid0"].long()))
    with pytest.raises(ValueError, match="shape"):
        fused_search_batch(**dict(t, n0=t["n0"][:1]))
    with pytest.raises(ValueError, match="semantics"):
        fused_search_batch(**t, semantics="lca")



def test_fused_round_phase_attrs_carry_the_plan_key():
    rng = np.random.default_rng(8)
    items = to_port(random_items(rng, 3, 3))
    phases: list = []
    PlanCache(backend="fused", device="cpu").run(
        items, [0, 1, 2], "elca", backend="fused", phases=phases
    )
    pack, launch = phases
    assert [pack["name"], launch["name"]] == ["plan.pack", "kernel.fused_round"]
    for key in ("rows", "k", "m0", "mo"):
        assert launch["attrs"][key] == pack["attrs"][key]
    assert launch["attrs"]["semantics"] == "elca"


def test_kernel_builds_under_the_checkout():
    root = fused_search._SOURCE.parents[3]
    assert (root / "src" / "repro_torch" / "csrc" / "fused_search.cu").exists()
    assert fused_search.BUILD_DIR == root / "build" / "repro_torch_kernels"


@pytest.mark.parametrize("m0,k,semantics,want", [
    (16, 2, "slca", "rows"),
    (2048, 4, "elca", "rows"),
    (2048, 1, "ca", "rows"),
    (4096, 2, "slca", "tiles"),  # past the rows route's 2,048 slots
    (65_536, 4, "elca", "tiles"),
    (2048, 14, "elca", "tiles"),  # 14 lists' sums and NDesc pass 227 KB
])
def test_route_is_decided_by_shape(m0, k, semantics, want):
    assert fused_search.route(m0, k, semantics) == want
    # the rows route's state fits for every row it takes, and for some longer
    # rows it is not sent (one block would walk them too slowly)
    assert fused_search.rows_fit(m0, k, semantics) == (want == "rows" or m0 == 4096)


def test_plain_path_ignores_other_n():
    """other_n is optional: the CPU path gives the same with or without it."""
    rng = np.random.default_rng(12)
    items = random_items(rng, 3, 3)
    batch, _, _ = RefPlanCache(backend="fused").pack(items, [0, 1, 2], "elca", "fused")
    t = to_torch(batch)
    with_n = fused_search_batch(**t, semantics="elca")
    without = fused_search_batch(**{**t, "other_n": None}, semantics="elca")
    assert torch.equal(with_n[0], without[0]) and torch.equal(with_n[1], without[1])
