"""The fused search CUDA kernel == its plain PyTorch version, on the card.

Both routes of the kernel (``fused_search.route``: ``"rows"``, one block per
row with its state in shared memory, one launch; ``"tiles"``, rows past it
spread over blocks in three launches) are held against the plain version.

Runs only where a CUDA device is present (the kernel has no CPU mode); on a
host without one every test here skips.  Imports nothing of the JAX
package, so it runs on a card host that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_fused_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.idlist import IDList, make_pidpos
from repro_torch.core.plan_cache import PlanCache
from repro_torch.kernels import fused_search
from repro_torch.kernels.fused_search import (
    fused_search_batch,
    fused_search_batch_plain,
)


def _random_item(rng, k, long=False):
    """k ancestor-closed IDLists over one random tree (parents have lower ids;
    ``long``: a tree of 8,000-20,000 nodes whose parents may be anywhere
    before, so L0 passes the rows route's 2,048 slots)."""
    n = int(rng.integers(8000, 20_000)) if long else int(rng.integers(5, 400))
    par = np.full(n, -1, np.int64)
    for i in range(1, n):
        par[i] = int(rng.integers(0 if long else max(0, i - 8), i))
    lists = []
    for _ in range(k):
        nd: dict[int, int] = {}
        lo = n // 3 if long else 1
        for d in rng.choice(n, size=int(rng.integers(lo, max(lo + 1, n // 2))), replace=False):
            v = int(d)
            while v >= 0:
                nd[v] = nd.get(v, 0) + 1
                v = int(par[v])
        ids = np.array(sorted(nd), dtype=np.int32)
        ndesc = np.array([nd[i] for i in sorted(nd)], dtype=np.int32)
        lists.append(IDList(ids=ids, pidpos=make_pidpos(ids, par), ndesc=ndesc))
    return lists


@pytest.fixture
def cuda_plan():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused search kernel has no CPU mode")
    return PlanCache(backend="fused", min_rows=8, device="cuda")


@pytest.mark.parametrize("semantics", ["slca", "elca", "ca"])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_kernel_matches_plain(cuda_plan, semantics, k):
    rng = np.random.default_rng(k * 31 + len(semantics))
    items = [_random_item(rng, k) for _ in range(5)]  # rows 8: 3 all-pad rows
    batch, kept, _ = cuda_plan.pack(items, list(range(5)), semantics, "fused")
    launches = fused_search.LAUNCHES
    ids, mask = fused_search_batch(**batch, semantics=semantics)
    torch.cuda.synchronize()
    assert fused_search.LAUNCHES == launches + 1
    plain = {n: v for n, v in batch.items() if n != "other_n"}
    want_ids, want_mask = fused_search_batch_plain(**plain, semantics=semantics)
    assert torch.equal(ids, want_ids)
    assert torch.equal(mask, want_mask)
    assert not mask[len(kept):].any()


def _batch(plan, rng, k, semantics, n_items=5, **item):
    items = [_random_item(rng, k, **item) for _ in range(n_items)]
    batch, kept, _ = plan.pack(items, list(range(n_items)), semantics, "fused")
    return batch, kept


def _plain(batch, semantics):
    plain = {n: v for n, v in batch.items() if n != "other_n"}
    return fused_search_batch_plain(**plain, semantics=semantics)


def _device_kernels(fn) -> dict:
    """{kernel name: launches} the profiler saw on the card during ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    # a warm-up step first: traces started cold have lost events
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    seen = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA and "kernel" in evt.name:
            name = next((n for n in ("fused_rows_kernel", "membership_kernel",
                                     "parent_kernel", "keep_kernel") if n in evt.name),
                        evt.name)
            seen[name] = seen.get(name, 0) + 1
    return seen


@pytest.mark.parametrize("semantics", ["slca", "elca", "ca"])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("which", ["rows", "tiles"])
def test_each_route_matches_plain(cuda_plan, which, k, semantics):
    """Rows that fit take the rows route, longer ones the tiles route; each
    route, forced, equals the plain version on a batch it can take."""
    rng = np.random.default_rng(k * 7 + len(semantics) + len(which))
    item = {} if which == "rows" else {"long": True}
    batch, kept = _batch(cuda_plan, rng, k, semantics, **item)
    m0 = batch["ids0"].shape[1]
    assert fused_search.route(m0, k, semantics) == which
    want_ids, want_mask = _plain(batch, semantics)
    launches = fused_search.LAUNCHES
    ids, mask = fused_search_batch(**batch, semantics=semantics)
    assert fused_search.LAUNCHES == launches + 1
    assert torch.equal(ids, want_ids) and torch.equal(mask, want_mask)
    assert not mask[len(kept):].any()
    for forced in fused_search.ROUTES:
        if forced == "rows" and not fused_search.rows_fit(m0, k, semantics):
            continue
        got = fused_search._launch(cuda_plan.device.index or 0, *batch.values(),
                                   semantics, forced)
        assert torch.equal(got[0], want_ids) and torch.equal(got[1], want_mask), forced


@pytest.mark.parametrize("semantics", ["slca", "elca", "ca"])
def test_rows_route_is_one_device_launch(cuda_plan, semantics):
    rng = np.random.default_rng(len(semantics))
    batch, _ = _batch(cuda_plan, rng, 3, semantics)
    assert fused_search.route(batch["ids0"].shape[1], 3, semantics) == "rows"
    seen = _device_kernels(lambda: fused_search_batch(**batch, semantics=semantics))
    assert seen == {"fused_rows_kernel": 1}


@pytest.mark.parametrize("semantics", ["slca", "elca", "ca"])
def test_tiles_route_launches(cuda_plan, semantics):
    rng = np.random.default_rng(3 + len(semantics))
    batch, _ = _batch(cuda_plan, rng, 2, semantics, n_items=1, long=True)
    assert fused_search.route(batch["ids0"].shape[1], 2, semantics) == "tiles"
    seen = _device_kernels(lambda: fused_search_batch(**batch, semantics=semantics))
    want = {"membership_kernel": 1, "parent_kernel": 1, "keep_kernel": 1}
    if semantics == "ca":
        del want["parent_kernel"]
    assert seen == want


@pytest.mark.parametrize("which", ["rows", "tiles"])
@pytest.mark.parametrize("semantics", ["slca", "elca"])
def test_all_pad_rows_and_repeat_calls(cuda_plan, which, semantics):
    """Rows with n0 = 0 keep nothing; two calls are bit for bit equal."""
    rng = np.random.default_rng(11)
    item = {} if which == "rows" else {"long": True}
    batch, _ = _batch(cuda_plan, rng, 3, semantics, n_items=2, **item)
    batch["n0"][0] = 0  # a row packed as all pad
    index = cuda_plan.device.index or 0
    first = fused_search._launch(index, *batch.values(), semantics, which)
    second = fused_search._launch(index, *batch.values(), semantics, which)
    want_ids, want_mask = _plain(batch, semantics)
    assert torch.equal(first[0], want_ids) and torch.equal(first[1], want_mask)
    assert torch.equal(second[0], first[0]) and torch.equal(second[1], first[1])
    assert not first[1][0].any() and not first[1][2:].any()


@pytest.mark.parametrize("long", [False, True], ids=["rows", "tiles"])
def test_fused_on_a_side_stream(cuda_plan, long):
    rng = np.random.default_rng(21)
    batch, _ = _batch(cuda_plan, rng, 4, "elca", long=long)
    want_ids, want_mask = _plain(batch, "elca")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ids, mask = fused_search_batch(**batch, semantics="elca")
    side.synchronize()
    assert torch.equal(ids, want_ids) and torch.equal(mask, want_mask)


def test_other_n_none_searches_the_bucket(cuda_plan):
    rng = np.random.default_rng(31)
    batch, _ = _batch(cuda_plan, rng, 3, "slca")
    want_ids, want_mask = _plain(batch, "slca")
    ids, mask = fused_search_batch(**{**batch, "other_n": None}, semantics="slca")
    assert torch.equal(ids, want_ids) and torch.equal(mask, want_mask)


@pytest.mark.parametrize("which", ["rows", "tiles"])
@pytest.mark.parametrize("semantics", ["slca", "elca"])
def test_parents_outside_l0(cuda_plan, which, semantics):
    """Parent ids that are not in L0, or lie past its valid length, add to
    nothing: each route equals the plain version on scrambled parents."""
    rng = np.random.default_rng(41)
    item = {} if which == "rows" else {"long": True}
    batch, _ = _batch(cuda_plan, rng, 2, semantics, n_items=3, **item)
    pid = batch["pid0"]
    scrambled = torch.randint(-1, int(batch["ids0"][0, 0]) + 50_000, pid.shape,
                              generator=torch.Generator().manual_seed(5)).to(pid)
    keep = torch.rand(pid.shape, generator=torch.Generator().manual_seed(6)).to(pid.device) < 0.7
    batch["pid0"] = torch.where(keep, pid, scrambled).contiguous()
    got = fused_search._launch(cuda_plan.device.index or 0, *batch.values(), semantics, which)
    want_ids, want_mask = _plain(batch, semantics)
    assert torch.equal(got[0], want_ids) and torch.equal(got[1], want_mask)
