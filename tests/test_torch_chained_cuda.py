"""The chained CUDA kernels == their plain PyTorch versions, on the card.

Runs only where a CUDA device is present (the kernels have no CPU mode); on
a host without one every test here skips.  Imports nothing of the JAX
package, so it runs on a card host that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_chained_cuda.py
"""
import numpy as np
import pytest
import torch
from test_torch_fused_cuda import _random_item

from repro_torch.core.search_vec import ca_search_batch
from repro_torch.kernels import _build, elca_segsum, fused_search, intersect, ops
from repro_torch.kernels import searchsorted as ss
from repro_torch.kernels.shapes import INT_PAD


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the chained kernels have no CPU mode")
    return torch.device("cuda")


def sorted_unique(rng, n, hi=10**6):
    return np.unique(rng.integers(0, hi, size=n).astype(np.int32))


def on(dev, x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(dev)


def lists_case(rng, n0, others, mode="mixed"):
    """[(ids, ndesc)] of one chained query, L0 first: L0 of n0 ids in every
    other list (``"all"``), in none (``"none"``) or partly (``"mixed"``)."""
    hi = 4 * max(n0, *others) + 100
    if mode == "none":  # L0 odd, the others even
        l0 = np.unique(rng.integers(0, hi // 2, size=n0)) * 2 + 1
        rest = [np.unique(rng.integers(0, hi // 2, size=m)) * 2 for m in others]
    else:
        l0 = np.unique(rng.integers(0, hi, size=n0))
        keep = l0 if mode == "all" else l0[rng.random(l0.size) < 0.7]
        rest = [np.union1d(keep, rng.integers(0, hi, size=max(m - keep.size, 0)))
                for m in others]
    return [(ids.astype(np.int32), rng.integers(1, 100, size=ids.size).astype(np.int32))
            for ids in [l0, *rest]]


def pack_lists(lists, gaps=None, device="cpu"):
    """(buf, table, n) on ``device`` as ``run_query_chained`` packs them:
    each list's ids and NDesc, ``gaps[i]`` ints before part i (none by
    default), then the [k, 3] table (ids offset, NDesc offset, length) as a
    view of the buffer."""
    parts, table, off = [], [], 0
    for i, (ids, nd) in enumerate(lists):
        row = []
        for j, x in enumerate((ids, nd)):
            gap = 0 if gaps is None else gaps[(2 * i + j) % len(gaps)]
            parts += [np.full(gap, -7, np.int32), x]
            row.append(off + gap)
            off += gap + x.size
        table.append((*row, ids.size))
    buf = torch.from_numpy(np.concatenate(parts + [np.ravel(table).astype(np.int32)]))
    buf = buf.to(device)
    return buf, buf[off:].view(len(lists), 3), int(lists[0][0].size)


LISTS_CASES = [  # (n0, other lengths, mode)
    (1, (1,), "all"), (1, (1, 1, 1), "none"), (5, (1, 1), "mixed"),
    (300, (300, 900), "all"), (500, (700,), "none"),
    (2000, (3000, 8000, 20_000), "mixed"),  # every window staged whole
    (100, (100_000,), "mixed"),  # windows past the 4,093-id buffer: sampled
    (100, (20_000, 100_000, 3000), "mixed"),  # both, in one call
    (20_001, (60_001,), "mixed"),
]


@pytest.mark.parametrize("gaps", [None, (1, 2, 3, 0, 3)], ids=["packed", "gaps"])
@pytest.mark.parametrize("n0,others,mode", LISTS_CASES)
def test_intersect_lists_kernel_matches_plain(cuda, n0, others, mode, gaps):
    rng = np.random.default_rng(n0 * 7 + sum(others))
    buf, table, n = pack_lists(lists_case(rng, n0, others, mode), gaps, cuda)
    launches = intersect.LAUNCHES
    ca, nd = intersect.intersect_lists(buf, table, n)
    again = intersect.intersect_lists(buf, table, n)
    torch.cuda.synchronize()
    assert intersect.LAUNCHES == launches + 2
    want_ca, want_nd = intersect.intersect_lists_plain(buf, table, n)
    assert ca.dtype == torch.bool and nd.dtype == torch.int32
    assert torch.equal(ca, want_ca) and torch.equal(nd, want_nd)
    assert torch.equal(again[0], ca) and torch.equal(again[1], nd)


@pytest.mark.parametrize("width", [4092, 4093, 4094, 4095, 4096, 4097, 8192, 8193])
@pytest.mark.parametrize("gap", [0, 1, 2, 3])
def test_intersect_lists_windows_at_the_buffer_edge(cuda, width, gap):
    """A tile whose window holds exactly ``width`` ids: whole up to 4,093,
    sampled from 4,094 on, at each 16-byte phase of the list."""
    rng = np.random.default_rng(width + gap)
    ids = np.unique(rng.integers(0, 10**6, size=3 * width))[: 2 * width].astype(np.int32)
    l0 = np.array([ids[5], ids[5] + 1, ids[5 + width - 1]], np.int32)  # one miss
    lists = [(l0, np.arange(1, 4, dtype=np.int32)),
             (ids, rng.integers(1, 100, size=ids.size).astype(np.int32))]
    buf, table, n = pack_lists(lists, (0, 0, gap, 0), cuda)
    ca, nd = intersect.intersect_lists(buf, table, n)
    want_ca, want_nd = intersect.intersect_lists_plain(buf, table, n)
    assert torch.equal(ca, want_ca) and torch.equal(nd, want_nd)
    assert ca.tolist() == [True, ids[6] == ids[5] + 1, True]


def test_intersect_lists_on_a_side_stream(cuda):
    rng = np.random.default_rng(16)
    buf, table, n = pack_lists(lists_case(rng, 3000, (9000, 150_000)), (3, 1), cuda)
    want = intersect.intersect_lists_plain(buf, table, n)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = intersect.intersect_lists(buf, table, n)
    side.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("na,nq", [(1, 1), (513, 511), (1000, 100), (100, 1000),
                                   (5000, 5000), (0, 7), (60_001, 20_001)])
def test_intersect_kernel_matches_plain(cuda, na, nq):
    rng = np.random.default_rng(na * 31 + nq)
    a = sorted_unique(rng, na)
    q = np.unique(np.concatenate([
        rng.choice(a, size=min(nq, a.size), replace=False),
        rng.integers(0, 10**6, size=nq).astype(np.int32),
        np.array([-5, 2**31 - 2], np.int32),  # below and above the range
    ]))[:nq]
    launches = intersect.LAUNCHES
    found, pos = intersect.intersect_membership(on(cuda, a), on(cuda, q))
    torch.cuda.synchronize()
    assert intersect.LAUNCHES == launches + 1
    want_found, want_pos = intersect.intersect_membership_plain(on(cuda, a), on(cuda, q))
    assert torch.equal(found, want_found) and torch.equal(pos, want_pos)


@pytest.mark.parametrize("rows,m,nq", [(1, 1, 1), (1, 513, 511), (64, 4096, 300),
                                       (7, 65_536, 20_001), (3, 16, 1)])
def test_searchsorted_kernel_matches_plain(cuda, rows, m, nq):
    rng = np.random.default_rng(rows * 7 + m + nq)
    a = np.full((rows, m), INT_PAD, np.int32)
    for r in range(rows):
        row = sorted_unique(rng, int(rng.integers(1, m + 1)), hi=10 * m)
        a[r, : row.size] = row[:m]
    q = rng.integers(-5, 10 * m + 5, size=(rows, nq)).astype(np.int32)  # unsorted
    launches = ss.LAUNCHES
    got = ss.searchsorted(on(cuda, a), on(cuda, q))
    torch.cuda.synchronize()
    assert ss.LAUNCHES == launches + 1
    assert torch.equal(got, ss.searchsorted_plain(on(cuda, a), on(cuda, q)))


@pytest.mark.parametrize("m,k,pad", [(1, 2, 0), (100, 2, 0), (513, 3, 5),
                                     (1024, 4, 0), (40_000, 4, 17)])
def test_elca_segsum_kernel_matches_plain(cuda, m, k, pad):
    rng = np.random.default_rng(m * k + pad)
    ca = sorted_unique(rng, m)
    m = ca.size
    par = np.where(rng.random(m) < 0.8, ca[rng.integers(0, m, size=m)], -1)
    nd = rng.integers(1, 100, size=(k, m))
    ca = np.concatenate([ca, np.full(pad, INT_PAD, np.int32)])
    par = np.concatenate([par, np.full(pad, -1)])
    nd = np.concatenate([nd, np.zeros((k, pad), np.int64)], axis=1)
    args = [on(cuda, x) for x in (ca, par, nd)]
    launches = elca_segsum.LAUNCHES
    got = elca_segsum.elca_child_sums(*args)
    again = elca_segsum.elca_child_sums(*args)  # the memset re-zeroes each call
    torch.cuda.synchronize()
    assert elca_segsum.LAUNCHES == launches + 2
    want = elca_segsum.elca_child_sums_plain(*args)
    assert torch.equal(got, want) and torch.equal(again, want)


@pytest.mark.parametrize("semantics", ["slca", "elca", "ca"])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_run_query_chained_on_the_card_matches_cpu(cuda, semantics, k):
    rng = np.random.default_rng(k * 13 + len(semantics))
    for _ in range(3):
        lists = _random_item(rng, k)
        got = ops.run_query_chained(lists, semantics, device=cuda)
        want = ops.run_query_chained(lists, semantics, device="cpu")
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("semantics", ["slca", "elca", "ca"])
def test_ca_search_batch_chained_on_the_card_matches_cpu(cuda, semantics):
    from repro_torch.core.plan_cache import PlanCache

    rng = np.random.default_rng(len(semantics))
    items = [_random_item(rng, 3) for _ in range(5)]
    plan = PlanCache(backend="chained", min_rows=8, device=cuda)
    batch, _, _ = plan.pack(items, list(range(5)), semantics, "chained")
    launches = ss.LAUNCHES
    ids, mask = ca_search_batch(**batch, semantics=semantics, backend="chained")
    assert ss.LAUNCHES == launches + 1
    cpu = {n: v.cpu() for n, v in batch.items()}
    want_ids, want_mask = ca_search_batch(**cpu, semantics=semantics, backend="torch")
    assert torch.equal(ids.cpu(), want_ids) and torch.equal(mask.cpu(), want_mask)


def _call(name, dev):
    one = torch.ones(4, dtype=torch.int32, device=dev)
    if name == "searchsorted":
        return ss.searchsorted(one[None], one[None])
    if name == "intersect":
        return intersect.intersect_membership(one, one)
    if name == "intersect_lists":
        table = torch.tensor([[0, 0, 4], [0, 0, 4]], dtype=torch.int32, device=dev)
        return intersect.intersect_lists(one, table, 4)
    if name == "elca_segsum":
        return elca_segsum.elca_child_sums(one, one, one[None])
    ids = one[None]
    other = torch.full((1, 1, 4), int(INT_PAD), dtype=torch.int32, device=dev)
    return fused_search.fused_search_batch(
        ids, ids, ids, other, other, one[:1], semantics="slca"
    )


@pytest.mark.parametrize("name", ["searchsorted", "intersect", "elca_segsum", "fused",
                                  "intersect_lists"])
def test_cuda_tensor_without_a_kernel_raises(cuda, name, monkeypatch, tmp_path):
    """A kernel that cannot be built raises; it never falls back to plain."""
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    module = {"searchsorted": ss, "intersect": intersect, "intersect_lists": intersect,
              "elca_segsum": elca_segsum, "fused": fused_search}[name]
    launches = module.LAUNCHES
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _call(name, cuda)
    assert module.LAUNCHES == launches
    _call(name, "cpu")  # the CPU still takes the plain version


def test_current_stream_ptr_is_the_current_stream(cuda):
    """The launch path's private lookups name torch's current device and
    stream."""
    assert _build.current_device_index() == torch.cuda.current_device()
    assert _build.current_stream_ptr(cuda.index or 0) == torch.cuda.current_stream().cuda_stream
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        assert _build.current_stream_ptr(cuda.index or 0) == side.cuda_stream
    assert _build.current_stream_ptr(cuda.index or 0) != side.cuda_stream


def test_searchsorted_on_a_side_stream(cuda):
    rng = np.random.default_rng(15)
    a = np.full((64, 4096), INT_PAD, np.int32)
    for r in range(64):
        row = sorted_unique(rng, int(rng.integers(1, 4097)), hi=40_960)
        a[r, : row.size] = row[:4096]
    q = rng.integers(-5, 40_965, size=(64, 300)).astype(np.int32)
    a, q = on(cuda, a), on(cuda, q)
    want = ss.searchsorted_plain(a, q)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = ss.searchsorted(a, q)
    side.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_run_query_chained_launches_intersect_once(cuda, k):
    rng = np.random.default_rng(40 + k)
    lists = _random_item(rng, k)
    launches = intersect.LAUNCHES
    got = ops.run_query_chained(lists, "elca", device=cuda)
    assert intersect.LAUNCHES == launches + 1
    np.testing.assert_array_equal(got, ops.run_query_chained(lists, "elca", device="cpu"))
