"""Port's chained kernels and query path == the reference's Pallas ones.

On the CPU each port kernel wrapper runs its plain PyTorch version; the
reference runs its Pallas kernel the way its own tests do (interpret mode).
Both get the same seeded numpy inputs; outputs are integers and must be
equal with no tolerance.  The port's ``ref.py`` oracles and ``brute`` are
held against the reference's too.  The CUDA kernels themselves are held
against their plain versions in ``test_torch_chained_cuda.py``; the engine
and service routes in ``test_torch_chained_engine.py``.
"""
import numpy as np
import pytest
import torch
from test_fused import keyword_list, preorder_tree, random_items
from test_torch_chained_cuda import lists_case, pack_lists, segsum_case

from repro.core import NodeSpec, build_tree
from repro.core import brute as ref_brute
from repro.core.plan_cache import PlanCache as RefPlanCache
from repro.core.search_vec import ca_search_batch as ref_ca_search_batch
from repro.data import QUERIES
from repro.data import generate_discogs_tree as ref_generate
from repro.kernels import ops as ref_ops
from repro_torch.core import brute
from repro_torch.core.idlist import IDList
from repro_torch.core.search_vec import ca_search_batch
from repro_torch.data import generate_discogs_tree
from repro_torch.kernels import _build, elca_segsum, intersect, ops, ref, searchsorted
from repro_torch.kernels.shapes import INT_PAD, pad_to


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32))


def sorted_unique(rng, n, hi=10**6):
    return np.unique(rng.integers(0, hi, size=n).astype(np.int32))


@pytest.fixture(autouse=True)
def no_kernel_launches():
    """CPU tensors take the plain versions: no test here launches a kernel."""
    before = (searchsorted.LAUNCHES, intersect.LAUNCHES, elca_segsum.LAUNCHES)
    yield
    assert (searchsorted.LAUNCHES, intersect.LAUNCHES, elca_segsum.LAUNCHES) == before


# --------------------------------------------------------------------------- #
# The three kernel wrappers against the reference ops and the ref oracles
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("na,nq,block", [
    (1000, 100, 128),
    (100, 1000, 128),
    (4096, 512, 512),
    (513, 511, 128),
    (1, 1, 128),
    (5000, 5000, 256),
])
def test_intersect_membership_matches_reference(na, nq, block):
    rng = np.random.default_rng(na * 7919 + nq)
    a = sorted_unique(rng, na)
    # sorted members and non-members, plus queries below and above a's range
    q = np.unique(np.concatenate([
        rng.choice(a, size=min(nq, a.size), replace=False),
        rng.integers(0, 10**6, size=nq).astype(np.int32),
    ]))[:nq]
    if nq > 1:
        q = np.unique(np.concatenate([q, np.array([-5, 2**31 - 2], np.int32)]))
    want_found, want_pos = ref_ops.intersect_membership(a, q, bq=block, ba=block)
    found, pos = ops.intersect_membership(t(a), t(q))
    assert found.dtype == torch.bool and pos.dtype == torch.int32
    np.testing.assert_array_equal(found.numpy(), want_found)
    np.testing.assert_array_equal(pos.numpy(), want_pos)  # 0 on every miss
    oracle_found, oracle_pos = ref.membership_ref(
        t(pad_to(a, block, INT_PAD)), t(pad_to(q, block, INT_PAD))
    )
    np.testing.assert_array_equal(found.numpy(), oracle_found[: q.size].numpy())
    np.testing.assert_array_equal(pos.numpy(), oracle_pos[: q.size].numpy())


def test_intersect_membership_misses_write_zero():
    a = np.array([10, 20, 30], np.int32)
    q = np.array([5, 10, 25, 30, 99], np.int32)
    found, pos = ops.intersect_membership(t(a), t(q))
    assert found.tolist() == [False, True, False, True, False]
    assert pos.tolist() == [0, 0, 0, 2, 0]
    found, pos = ops.intersect_membership(t(a[:0]), t(q))  # empty list
    assert not found.any() and not pos.any()


INTERSECT_LISTS_CASES = {  # name: (L0 length, other lengths, mode)
    "random": (300, (900, 2000, 5000), "mixed"),
    "l0-length-1": (1, (40, 7, 300), "mixed"),
    "no-hits": (200, (500, 300, 100), "none"),
    "all-hits": (150, (150, 600, 2000), "all"),
    "lists-of-length-1": (1, (1, 1, 1), "all"),
}


@pytest.mark.parametrize("case", INTERSECT_LISTS_CASES)
@pytest.mark.parametrize("k", [2, 3, 4])
def test_intersect_lists_matches_reference(k, case):
    """ca and nd of one chained query == the reference kernel (interpret
    mode) per other list, with its NDesc gathers as run_query_pallas makes
    them, on lists at any 16-byte phase of the buffer."""
    n0, others, mode = INTERSECT_LISTS_CASES[case]
    rng = np.random.default_rng(2000 + 10 * k + len(case))
    lists = lists_case(rng, n0, others[: k - 1], mode)
    buf, table, n = pack_lists(lists, gaps=(3, 0, 1, 2))
    ca, nd = intersect.intersect_lists(buf, table, n)
    assert ca.dtype == torch.bool and nd.dtype == torch.int32
    assert tuple(ca.shape) == (n,) and tuple(nd.shape) == (k, n)
    (l0, nd0), *rest = lists
    want_ca = np.ones(n, bool)
    want_nd = [nd0]
    for ids, ndesc in rest:
        found, pos = ref_ops.intersect_membership(ids, l0, bq=128, ba=128)
        want_ca &= found
        want_nd.append(ndesc[np.minimum(pos, len(ids) - 1)])
    np.testing.assert_array_equal(ca.numpy(), want_ca)
    np.testing.assert_array_equal(nd.numpy(), np.stack(want_nd))
    if mode == "none":
        assert not ca.any()
    if mode == "all":
        assert ca.all()


def test_intersect_lists_refuses_a_bad_table():
    buf = torch.arange(8, dtype=torch.int32)
    with pytest.raises(ValueError, match=r"\[k, 3\] table"):
        intersect.intersect_lists(buf, buf[:6].view(3, 2), 2)
    with pytest.raises(ValueError, match="int32"):
        intersect.intersect_lists(buf, buf[:6].view(2, 3).long(), 2)


def test_run_query_chained_one_intersect_call_per_query(monkeypatch):
    """run_query_chained asks intersect_lists once per query, with every
    list in one buffer and the table as a view of it."""
    seen = []

    def spy(buf, table, n):
        seen.append((buf, table, n))
        return intersect.intersect_lists_plain(buf, table, n)

    monkeypatch.setattr(ops, "intersect_lists", spy)
    rng = np.random.default_rng(8)
    lists = [IDList(l.ids, l.pidpos, l.ndesc) for l in random_query_lists(rng, 3)]
    want = ref_ops.run_query_pallas(lists, semantics="elca")
    np.testing.assert_array_equal(ops.run_query_chained(lists, "elca", device="cpu"), want)
    (buf, table, n), = seen
    assert table.data_ptr() == buf.data_ptr() + 4 * (buf.numel() - 9)
    assert table[:, 2].tolist() == sorted(len(l) for l in lists) and n == table[0, 2]


@pytest.mark.parametrize("na,nq", [(1000, 100), (37, 513), (2048, 2048), (1, 7)])
def test_searchsorted_positions_matches_reference(na, nq):
    rng = np.random.default_rng(na + nq)
    a = sorted_unique(rng, na, hi=10**5)
    q = rng.integers(-5, 10**5 + 5, size=nq).astype(np.int32)  # unsorted
    want = ref_ops.searchsorted_positions(a, q, bq=128, ba=128)
    got = ops.searchsorted_positions(t(a), t(q))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    oracle = ref.searchsorted_ref(t(pad_to(a, 128, INT_PAD)), t(q))
    np.testing.assert_array_equal(got.numpy(), oracle.numpy())


def test_searchsorted_batched_rows_with_pad_tails():
    rng = np.random.default_rng(3)
    rows = np.full((6, 64), INT_PAD, np.int32)
    for r in range(6):
        row = sorted_unique(rng, int(rng.integers(1, 60)), hi=500)
        rows[r, : row.size] = row
    q = rng.integers(-3, 503, size=(6, 40)).astype(np.int32)
    got = searchsorted.searchsorted(t(rows), t(q))
    for r in range(6):
        np.testing.assert_array_equal(
            got[r].numpy(), np.searchsorted(rows[r], q[r], side="left")
        )


@pytest.mark.parametrize("m,k", [(100, 2), (513, 3), (1024, 4), (3, 2)])
def test_elca_child_sums_matches_reference(m, k):
    rng = np.random.default_rng(m * k)
    ca = sorted_unique(rng, m)
    m = ca.size
    par = np.where(rng.random(m) < 0.8, ca[rng.integers(0, m, size=m)], -1)
    par = par.astype(np.int32)
    nd = rng.integers(1, 100, size=(k, m)).astype(np.int32)
    want = ref_ops.elca_child_sums(ca, par, nd, bi=128, bj=128)
    got = ops.elca_child_sums(t(ca), t(par), t(nd))
    assert got.dtype == torch.int32 and tuple(got.shape) == (k, m)
    np.testing.assert_array_equal(got.numpy(), want)
    oracle = ref.elca_segsum_ref(
        t(pad_to(ca, 128, INT_PAD)), t(pad_to(par, 128, -1)), t(pad_to(nd, 128, 0))
    )
    np.testing.assert_array_equal(got.numpy(), oracle[:, :m].numpy())
    # an INT32_MAX tail on ca (-1 on par, 0 on nd) changes nothing
    padded = ops.elca_child_sums(
        t(pad_to(ca, 128, INT_PAD)), t(pad_to(par, 128, -1)), t(pad_to(nd, 128, 0))
    )
    np.testing.assert_array_equal(padded[:, :m].numpy(), want)
    assert not padded[:, m:].any()


@pytest.mark.parametrize("na,nq,order", [(20_000, 3_000, "random"),
                                          (20_000, 3_000, "ascending"),
                                          (9_000, 1_500, "random")])
def test_searchsorted_rows_past_the_stage_match_reference(na, nq, order):
    """Rows wider than the 4,093 ids the kernel stages whole (the card
    samples them): the plain version == the reference kernel."""
    rng = np.random.default_rng(na + nq + len(order))
    a = sorted_unique(rng, na, hi=10**6)
    q = rng.integers(-5, 10**6 + 5, size=nq).astype(np.int32)
    if order == "ascending":
        q = np.sort(q)
    want = ref_ops.searchsorted_positions(a, q, bq=1024, ba=4096)
    got = ops.searchsorted_positions(t(a), t(q))
    np.testing.assert_array_equal(got.numpy(), want)
    rows = np.stack([pad_to(a, 4096, INT_PAD), pad_to(a + 1, 4096, INT_PAD)])
    batched = searchsorted.searchsorted(t(rows), t(np.stack([q, q])))
    np.testing.assert_array_equal(batched[0].numpy(), want)
    np.testing.assert_array_equal(batched[1].numpy(), np.searchsorted(a + 1, q, side="left"))


@pytest.mark.parametrize("kind,mi,mj,k,pad", [
    ("star", 2_000, 5_000, 2, 0),
    ("star", 3, 3_000, 1, 3),
    ("hot", 3_000, 3_000, 3, 0),
    ("hot", 500, 2_000, 4, 5),
])
def test_elca_child_sums_star_and_hot_parents_match_reference(kind, mi, mj, k, pad):
    """A star (every child under one parent) and a few hot parents among
    cold ones, mi != mj, INT_PAD tails: the plain version == the reference
    kernel (interpret mode)."""
    rng = np.random.default_rng(mi + mj + k)
    ca, par, nd = (x.astype(np.int32) for x in segsum_case(rng, kind, mi, mj, k, pad))
    want = ref_ops.elca_child_sums(ca, par, nd, bi=1024, bj=1024)
    got = ops.elca_child_sums(t(ca), t(par), t(nd))
    np.testing.assert_array_equal(got.numpy(), want)
    if kind == "star":
        assert (np.count_nonzero(want, axis=1) <= 1).all()


def test_elca_route_mirrors_the_source():
    """``elca_segsum.route`` (what ``chip_smoke.py`` counts launches by)
    uses the kernel source's own limits."""
    import re

    text = (_build.CSRC / "elca_segsum.cu").read_text()
    limits = dict(re.findall(r"constexpr int (kOneBlock|kDenseInts) = (\d+);", text))
    assert int(limits["kOneBlock"]) == elca_segsum.ONE_BLOCK
    assert int(limits["kDenseInts"]) == elca_segsum.DENSE_INTS
    assert elca_segsum.route(4000, 1024, 4) == "dense"
    assert elca_segsum.route(4000, 1025, 4) == "tiles"  # children past one block
    assert elca_segsum.route(4097, 1024, 4) == "tiles"  # output past shared memory


def test_wrappers_refuse_what_the_kernels_cannot_take():
    a = torch.arange(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        ops.intersect_membership(a.long(), a)
    with pytest.raises(ValueError, match="contiguous"):
        searchsorted.searchsorted(a.reshape(2, 4).t(), a.reshape(4, 2))
    with pytest.raises(ValueError, match="want a"):
        searchsorted.searchsorted(a.reshape(2, 4), a.reshape(4, 2))
    with pytest.raises(ValueError, match="want ca"):
        ops.elca_child_sums(a, a, a.reshape(2, 4))
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.intersect_membership(a.to("meta"), a.to("meta"))
    with pytest.raises(ValueError, match="is on"):
        ops.intersect_membership(a, a.to("meta"))


def test_int32_device_returns_the_index_and_names_the_fault():
    a = torch.arange(8, dtype=torch.int32)
    assert _build.int32_device(a, a, a.reshape(2, 4)) == -1  # the CPU
    with pytest.raises(ValueError, match="input 1 must be int32"):
        _build.int32_device(a, a.long())
    with pytest.raises(ValueError, match="input 2 must be contiguous"):
        _build.int32_device(a, a, a.reshape(2, 4).t())
    with pytest.raises(ValueError, match="input 1 is on meta"):
        _build.int32_device(a, a.to("meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        _build.int32_device(a.to("meta"))


# --------------------------------------------------------------------------- #
# The batched search with the chained membership step
# --------------------------------------------------------------------------- #


def to_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("semantics", ["slca", "elca", "ca"])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_ca_search_batch_chained_matches_reference(semantics, k):
    rng = np.random.default_rng(900 + k * 10 + len(semantics))
    cache = RefPlanCache(backend="pallas")
    items = random_items(rng, int(rng.integers(2, 6)), k)
    batch, _, _ = cache.pack(items, list(range(len(items))), semantics, "pallas")
    want_ids, want_mask = ref_ca_search_batch(
        **batch, semantics=semantics, backend="pallas"
    )
    got_ids, got_mask = ca_search_batch(
        **to_torch(batch), semantics=semantics, backend="chained"
    )
    torch_ids, torch_mask = ca_search_batch(
        **to_torch(batch), semantics=semantics, backend="torch"
    )
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    assert torch.equal(got_ids, torch_ids) and torch.equal(got_mask, torch_mask)


def test_membership_chained_keeps_the_registry_contract():
    rows = t([[1, 3, 5, INT_PAD], [2, 4, INT_PAD, INT_PAD]])
    valid = t([3, 2])
    q = t([[3, 4, 5, INT_PAD], [2, 9, 4, INT_PAD]])
    found, pos = ops.membership_chained(rows, valid, q)
    assert pos.dtype == torch.int64  # gathered with by the batched search
    assert found.tolist() == [[True, False, True, False], [True, False, True, False]]
    assert pos.tolist() == [[1, 2, 2, 3], [0, 2, 1, 2]]


# --------------------------------------------------------------------------- #
# run_query_chained against the reference run_query_pallas
# --------------------------------------------------------------------------- #


def random_query_lists(rng, k):
    n = int(rng.integers(5, 400))
    par = preorder_tree(rng, n)
    return [keyword_list(rng, n, par, int(rng.integers(1, max(2, n // 2))))
            for _ in range(k)]


@pytest.mark.parametrize("semantics", ["slca", "elca", "ca"])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_run_query_chained_matches_reference(semantics, k):
    rng = np.random.default_rng(1200 + 7 * k + len(semantics))
    for trial in range(2):
        lists = random_query_lists(rng, k)
        want = ref_ops.run_query_pallas(lists, semantics=semantics)
        port_lists = [IDList(l.ids, l.pidpos, l.ndesc) for l in lists]
        got = ops.run_query_chained(port_lists, semantics=semantics, device="cpu")
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want, err_msg=f"trial {trial}")


def test_run_query_chained_empty_and_bad_semantics():
    rng = np.random.default_rng(5)
    lists = [IDList(l.ids, l.pidpos, l.ndesc) for l in random_query_lists(rng, 2)]
    empty = IDList(np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0, np.int32))
    assert ops.run_query_chained([], device="cpu").size == 0
    assert ops.run_query_chained([lists[0], empty], device="cpu").size == 0
    with pytest.raises(ValueError, match="semantics"):
        ops.run_query_chained(lists, semantics="lca", device="cpu")


# --------------------------------------------------------------------------- #
# The brute-force oracle
# --------------------------------------------------------------------------- #


BRUTE_WORDS = ["usa", "english", "vinyl", "rock", "jazz", "red"]


def shared_subtree_tree(seed: int, n_target: int):
    """A random tree whose specs reuse earlier subtrees (nested redundancy)."""
    rng = np.random.default_rng(seed)
    pool: list[NodeSpec] = []
    count = [0]

    def make(depth: int) -> NodeSpec:
        count[0] += 1
        if pool and rng.random() < 0.3:
            return pool[int(rng.integers(0, len(pool)))]
        n_children = int(rng.integers(0, 4)) if depth < 5 and count[0] < n_target else 0
        words = rng.choice(BRUTE_WORDS, size=int(rng.integers(0, 3)))
        node = NodeSpec(
            label=f"tag{int(rng.integers(0, 4))}", text=" ".join(words),
            children=[make(depth + 1) for _ in range(n_children)],
        )
        if rng.random() < 0.4:
            pool.append(node)
        return node

    return build_tree(NodeSpec("root", children=[make(1) for _ in range(3)]))


def brute_cases():
    """(port tree, reference tree, keyword-id queries) on small trees."""
    for seed in range(3):  # random trees with shared subtrees
        tree = shared_subtree_tree(seed, 40)
        kws = [tree.vocab.get(w) for w in ("usa", "english", "vinyl", "rock")]
        yield tree, tree, [kws[:1], kws[:2], kws[1:4], [kws[2], -1]]
    port_tree = generate_discogs_tree(n_releases=12, seed=4)
    tree = ref_generate(n_releases=12, seed=4)
    yield port_tree, tree, [
        [tree.vocab.get(w) for w in words] for _c, words in QUERIES.values()
    ]


def test_brute_matches_reference():
    for port_tree, tree, queries in brute_cases():
        for q in queries:
            for fn in ("ca_nodes", "slca_nodes", "elca_nodes"):
                got = getattr(brute, fn)(port_tree, q)
                want = getattr(ref_brute, fn)(tree, q)
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want, err_msg=f"{fn} {q}")
