"""The port's search roofline: the bytes model against hand counts, and the
``kernel.fused_round`` span carrying it with the reference's keys.

``search_pipeline_bytes`` counts the global-memory bytes of the port's own
kernels (``csrc/fused_search.cu`` on the route ``fused_search.route``
picks, and the chained kernels), not the TPU window walk, so its numbers
are compared with counts made by hand here, and only its keys and the
claim of the reference's test (``tests/test_fused.py``: fusion moves fewer
bytes on the vinyl/reissue query) with the reference.
"""
import numpy as np
import pytest

from repro.core import KeywordSearchEngine as RefEngine
from repro.core.plan_cache import PlanCache as RefPlanCache
from repro.data import generate_discogs_tree as ref_tree
from repro_torch.core import KeywordSearchEngine, PlanCache
from repro_torch.data import generate_discogs_tree
from repro_torch.roofline.analysis import (
    HW,
    fused_staging,
    search_pipeline_bytes,
    staged_ids,
)


def test_hw_is_the_h100_data_sheet():
    """H100 SXM data sheet; the network rate is the DGX H100's one 400 Gb/s
    ConnectX-7 per GPU."""
    assert HW == {"peak_flops": 989e12, "hbm_bw": 3.35e12, "nvlink_bw": 450e9,
                  "net_bw": 50e9}


@pytest.mark.parametrize("w,want", [(0, 0), (16, 16), (4093, 4093),
                                    (4094, 2047), (8192, 4096), (65_536, 4096)])
def test_staged_ids_follow_staged_of(w, want):
    assert staged_ids(w) == want


@pytest.mark.parametrize("shape,want", [
    ((16, 3, 64, "slca"), {"route": "rows", "window": 1, "bo": 64, "nob": 1}),
    ((2048, 2, 16_384, "elca"), {"route": "rows", "window": 4, "bo": 4096, "nob": 4}),
    ((4096, 2, 8192, "elca"), {"route": "tiles", "window": 16, "bo": 4096, "nob": 2}),
])
def test_fused_staging(shape, want):
    assert fused_staging(*shape) == want


def test_rows_route_slca_hand_count():
    # R 2, k 3, m0 16, mo 64: the rows route, a block of 64 threads, one
    # window a list of all 64 ids.  A row, fused: n0 + 2 other_n + 16 ids +
    # 2 x 64 staged + 16 parents = 163 ints = 652 B; keep 16 x 4 + 16 x 1 =
    # 80 B.  Chained, a list: 16 queries + 16 positions + 32 gathered + 16
    # NDesc out = 80 ints + 64 staged ints + 16 found bytes = 592 B, x 2;
    # compact: 2 x 16 found + 16 + 16 mask bytes + 2 x (16 ids + 16 parents)
    # x 4 = 320 B; keep: (2 x 16 + 16) x 4 + 16 = 208 B.
    b = search_pipeline_bytes(rows=2, k=3, m0=16, mo=64, semantics="slca")
    assert (b.route, b.window, b.bo, b.nob) == ("rows", 1, 64, 1)
    assert (b.fused_stream_bytes, b.fused_finalize_bytes, b.fused_bytes) == (1304, 160, 1464)
    assert (b.chained_membership_bytes, b.chained_compact_bytes,
            b.chained_segsum_bytes, b.chained_bytes) == (2368, 640, 416, 3424)


def test_tiles_route_elca_hand_count():
    # R 1, k 2, m0 4,096, mo 8,192: the tiles route, 16 blocks of 256 slots,
    # bo 4,096, the list's 8,192 ids staged once in all; L0 (4,096 ids, past
    # 4,093) staged by each block as 2,048 samples.  Membership pass: 16 x
    # (n0 + other_n) + 4,096 keys + 8,192 staged + ca and cnt planes 8,192 +
    # 16 x 2,048 L0 samples + 4,096 parents + 4,096 positions + sums 8,192 +
    # ndo 4,096 + 4,096 NDesc gathered = 77,856 ints; parent pass: 3 x 4,096
    # + nd0 and ndo 8,192 + 2 x 8,192 atomic sums = 36,864 ints; keep: ca +
    # ids + nd0 + 2 sums + ndo = 6 x 4,096 ints, + 4,096 ids and 4,096 mask
    # bytes.  Chained: 5 x 4,096 + 8,192 ints + 4,096 found bytes; compact
    # 3 x 4,096 mask bytes + 2 x 4 x 4,096 ints; elca_segsum 6 x 4,096 ints,
    # the keep rule 6 x 4,096 ints + 4,096 bytes.
    b = search_pipeline_bytes(rows=1, k=2, m0=4096, mo=8192, semantics="elca")
    assert (b.route, b.window, b.bo, b.nob) == ("tiles", 16, 4096, 2)
    assert b.fused_stream_bytes == 4 * (77_856 + 36_864) == 458_880
    assert b.fused_finalize_bytes == 4 * 7 * 4096 + 4096 == 118_784
    assert b.chained_membership_bytes == 4 * (5 * 4096 + 8192) + 4096 == 118_784
    assert b.chained_compact_bytes == 3 * 4096 + 4 * 2 * 4 * 4096 == 143_360
    assert b.chained_segsum_bytes == 4 * 12 * 4096 + 4096 == 200_704
    # every block restaging L0 gives the tiles route more global-memory
    # accesses than the chained kernels make in all: the honest count, kept
    # as it is
    assert b.fused_bytes == 577_664 > b.chained_bytes == 462_848


def test_single_keyword_ca_hand_count():
    # R 4, k 1, m0 = mo = 32: no other list.  Fused per row: n0 + 32 ids
    # (132 B); keep 32 x 5 B.  Chained: the mask (2 x 32 bytes) and the ids
    # copied (2 x 32 ints); no membership, no keep step.
    b = search_pipeline_bytes(rows=4, k=1, m0=32, mo=32, semantics="ca")
    assert (b.fused_stream_bytes, b.fused_finalize_bytes) == (4 * 132, 4 * 160)
    assert (b.chained_membership_bytes, b.chained_compact_bytes,
            b.chained_segsum_bytes) == (0, 4 * 320, 0)


def test_bandwidth_ms_at_the_h100_rate():
    b = search_pipeline_bytes(rows=8, k=4, m0=1024, mo=65_536, semantics="elca")
    assert b.fused_bw_ms == pytest.approx(b.fused_bytes / 3.35e12 * 1e3, rel=1e-12)
    assert b.chained_bw_ms == pytest.approx(b.chained_bytes / 3.35e12 * 1e3, rel=1e-12)
    assert b.bytes_ratio == b.chained_bytes / b.fused_bytes
    assert b.attrs()["fused_bytes"] == b.fused_bytes


def _fused_span(phases):
    names = [p["name"] for p in phases]
    assert "kernel.fused_round" in names
    return phases[names.index("kernel.fused_round")]["attrs"]


def test_fused_round_span_carries_the_model_with_the_reference_keys():
    """The reference test's case (``test_fused.py``): a traced fused
    vinyl/reissue query on 10 releases moves fewer bytes fused; the span's
    keys are the reference's plus ``route``."""
    eng = KeywordSearchEngine(
        generate_discogs_tree(n_releases=10, seed=5),
        plan_cache=PlanCache(backend="fused", device="cpu"), device="cpu",
    )
    phases: list = []
    got = eng._query(["vinyl", "reissue"], "slca", "dag", "fused", None, phases=phases)
    attrs = _fused_span(phases)
    assert attrs["fused_bytes"] < attrs["chained_bytes"]
    assert attrs["bytes_ratio"] > 1.0
    assert attrs["route"] == "rows"
    want = search_pipeline_bytes(rows=attrs["rows"], k=attrs["k"], m0=attrs["m0"],
                                 mo=attrs["mo"], semantics="slca").attrs()
    assert {key: attrs[key] for key in want} == want

    ref = RefEngine(ref_tree(n_releases=10, seed=5), plan_cache=RefPlanCache(backend="fused"))
    ref_phases: list = []
    want_ids = ref._query(["vinyl", "reissue"], "slca", "dag", "fused", None,
                          phases=ref_phases)
    np.testing.assert_array_equal(got, want_ids)
    ref_attrs = _fused_span(ref_phases)
    assert set(attrs) == set(ref_attrs) | {"route"}
    for key in ("backend", "semantics", "rows", "k", "m0", "mo"):
        assert attrs[key] == ref_attrs[key], key
