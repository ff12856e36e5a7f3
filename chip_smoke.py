#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA card and check them.

    python3 chip_smoke.py            # from the repository root, one CUDA card

Phases (any failure exits non-zero, and no result line is printed):

  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the five kernels from ``src/repro_torch/csrc`` with nvcc, one
     process per source, all at once, with the time of each, and import
     each as a Python extension module;
  3. the fused search path at a realistic size: the synthetic discogs corpus
     of 20,000 releases (about 1.03 M nodes), ``KeywordSearchEngine`` on
     ``cuda``, the paper's nine queries x slca/elca x the tree and DAG
     indexes with ``backend="fused"`` through ``engine.query``, then a
     ``QueryService(backend="fused")`` answering the 18 DAG queries
     submitted together.  The kernel's launch count is zeroed just before
     and read just after; the calls per route (rows / tiles) and each
     batch's shape are printed;
  4. every answer equals the port's ``"scalar"`` backend (the paper's host
     algorithms) and the ``"torch"`` backend on the same engine;
  5. the chained path on the same engine: warmed on Q4-Q9, then one counted
     pass of the 36 engine queries with ``backend="chained"`` and a
     ``QueryService(backend="chained")`` answering the 18 DAG queries in one
     window; the searchsorted, intersect and elca_segsum launch counts are
     zeroed just before and read just after, each must be > 0, and every
     answer must equal ``"scalar"``; the sizes of the windows the intersect
     kernel stages on those calls are printed;
  6. the fused kernel against its plain PyTorch version, byte for byte, on
     seeded random packed batches (k = 1..4 x slca/elca/ca, all-pad rows,
     single-element lists, R up to 64, rows past the rows route) and on
     every batch the counted fused path launched (engine and service alike,
     kept as they were packed, and each forced down every route that can
     take it too), with CUDA-event times of each batch and of one pass of
     them all, the plain version's times, the bound, the device time of
     each device op, and passes with the rows route's limit at 0, 2,048,
     4,096 and 8,192 slots;
  7. each chained kernel against its plain version the same way, on seeded
     random shapes (searchsorted: windows staged whole and sampled at every
     16-byte phase, queries in random order, the service's widest call;
     elca_segsum: a star, a few hot parents, no parents, K = 1..4 with
     INT32_MAX tails) and on every call the counted chained path made, with
     the time of ``torch.searchsorted`` on the same inputs beside the
     searchsorted and intersect kernels (for intersect one call per (list,
     L0) pair; no single PyTorch call computes the ELCA child sums), the
     library pass's device time, and each kernel's device time per device
     op; then a host-clock breakdown of one main-path call of each chained
     wrapper and of ``fused_search`` on each route: the wrapper's checks,
     allocation and pointers, the entry lookup, the device guard, the stream
     lookup, and the entry call beside a ``ctypes`` call of the same C
     function in the same library (timed in turns), beside the whole call
     (and ``torch.searchsorted``, in turns);
  8. first, one decode-attention call at the decode_32k cell's shape (B
     128, T 32,768) against its plain version, timed by CUDA events, by a
     profiled pass of 10 and beside ``scaled_dot_product_attention``; then
     LM serving: SmolLM-135M at its published widths in bf16 with seeded
     random weights, through ``repro_torch.launch.serve``: 8 requests of
     1,024 prompt tokens (768 shared) + 64 generated, once with one batched
     prefill and once with ``--prefix-dag``.  The decode_attention launch
     count is zeroed just before each run and read just after: 30 layers x
     63 decode steps each.  The last decode step's logits are held against
     a prefill over the same tokens, in bf16 and in a float32 copy of the
     model; the kernel against its plain version on seeded random shapes
     and on every call the two runs made (and two kernel calls bit for bit
     equal), with one pass of those calls timed beside
     ``scaled_dot_product_attention`` (CUDA events and profiler device
     time) and the host breakdown of one call; last, one profiled serving
     run of 8 decode steps (device busy and idle share);
  9. a ``{"kernels": [...]}`` line with all five kernels, the nvidia-smi
     line, and as the last line ``{"ok": true, "device": {...}}``.

Profiler device times are reported only from a pass in which the profiler
recorded every launch the pass made (``expected_launches``), else as not
measured.  Per-call details go to ``chiprun_out/chip_smoke_rounds.json``
(search) and ``chiprun_out/chip_smoke_lm.json`` (LM).
"""
from __future__ import annotations

import importlib
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

DEVICE = "cuda"
N_RELEASES = 20_000  # the paper's corpus is the 4.2 M-release discogs dump
SEMANTICS = ("slca", "elca")
INDEXES = ("dag", "tree")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
SCALAR_OPS_PER_S = 67e12  # H100 SXM 32-bit rate outside the tensor cores
TIMING_REPS = 25
OUT_DIR = ROOT / "chiprun_out"


class Kernel(NamedTuple):
    """One kernel of the port, keyed in ``KERNELS`` by its module's name."""

    wrapper: str  # its wrapper in repro_torch.kernels.<name>; + "_plain": the
    # plain version; the chained path calls it by this name in kernels.ops
    replaces: str  # the TPU kernel, file:line
    device_ops: tuple[str, ...]  # its device operations, as the profiler names them
    library: str | None  # the function computing the same, if one does: a
    # torch function's name, or a function of this script (library_args maps
    # the wrapper's arguments to its arguments)


KERNELS = {
    # the rows route's one kernel, and the tiles route's three
    "fused_search": Kernel(
        "fused_search_batch", "src/repro/kernels/fused_search.py:62",
        ("fused_rows_kernel", "membership_kernel", "parent_kernel", "keep_kernel"),
        None,
    ),
    "searchsorted": Kernel(
        "searchsorted", "src/repro/kernels/searchsorted.py:18",
        ("searchsorted_kernel",), "searchsorted",
    ),
    # the library calls give the positions, one torch.searchsorted per (list,
    # L0) pair; found is one compare more, and the NDesc one gather more
    "intersect": Kernel(
        "intersect_lists", "src/repro/kernels/intersect.py:36",
        ("intersect_lists_kernel",), "searchsorted_pairs",
    ),
    # no single call: the plain version is searchsorted + index_add_
    "elca_segsum": Kernel(
        "elca_child_sums", "src/repro/kernels/elca_segsum.py:24",
        ("segsum_dense_kernel", "segsum_tiles_kernel", "Memset"), None,
    ),
    # the library call (scaled_dot_product_attention) is sdpa_call below
    # the split kernel and, when T is split, the combine kernel
    "decode_attention": Kernel(
        "decode_attention", "src/repro/kernels/decode_attention.py:33",
        ("decode_attention_split", "decode_attention_combine"), None,
    ),
}
CHAINED = ("searchsorted", "intersect", "elca_segsum")  # the chained path's


def module(name: str):
    return importlib.import_module(f"repro_torch.kernels.{name}")


def functions(name: str):
    """(kernel wrapper, plain version, library call or None) of a kernel; the
    library call takes ``library_args`` of the wrapper's arguments."""
    import torch

    k, mod = KERNELS[name], module(name)
    library = None
    if k.library:
        library = globals().get(k.library) or getattr(torch, k.library)
    return getattr(mod, k.wrapper), getattr(mod, k.wrapper + "_plain"), library


def list_views(buf, table) -> list:
    """The lists of an ``intersect_lists`` call: [(ids, ndesc)], L0 first."""
    return [(buf[i : i + n], buf[d : d + n]) for i, d, n in table.tolist()]


def library_args(name: str, args) -> tuple:
    """The library call's arguments for a wrapper call's (made once, outside
    any timing): for intersect, L0's ids and the other lists' ids."""
    if name != "intersect":
        return args
    (ids0, _), *others = list_views(args[0], args[1])
    return ids0, tuple(ids for ids, _ in others)


def searchsorted_pairs(ids0, lists) -> list:
    """One ``torch.searchsorted`` of L0 in each other list: the positions
    ``intersect_lists`` computes, by the library, one call per pair."""
    import torch

    return [torch.searchsorted(ids, ids0) for ids in lists]


def library_calls(name: str, calls) -> int:
    """Library launches of a pass over ``calls`` (the wrapper's arguments)."""
    if name == "intersect":
        return sum(args[1].shape[0] - 1 for args in calls)
    return len(calls)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------- #
# Seeded random corpora: random trees, ancestor-closed lists
# --------------------------------------------------------------------------- #


def random_item(rng, k: int, max_nodes: int = 4000, min_nodes: int = 5,
                near: int | None = 8):
    """k ancestor-closed IDLists over one random tree (parents have lower ids:
    one of the ``near`` before, or any before when None)."""
    from repro_torch.core.idlist import IDList, make_pidpos

    n = int(rng.integers(min_nodes, max_nodes))
    par = np.full(n, -1, np.int64)
    for i in range(1, n):
        par[i] = int(rng.integers(0 if near is None else max(0, i - near), i))
    lists = []
    for _ in range(k):
        nd: dict[int, int] = {}
        direct = rng.choice(n, size=int(rng.integers(1, max(2, n // 2))), replace=False)
        for d in direct:
            v = int(d)
            while v >= 0:
                nd[v] = nd.get(v, 0) + 1
                v = int(par[v])
        ids = np.array(sorted(nd), dtype=np.int32)
        ndesc = np.array([nd[i] for i in sorted(nd)], dtype=np.int32)
        lists.append(IDList(ids=ids, pidpos=make_pidpos(ids, par), ndesc=ndesc))
    return lists


def single_element_item(k: int):
    from repro_torch.core.idlist import IDList

    one = IDList(
        ids=np.array([0], np.int32), pidpos=np.array([-1], np.int32),
        ndesc=np.array([1], np.int32),
    )
    return [one] * k


def random_batches():
    """(label, per_item, semantics, min_rows) of the random kernel checks."""
    rng = np.random.default_rng(0)
    cases = []
    for k in (1, 2, 3, 4):
        for sem in ("slca", "elca", "ca"):
            items = [random_item(rng, k) for _ in range(int(rng.integers(1, 9)))]
            cases.append((f"random k={k} {sem}", items, sem, 1))
    items = [random_item(rng, 3) for _ in range(5)]
    cases.append(("all-pad rows (5 of 64 used)", items, "elca", 64))
    for k in (1, 2, 4):
        cases.append((f"single-element k={k}", [single_element_item(k)], "slca", 1))
        cases.append((f"single-element k={k} elca", [single_element_item(k)], "elca", 1))
    items = [random_item(rng, 2) for _ in range(64)]
    for sem in ("slca", "elca", "ca"):
        cases.append((f"R=64 k=2 {sem}", items, sem, 1))
    items = [random_item(rng, 3, 60_000, 20_000, near=None) for _ in range(2)]
    for sem in ("slca", "elca", "ca"):  # rows past the rows route's 2,048 slots
        cases.append((f"long rows k=3 {sem}", items, sem, 1))
    return cases


# --------------------------------------------------------------------------- #
# Kernel vs plain
# --------------------------------------------------------------------------- #


def cuda_ms(fn) -> float:
    """Median ms of ``fn`` by CUDA events, after one warm call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMING_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def profile_pass(fn) -> tuple[float, dict[str, float], dict[str, int]]:
    """Run ``fn`` twice under torch.profiler, a warm-up step and then a
    recorded step: (wall ms, {device op: ms}, {device op: events}) of the
    recorded one.

    Device ops are the kernels and copies the profiler saw on the card (not
    the ``ProfilerStep`` span it also puts there, which covers the whole
    step).  The warm-up step has the device tracing running before the
    recorded pass starts: passes traced from a cold start lost some of
    their events.
    """
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof.step()
    dev: dict[str, float] = {}
    events: dict[str, int] = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA and not evt.name.startswith("ProfilerStep"):
            dev[evt.name] = dev.get(evt.name, 0.0) + evt.time_range.elapsed_us() / 1e3
            events[evt.name] = events.get(evt.name, 0) + 1
    return wall_ms, dev, events


def kernel_device_ms(dev: dict[str, float], name: str) -> float:
    """Device ms of kernel ``name``'s device operations in a profile."""
    ops = KERNELS[name].device_ops
    return sum(ms for op, ms in dev.items() if any(p in op for p in ops))


def expected_launches(name: str, calls) -> dict[str, int]:
    """{device op: launches} a pass of ``calls`` (each a wrapper's arguments)
    makes of kernel ``name``, by the rules of its C entry point."""
    n = dict.fromkeys(KERNELS[name].device_ops, 0)
    for args in calls:
        if name == "fused_search":
            batch, sem = args
            rows, m0 = batch["ids0"].shape
            if rows and m0:
                for op, count in fused_launches(fused_route(batch, sem), sem).items():
                    n[op] += count
        elif name == "searchsorted":
            a, q = args
            n["searchsorted_kernel"] += a.shape[0] > 0 and q.shape[1] > 0
        elif name == "intersect":
            n["intersect_lists_kernel"] += args[2] > 0
        elif name == "elca_segsum":
            ca, par, nd = args
            if ca.numel() and nd.shape[0]:
                if module(name).route(ca.numel(), par.numel(), nd.shape[0]) == "dense":
                    n["segsum_dense_kernel"] += 1
                else:  # a memset, then the kernel when there is a child
                    n["Memset"] += 1
                    n["segsum_tiles_kernel"] += par.numel() > 0
        else:
            q, k = args[0], args[1]
            b, h = q.shape[:2]
            t, hk = k.shape[1], k.shape[2]
            if b and h:
                n["decode_attention_split"] += 1
                n["decode_attention_combine"] += module(name).split_plan(b, hk, h // hk, t)[1] > 1
    return n


def device_pass_ms(fn, expect, name: str | None = None, tries: int = 3,
                   ops_ms: dict | None = None) -> tuple[float | None, dict[str, int]]:
    """(device ms of one pass, {device op: events recorded}) from
    ``profile_pass``.

    ``name`` is a kernel of ``KERNELS``: its device ops count, and
    ``expect`` is ``expected_launches`` of the pass.  ``None`` is a library
    call: every device op counts, ``expect`` is the number of calls, and
    each event of the op with the most time is one call.  The time is
    reported only from a pass whose every expected event the profiler
    recorded, no more and no fewer; a pass recorded in part is profiled
    again, up to ``tries`` times, and after that the time is None (not
    measured) beside the counts of the last try.  ``ops_ms``, when given
    with a kernel's ``name``, receives the ms of each of its device ops.
    """
    for _ in range(tries):
        _, dev, events = profile_pass(fn)
        if name is not None:
            counts = {p: sum(n for op, n in events.items() if p in op)
                      for p in KERNELS[name].device_ops}
            complete, total = counts == expect, kernel_device_ms(dev, name)
        else:
            counts = events
            complete = bool(dev) and events[max(dev, key=dev.get)] == expect
            total = sum(dev.values())
        if complete:
            if ops_ms is not None and name is not None:
                ops_ms.update({p: sum(ms for op, ms in dev.items() if p in op)
                               for p in KERNELS[name].device_ops})
            return total, counts
    return None, counts


def device_text(ms: float | None, counts: dict[str, int], expect) -> str:
    if ms is None:
        return f"not measured (the profiler recorded {counts}, want {expect})"
    return f"{ms:.4f} ms"


# the packed inputs each semantics reads: SLCA needs no NDesc, CA no parents
READS = {
    "slca": ("ids0", "pid0", "n0", "other_ids"),
    "elca": ("ids0", "pid0", "ndesc0", "n0", "other_ids", "other_ndesc"),
    "ca": ("ids0", "n0", "other_ids"),
}


def bound_of(batch: dict, semantics: str) -> tuple[float, str, int, int]:
    """Least time for the function on this batch: (ms, bound_by, bytes, ops).

    Bytes: the valid entries of each input the semantics reads (``READS``;
    the first ``n0`` of each L0 row, the first ``other_n`` of each other
    list, never the pad tail a bucket adds) read once, keep_ids (4 B) and
    keep_mask (1 B) written once.  Operations, counted on this batch's
    data: one binary search of each other list's valid entries per valid L0
    entry, then for SLCA/ELCA one binary search of the valid L0 entries per
    CA for its parent and one add per CA and list, plus one compare per
    slot for the keep rule (32-bit integer work against the card's 32-bit
    scalar rate).
    """
    rows, m0 = batch["ids0"].shape
    k1 = batch["other_ids"].shape[1]
    n0 = batch["n0"].cpu().numpy().astype(np.int64)
    other_n = batch["other_n"].cpu().numpy().astype(np.int64).reshape(rows, k1)
    valid = {"ids0": n0.sum(), "pid0": n0.sum(), "ndesc0": n0.sum(), "n0": rows,
             "other_ids": other_n.sum(), "other_ndesc": other_n.sum()}
    n_bytes = 4 * sum(int(valid[n]) for n in READS[semantics]) + rows * m0 * 5
    steps = np.vectorize(log2_steps, otypes=[np.int64])
    n_ops = int((n0 * steps(other_n).sum(axis=1)).sum()) + rows * m0
    if semantics != "ca":
        n_ca = functions("fused_search")[1](**plain_of(batch), semantics="ca")[1]
        n_ca = n_ca.sum(dim=1).cpu().numpy().astype(np.int64)
        adds = 1 if semantics == "slca" else k1 + 1
        n_ops += int((n_ca * (steps(n0) + adds)).sum())
    return least_time(n_bytes, n_ops)


def least_time(n_bytes: int, n_ops: int) -> tuple[float, str, int, int]:
    """(ms, bound_by, bytes, ops): the larger of bytes over the HBM rate and
    32-bit operations over the scalar rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / SCALAR_OPS_PER_S * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", n_bytes, n_ops
    return t_ops, "operations", n_bytes, n_ops


def fused_route(batch: dict, semantics: str) -> str:
    """The fused kernel's route for a packed batch (by its shape alone)."""
    m0, k = batch["ids0"].shape[1], batch["other_ids"].shape[1] + 1
    return module("fused_search").route(m0, k, semantics)


def plain_of(batch: dict) -> dict:
    """The packed batch without ``other_n``, which the plain version lacks."""
    return {n: t for n, t in batch.items() if n != "other_n"}


def check_kernel(batch: dict, semantics: str) -> dict:
    """Kernel == plain on one packed batch (raises otherwise); times both."""
    import torch

    fused_search_batch, fused_search_batch_plain, _ = functions("fused_search")
    plain_args = plain_of(batch)
    ids, mask = fused_search_batch(**batch, semantics=semantics)
    want_ids, want_mask = fused_search_batch_plain(**plain_args, semantics=semantics)
    torch.cuda.synchronize()
    if not (torch.equal(ids, want_ids) and torch.equal(mask, want_mask)):
        bad = int((ids != want_ids).sum()) + int((mask != want_mask).sum())
        raise AssertionError(f"kernel != plain on {bad} slots ({semantics})")
    err = int((ids.long() - want_ids.long()).abs().max())
    rows, m0 = batch["ids0"].shape
    rec = {
        "rows": int(rows), "k": int(batch["other_ids"].shape[1] + 1),
        "m0": int(m0), "mo": int(batch["other_ids"].shape[2]),
        "semantics": semantics, "max_abs_err": err,
        "kept": int(mask.sum()), "route": fused_route(batch, semantics),
    }
    bound_ms, bound_by, n_bytes, n_ops = bound_of(batch, semantics)
    rec.update(
        ms=cuda_ms(lambda: fused_search_batch(**batch, semantics=semantics)),
        plain_ms=cuda_ms(
            lambda: fused_search_batch_plain(**plain_args, semantics=semantics)
        ),
        bound_ms=bound_ms, bound_by=bound_by, bytes=n_bytes, ops=n_ops,
    )
    return rec


def check_routes(batch: dict, semantics: str) -> list[str]:
    """The fused kernel forced down each route that can take this batch (the
    rows route only where the row's state fits), each held against the
    plain version (raises otherwise); returns the routes checked."""
    import torch

    fs = module("fused_search")
    m0, k = batch["ids0"].shape[1], batch["other_ids"].shape[1] + 1
    want_ids, want_mask = fs.fused_search_batch_plain(**plain_of(batch), semantics=semantics)
    checked = [w for w in fs.ROUTES if w == "tiles" or fs.rows_fit(m0, k, semantics)]
    for which in checked:
        ids, mask = fs._launch(batch["ids0"].device.index, *batch.values(), semantics, which)
        torch.cuda.synchronize()
        if not (torch.equal(ids, want_ids) and torch.equal(mask, want_mask)):
            raise AssertionError(f"fused route {which} != plain ({semantics})")
    return checked


def fused_launches(which: str, semantics: str) -> dict[str, int]:
    """{device op: launches} of one fused_search call down route ``which``."""
    if which == "rows":
        return {"fused_rows_kernel": 1}
    return {"membership_kernel": 1, "parent_kernel": int(semantics != "ca"), "keep_kernel": 1}


ROUTE_THRESHOLDS = (0, 2048, 4096, 8192)  # longest row sent to the rows route


def route_threshold_passes(rounds) -> dict:
    """One pass of the main-path batches with the rows route taking the
    rows of m0 up to each of ROUTE_THRESHOLDS (where they fit) and the tiles
    route the rest: CUDA-event ms and profiler device ms of each pass, the
    evidence for the wrapper's own threshold (fused_search._ROW_MAX_M0)."""
    fs = module("fused_search")
    out = {}
    for limit in ROUTE_THRESHOLDS:
        calls, want = [], dict.fromkeys(KERNELS["fused_search"].device_ops, 0)
        for _l, b, s in rounds:
            m0, k = b["ids0"].shape[1], b["other_ids"].shape[1] + 1
            which = "rows" if m0 <= limit and fs.rows_fit(m0, k, s) else "tiles"
            calls.append(lambda b=b, s=s, w=which: fs._launch(
                b["ids0"].device.index, *b.values(), s, w))
            for op, count in fused_launches(which, s).items():
                want[op] += count
        ms = pass_ms(calls)
        dev_ms, events = device_pass_ms(lambda calls=calls: [c() for c in calls], want,
                                        "fused_search")
        out[limit] = {"ms": ms, "device_ms": dev_ms, "rows_calls": want["fused_rows_kernel"]}
        print(f"fused pass with the rows route up to m0={limit}: "
              f"{want['fused_rows_kernel']} rows-route calls, CUDA events {ms:.4f} ms, "
              "device " + device_text(dev_ms, events, want))
    return out


def batch_shapes(rounds) -> list[dict]:
    """Route, R, k, m0, mo and the L0 lengths of each recorded fused batch."""
    out = []
    for _label, batch, sem in rounds:
        rows, m0 = batch["ids0"].shape
        n0 = batch["n0"].cpu().numpy()
        out.append({"route": fused_route(batch, sem), "rows": int(rows),
                    "k": int(batch["other_ids"].shape[1] + 1), "m0": int(m0),
                    "mo": int(batch["other_ids"].shape[2]), "max_n0": int(n0.max()),
                    "rows_used": int((n0 > 0).sum()), "sum_n0": int(n0.sum())})
    return out


def fused_breakdown(batch: dict, semantics: str) -> dict:
    """``host_breakdown`` of one ``fused_search_batch`` call on this batch."""
    import torch

    fs = module("fused_search")
    rows, m0 = batch["ids0"].shape
    k1, mo = batch["other_ids"].shape[1], batch["other_ids"].shape[2]
    index = batch["ids0"].device.index
    which = fs.route(m0, k1 + 1, semantics)
    keep_ids, keep_mask = fs._launch(index, *batch.values(), semantics, which)
    scratch = ((0,) * 5, None) if which == "rows" else fs.scratch_of(batch["ids0"], k1, semantics)
    ptr_scratch = scratch[0]  # scratch[1], the buffer, lives as long as this call
    args = (*(0 if t is None else t.data_ptr() for t in batch.values()), rows, m0, k1, mo,
            fs._SEMANTICS[semantics], fs.ROUTES.index(which),
            keep_ids.data_ptr(), keep_mask.data_ptr(), *ptr_scratch)
    ids0 = batch["ids0"]
    rec = {"route": which, "shape": [int(rows), int(k1 + 1), int(m0), int(mo)]}
    rec.update(host_breakdown(
        f"fused_search at R={rows} k={k1 + 1} m0={m0} mo={mo} {semantics} ({which} route)",
        fs._LAUNCH, index, args,
        {"checks": lambda: fs._check(*batch.values()),
         "route": lambda: fs.route(m0, k1 + 1, semantics),
         "allocation": lambda: (torch.empty_like(ids0),
                                torch.empty_like(ids0, dtype=torch.bool),
                                None if which == "rows" else fs.scratch_of(ids0, k1, semantics)),
         "pointers": lambda: [t.data_ptr() for t in batch.values()]},
        {"whole_call_us": lambda: fs.fused_search_batch(**batch, semantics=semantics)}))
    del scratch
    return rec


# --------------------------------------------------------------------------- #
# The chained kernels vs plain
# --------------------------------------------------------------------------- #


def intersect_windows(calls, tile: int = 256) -> dict:
    """The windows the intersect kernel stages on these calls: for each tile
    of ``tile`` L0 entries and each other list, the ids of the list between
    the tile's first and last id (what csrc/intersect.cu stages whole up to
    kStage - 3 = 4,093 ids, and samples above)."""
    sizes = []
    for _label, (buf, table, n) in calls:
        (ids0, _), *others = list_views(buf, table)
        ids0 = ids0.cpu().numpy()
        first, last = ids0[::tile], ids0[np.minimum(np.arange(0, n, tile) + tile, n) - 1]
        for ids, _ in others:
            ids = ids.cpu().numpy()
            sizes += (np.searchsorted(ids, last, "right") - np.searchsorted(ids, first)).tolist()
    sizes = np.array(sizes)
    return {"windows": int(sizes.size), "median": float(np.median(sizes)),
            "p90": float(np.percentile(sizes, 90)), "max": int(sizes.max()),
            "sampled": int((sizes > 4093).sum()), "empty": int((sizes == 0).sum())}


def log2_steps(n: int) -> int:
    """Compares of one binary search over n entries."""
    return math.ceil(math.log2(n)) + 1 if n > 0 else 1


def chained_bound(name: str, args) -> tuple[float, str, int, int]:
    """Least time for one chained kernel call on these inputs.

    Bytes: what the function needs of each input read once, each output
    written once.  Of a sorted row or of ``ca`` that is the valid prefix,
    never the INT_PAD tail a bucket adds (a binary search touches the tail
    only at its probes); of ``nd`` the columns whose parent is a CA.
    Operations, counted on these inputs: one binary search of the valid
    prefix per query (searchsorted; intersect: of each other list per L0
    entry, plus one compare for found); for the child sums one binary search
    per entry with a parent and k adds per parent found.
    """
    import torch

    from repro_torch.kernels.shapes import INT_PAD

    if name == "searchsorted":
        a, q = args
        n_valid = (a != INT_PAD).sum(dim=1).tolist()
        n_bytes = 4 * (sum(n_valid) + 2 * q.numel())
        n_ops = q.shape[1] * sum(log2_steps(n) for n in n_valid)
    elif name == "intersect":
        _buf, table, n = args
        lens = [length for _i, _d, length in table.tolist()]  # L0 first
        # ids of every list; NDesc: L0's, and of each other list the entries
        # L0's positions select (at most n); out: ca (bool) and nd [k, n]
        n_bytes = (4 * sum(lens) + 4 * (n + sum(min(n, m) for m in lens[1:]))
                   + n + 4 * len(lens) * n)
        n_ops = n * sum(log2_steps(m) + 1 for m in lens[1:])
    else:
        ca, par, nd = args
        k = nd.shape[0]
        mi = ca.numel()
        mi_valid = int((ca != INT_PAD).sum())
        has_par = par >= 0
        pos = torch.searchsorted(ca, par).clamp(max=max(mi - 1, 0))
        n_hit = int((has_par & (ca[pos] == par)).sum()) if mi else 0
        n_bytes = 4 * (mi_valid + par.numel() + k * n_hit + k * mi)
        n_ops = int(has_par.sum()) * log2_steps(mi_valid) + n_hit * k
    return least_time(n_bytes, n_ops)


def shapes_of(name: str, args) -> list:
    """A call's shapes: each argument's, or for intersect the lists'
    lengths, L0 first."""
    if name == "intersect":
        return [length for _i, _d, length in args[1].tolist()]
    return [list(a.shape) for a in args]


def check_chained(name: str, args) -> dict:
    """Kernel == plain on one call's inputs (raises otherwise); times all."""
    import torch

    kernel, plain, library = functions(name)
    got, want = kernel(*args), plain(*args)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        bad = sum(int((g != w).sum()) for g, w in zip(got, want))
        raise AssertionError(f"{name} kernel != plain on {bad} outputs")
    err = max(
        (int((g.long() - w.long()).abs().max()) for g, w in zip(got, want)
         if g.numel()),
        default=0,
    )
    bound_ms, bound_by, n_bytes, n_ops = chained_bound(name, args)
    largs = library_args(name, args)
    return {
        "shapes": shapes_of(name, args), "max_abs_err": err,
        "ms": cuda_ms(lambda: kernel(*args)),
        "plain_ms": cuda_ms(lambda: plain(*args)),
        "library_ms": cuda_ms(lambda: library(*largs)) if library else None,
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": n_bytes, "ops": n_ops,
    }


def intersect_lists_case(rng, n0: int, others, mode: str) -> list:
    """[(ids, ndesc)] of a random ``intersect_lists`` call, L0 first: L0 of
    n0 ids in all the other lists (``"all"``), in none (``"none"``) or
    partly (``"mixed"``)."""
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


def packed_lists(rng, lists):
    """(buf, table, n) on the card, packed as ``run_query_chained`` packs
    them but with 0-3 ints before each part, so lists start at any 16-byte
    phase."""
    import torch

    parts, table, off = [], [], 0
    for ids, nd in lists:
        row = []
        for x in (ids, nd):
            gap = int(rng.integers(0, 4))
            parts += [np.full(gap, -7, np.int32), x]
            row.append(off + gap)
            off += gap + x.size
        table.append((*row, ids.size))
    buf = np.concatenate(parts + [np.ravel(table).astype(np.int32)])
    buf = torch.from_numpy(buf).to(DEVICE)
    return buf, buf[off:].view(len(lists), 3), int(lists[0][0].size)


def chained_random_cases():
    """(kernel, label, inputs on the card) of the random chained checks."""
    import torch

    rng = np.random.default_rng(1)

    def sorted_unique(n, hi):
        return np.unique(rng.integers(0, hi, size=n)).astype(np.int32)

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(DEVICE)

    cases = []
    for n0, others, mode in (
        (1, (1,), "all"), (1, (1, 1, 1), "none"), (5, (1, 1), "mixed"),
        (300, (300, 900), "all"), (500, (700,), "none"),
        (5000, (5000, 8000, 20_000), "mixed"),  # windows staged whole
        (100, (100_000,), "mixed"),  # windows sampled
        (20_001, (60_001, 200_000), "mixed"),  # both
    ):
        lists = intersect_lists_case(rng, n0, others, mode)
        cases.append(("intersect", f"lengths {[len(l) for l, _ in lists]} {mode}",
                      packed_lists(rng, lists)))
    for rows, m, nq in ((1, 1, 1), (1, 513, 511), (8, 4096, 1000),
                        (64, 4096, 300), (64, 65_536, 64), (7, 65_536, 20_001)):
        a = np.full((rows, m), np.iinfo(np.int32).max, np.int32)
        for r in range(rows):
            row = sorted_unique(int(rng.integers(1, m + 1)), 10 * m)
            a[r, : row.size] = row[:m]
        q = rng.integers(-5, 10 * m + 5, size=(rows, nq))  # unsorted
        cases.append(("searchsorted", f"B={rows} M={m} Q={nq}", (on(a), on(q))))
    # a tile of 1,024 queries in random order whose window holds 4,093 ids
    # (staged whole) or 4,094 (sampled), at every 16-byte phase of the rows
    for width in (4093, 4094):
        for gap in range(4):
            m = 2 * width + 7
            a = np.stack([sorted_unique(3 * m, 40 * m)[:m] for _ in range(3)])
            lo, hi = a[:, 5:6], a[:, 5 + width : 6 + width]
            q = lo + (rng.random((3, 1024)) * (hi - lo + 1)).astype(np.int64)
            q[:, :2] = np.concatenate([lo, hi], axis=1)
            q = rng.permuted(q, axis=1)
            cases.append(("searchsorted", f"B=3 M={m} Q=1024 window {width} phase {gap}",
                          (at_phase(a, gap), at_phase(q, (gap + 1) % 4))))
    # the service's widest call: ascending L0 ids with an INT_PAD tail
    a = np.full((12, 131_072), np.iinfo(np.int32).max, np.int32)
    for r in range(12):
        row = sorted_unique(60_000, 10**6)
        a[r, : row.size] = row
    q = np.sort(rng.integers(0, 10**6, size=(12, 32_768)), axis=1)
    q[:, 28_000:] = np.iinfo(np.int32).max
    cases.append(("searchsorted", "B=12 M=131072 Q=32768 ascending", (on(a), on(q))))
    for m, k, pad in ((1, 2, 0), (100, 2, 0), (513, 3, 5), (1024, 4, 0),
                      (20_000, 3, 0), (40_000, 4, 17)):
        ca = sorted_unique(m, 10**6)
        par = np.where(rng.random(ca.size) < 0.8,
                       ca[rng.integers(0, ca.size, size=ca.size)], -1)
        nd = rng.integers(1, 100, size=(k, ca.size))
        ca = np.concatenate([ca, np.full(pad, np.iinfo(np.int32).max)])
        par = np.concatenate([par, np.full(pad, -1)])
        nd = np.concatenate([nd, np.zeros((k, pad), np.int64)], axis=1)
        cases.append(("elca_segsum", f"MI={ca.size} K={k} pad={pad}",
                      (on(ca), on(par), on(nd))))
    for kind, mi, mj, k, pad in (
        ("star", 60_001, 60_001, 2, 0), ("star", 3, 70_000, 1, 3),
        ("hot", 60_001, 60_001, 3, 0), ("hot", 200, 511, 2, 1),
        ("none", 20_000, 20_000, 4, 5), ("random", 100, 70_000, 1, 9),
        ("random", 60_001, 10, 2, 7), ("random", 4_094, 4_094, 4, 17),
    ):
        cases.append(("elca_segsum", f"{kind} MI={mi + pad} MJ={mj + pad} K={k} pad={pad}",
                      tuple(on(x) for x in segsum_case(rng, kind, mi, mj, k, pad))))
    return cases


def at_phase(x, gap: int):
    """``x`` on the card as a contiguous view starting ``gap`` int32s into
    its buffer (another 16-byte phase)."""
    import torch

    flat = np.concatenate([np.full(gap, -7, np.int32), np.ravel(x).astype(np.int32)])
    return torch.from_numpy(flat).to(DEVICE)[gap:].view(x.shape)


def segsum_case(rng, kind: str, mi: int, mj: int, k: int, pad: int):
    """(ca, par, nd) of one child-sum call: ca of mi ascending unique ids and
    ``pad`` INT32_MAX; mj children (and ``pad`` with no parent) whose parents
    are one id of ca (``"star"``), a few hot ids among scattered cold ones
    (``"hot"``), none (``"none"``), or any id of ca, some not in it, or none
    (``"random"``); parents in any order, not only before their children."""
    ca = np.unique(rng.integers(0, 50 * mi + 100, size=mi))
    if kind == "star":
        par = np.full(mj, ca[ca.size // 2])
    elif kind == "hot":
        hot = rng.choice(ca, size=min(3, ca.size), replace=False)
        par = np.where(rng.random(mj) < 0.9, rng.choice(hot, size=mj), rng.choice(ca, size=mj))
    elif kind == "none":
        par = np.full(mj, -1)
    else:
        par = np.where(rng.random(mj) < 0.8, rng.choice(ca, size=mj),
                       rng.integers(-3, 50 * mi + 100, size=mj))
    par[rng.random(mj) < 0.05] = -1
    nd = rng.integers(-50, 100, size=(k, mj))
    return (np.concatenate([ca, np.full(pad, np.iinfo(np.int32).max)]),
            np.concatenate([par, np.full(pad, -1)]),
            np.concatenate([nd, rng.integers(1, 9, size=(k, pad))], axis=1))


BREAKDOWN_REPS = 200  # calls per timed batch of the host breakdown
BREAKDOWN_BATCHES = 15


def host_us(fn) -> float:
    """Median host-clock µs of one call of ``fn``: batches of
    BREAKDOWN_REPS calls, the device synchronised between batches, outside
    the timed loop."""
    import torch

    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(BREAKDOWN_BATCHES):
        t0 = time.perf_counter_ns()
        for _ in range(BREAKDOWN_REPS):
            fn()
        per_call.append((time.perf_counter_ns() - t0) / BREAKDOWN_REPS / 1e3)
        torch.cuda.synchronize()
    return float(np.median(per_call))


def host_us_in_turns(fns: dict, rounds: int = 4) -> dict:
    """Median host µs of one call of each function of ``fns``, timed in turns
    (``host_us`` of each, the order reversed every round): the host's speed
    drifts within a run."""
    names = list(fns)
    times = {name: [] for name in names}
    for r in range(rounds):
        for name in names if r % 2 == 0 else names[::-1]:
            times[name].append(host_us(fns[name]))
    return {name: float(np.median(t)) for name, t in times.items()}


# The C entry points' parameters before the stream ("p" pointer, "i" int, "f"
# float), only to time a ctypes.CDLL call of the same function beside the
# port's binding (binding_us); the port itself never uses ctypes.
CTYPES_PARAMS = {
    "searchsorted_launch": "ppiiip",
    "elca_segsum_launch": "pippiip",
    "intersect_lists_launch": "ppiipp",
    "fused_search_launch": "ppppppp" "iiiiii" "ppppppp",
    "decode_attention_f32": "pppp" "iiiii" "f" "ii" "pp",
    "decode_attention_bf16": "pppp" "iiiii" "f" "ii" "pp",
}


def binding_us(entry, index: int, args) -> dict:
    """Host µs of one call of ``entry``'s C function on ``args`` (ints and
    floats, the stream excluded), through the port's binding (the module
    function ``Entry`` calls) and through ``ctypes.CDLL`` of the same
    function in the same library, timed in turns.  Each call launches the
    kernel on the current stream."""
    import ctypes

    from repro_torch.kernels import _build

    types = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
    fn = getattr(_build.load(entry.source), entry.name)
    cfn = getattr(ctypes.CDLL(str(_build.build(entry.source))), entry.name)
    cfn.argtypes = [types[c] for c in CTYPES_PARAMS[entry.name]] + [ctypes.c_void_p]
    cfn.restype = ctypes.c_int
    stream = _build.current_stream_ptr(index)
    for call in (fn, cfn):
        if call(*args, stream):
            raise AssertionError(f"{entry.name} failed through {call!r}")
    return host_us_in_turns({"entry call": lambda: fn(*args, stream),
                             "ctypes call": lambda: cfn(*args, stream)})


def host_breakdown(label: str, entry, index: int, args, parts: dict,
                   whole: dict) -> dict:
    """Host µs of each part of one kernel wrapper call, each timed on its own
    as the wrapper does it: ``parts``, the wrapper's own work before the
    launch; then the launch path's entry lookup, device guard and stream,
    and the entry call (``args``: the C function's arguments) beside a
    ctypes call of the same function (``binding_us``).  ``sum_us`` adds the
    parts of the wrapper's path (not the ctypes call); ``whole``'s functions
    (the whole call, and a library call where there is one) are timed in
    turns."""
    from repro_torch.kernels import _build

    entry(index, *args)  # binds it
    parts = {
        **parts,
        "lookup": lambda: entry._fn if entry._libs is _build._LIBS else None,
        "device guard": lambda: index == _build.current_device_index(),
        "stream": lambda: _build.current_stream_ptr(index),
    }
    us = {name: host_us(part) for name, part in parts.items()}
    us.update(binding_us(entry, index, args))
    rec = {"parts_us": us, "sum_us": sum(v for n, v in us.items() if n != "ctypes call")}
    rec.update(host_us_in_turns(whole))
    print(
        f"{label} host breakdown (median us a call, {BREAKDOWN_BATCHES} batches of "
        f"{BREAKDOWN_REPS}): " + ", ".join(f"{n} {v:.2f}" for n, v in us.items())
        + f"; sum (without the ctypes call) {rec['sum_us']:.2f}; "
        + ", ".join(f"{n} {rec[n]:.2f}" for n in whole)
    )
    return rec


def searchsorted_breakdown(a, q) -> dict:
    """``host_breakdown`` of one ``searchsorted`` call on these inputs, beside
    ``torch.searchsorted``."""
    import torch

    from repro_torch.kernels import _build

    ss = module("searchsorted")
    rows, m = a.shape
    out = torch.empty_like(q)
    args = (a.data_ptr(), q.data_ptr(), rows, m, q.shape[1], out.data_ptr())
    rec = {"shapes": [list(a.shape), list(q.shape)]}
    rec.update(host_breakdown(
        f"searchsorted at {rec['shapes']}", ss._LAUNCH, a.device.index, args,
        {"checks": lambda: _build.int32_device(a, q),
         "allocation": lambda: torch.empty_like(q),
         "pointers": lambda: (a.data_ptr(), q.data_ptr(), out.data_ptr())},
        {"whole_call_us": lambda: ss.searchsorted(a, q),
         "torch_searchsorted_us": lambda: torch.searchsorted(a, q)}))
    return rec


def segsum_breakdown(ca, par, nd) -> dict:
    """``host_breakdown`` of one ``elca_child_sums`` call on these inputs."""
    from repro_torch.kernels import _build

    es = module("elca_segsum")
    k, mj = nd.shape
    mi = ca.numel()
    out = nd.new_empty((k, mi))
    args = (ca.data_ptr(), mi, par.data_ptr(), nd.data_ptr(), mj, k, out.data_ptr())
    rec = {"shapes": shapes_of("elca_segsum", (ca, par, nd))}
    rec.update(host_breakdown(
        f"elca_segsum at {rec['shapes']}", es._LAUNCH, ca.device.index, args,
        {"checks": lambda: _build.int32_device(ca, par, nd),
         "allocation": lambda: nd.new_empty((k, mi)),
         "pointers": lambda: (ca.data_ptr(), par.data_ptr(), nd.data_ptr(), out.data_ptr())},
        {"whole_call_us": lambda: es.elca_child_sums(ca, par, nd)}))
    return rec


def intersect_breakdown(buf, table, n) -> dict:
    """``host_breakdown`` of one ``intersect_lists`` call on these inputs."""
    import torch

    from repro_torch.kernels import _build

    it = module("intersect")
    k = table.shape[0]
    ca = buf.new_empty(n, dtype=torch.bool)
    nd = buf.new_empty((k, n))
    args = (buf.data_ptr(), table.data_ptr(), k, n, ca.data_ptr(), nd.data_ptr())
    rec = {"shapes": shapes_of("intersect", (buf, table, n))}
    rec.update(host_breakdown(
        f"intersect_lists at {rec['shapes']}", it._LISTS, buf.device.index, args,
        {"checks": lambda: _build.int32_device(buf, table),
         "allocation": lambda: (buf.new_empty(n, dtype=torch.bool), buf.new_empty((k, n))),
         "pointers": lambda: (buf.data_ptr(), table.data_ptr(), ca.data_ptr(),
                              nd.data_ptr())},
        {"whole_call_us": lambda: it.intersect_lists(buf, table, n)}))
    return rec


class CallRecorder:
    """Keeps every call the chained path makes to its three kernels.

    Inside ``with CallRecorder() as rec`` each kernel wrapper the chained
    path calls through ``repro_torch.kernels.ops`` (``KERNELS``) is wrapped:
    its inputs go to ``rec.calls[kernel]`` as ``(rec.label, args)``, then the
    wrapper runs as it would.  ``rec.queries`` counts the
    ``ops.run_query_chained`` calls that reach the intersection (no list
    empty).
    """

    def __init__(self):
        self.label = ""
        self.calls: dict[str, list] = {name: [] for name in CHAINED}
        self.queries = 0

    def __enter__(self):
        from repro_torch.kernels import ops

        self._orig = {name: getattr(ops, KERNELS[name].wrapper) for name in CHAINED}
        self._query = ops.run_query_chained
        for name in CHAINED:
            def wrapped(*args, _name=name, _fn=self._orig[name]):
                self.calls[_name].append((self.label, args))
                return _fn(*args)

            setattr(ops, KERNELS[name].wrapper, wrapped)

        def query(lists, *args, **kwargs):
            self.queries += bool(lists) and all(len(l) for l in lists)
            return self._query(lists, *args, **kwargs)

        ops.run_query_chained = query
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        for name in CHAINED:
            setattr(ops, KERNELS[name].wrapper, self._orig[name])
        ops.run_query_chained = self._query


# --------------------------------------------------------------------------- #
# Main path
# --------------------------------------------------------------------------- #


def query_matrix(names=None):
    from repro_torch.data import QUERIES

    return [
        (name, tuple(words), sem, index)
        for name, (_cat, words) in QUERIES.items()
        if names is None or name in names
        for sem in SEMANTICS
        for index in INDEXES
    ]


class Recorder:
    """Keeps every batch a PlanCache packs for the fused kernel, labelled.

    Inside ``with Recorder() as rec`` every PlanCache (the engine's, the
    tree path's per-query one, the service's drain) hands its fused batches
    to ``rec.rounds`` as ``(rec.label, batch, semantics)``; the batches stay
    the device tensors the kernel was launched on.
    """

    def __init__(self):
        self.label = ""
        self.rounds: list[tuple[str, dict, str]] = []

    def __enter__(self):
        from repro_torch.core.plan_cache import PlanCache

        self._pack = PlanCache.pack
        rec = self

        def pack(plan, per_item, keys, semantics="slca", backend="torch"):
            out = rec._pack(plan, per_item, keys, semantics, backend)
            if out[0] is not None and backend == "fused":
                rec.rounds.append((rec.label, out[0], semantics))
            return out

        PlanCache.pack = pack
        return self

    def __exit__(self, *exc):
        from repro_torch.core.plan_cache import PlanCache

        PlanCache.pack = self._pack


def run_engine(engine, backend: str, rec=None, names=None):
    """Every (query, semantics, index) through engine.query; ids + ms each.

    ``rec`` (a Recorder or CallRecorder) is told which query runs; ``names``
    keeps only those queries."""
    from repro_torch.api import Query

    out, lat = {}, []
    for name, words, sem, index in query_matrix(names):
        if rec is not None:
            rec.label = f"{name} {sem} {index}"
        t0 = time.perf_counter()
        res = engine.query(Query(words, sem, index, backend))
        lat.append((time.perf_counter() - t0) * 1e3)
        if res.ids.dtype != np.int64 or (res.ids.size and np.any(np.diff(res.ids) <= 0)):
            raise AssertionError(f"{name} {sem} {index} {backend}: ids not ascending int64")
        out[(name, sem, index)] = res.ids
    return out, lat


def run_service(engine, backend: str) -> dict:
    """The 18 DAG queries submitted together to one QueryService."""
    from repro_torch.api import Query
    from repro_torch.serve import QueryService

    keys = [(n, s) for n, _w, s, i in query_matrix() if i == "dag"]
    words = {n: w for n, w, _s, _i in query_matrix()}
    with QueryService(
        engine, backend=backend, batch_window_ms=20.0, device=DEVICE
    ) as svc:
        futs = [svc.submit(Query(words[n], s, "dag", backend)) for n, s in keys]
        got = {(n, s, "dag"): f.result(timeout=600).ids for (n, s), f in zip(keys, futs)}
        stats = svc.stats().to_dict()
    return got, stats


def assert_equal(got: dict, want: dict, what: str) -> None:
    for key, ids in got.items():
        if not np.array_equal(ids, want[key]):
            raise AssertionError(
                f"{what}: {key} gives {ids.size} ids, scalar gives {want[key].size}"
            )


def pass_ms(calls) -> float:
    """Median ms of one pass of ``calls`` between one pair of CUDA events."""
    return cuda_ms(lambda: [call() for call in calls])


def paired_pass_ms(calls_a, calls_b) -> tuple[float, float]:
    """Median ms of one pass of ``calls_a`` and of ``calls_b``, timed in
    turns (a, b, b, a, ...), each pass between one pair of CUDA events: the
    passes are host-bound, and the host's speed drifts within a run."""
    import torch

    def one(calls) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for call in calls:
            call()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    one(calls_a), one(calls_b)  # warm
    times = {0: [], 1: []}
    for rep in range(TIMING_REPS):
        for which in ((0, 1) if rep % 2 == 0 else (1, 0)):
            times[which].append(one(calls_a if which == 0 else calls_b))
    return float(np.median(times[0])), float(np.median(times[1]))


def search_phase(card: str) -> list[dict]:
    """The fused and chained search paths, checked and measured; returns
    their kernel lines."""
    import torch

    from repro_torch.core import KeywordSearchEngine, PlanCache
    from repro_torch.data import generate_discogs_tree
    from repro_torch.kernels import fused_search

    # ---- corpus + engine on the card ---------------------------------- #
    t0 = time.perf_counter()
    tree = generate_discogs_tree(n_releases=N_RELEASES, seed=0)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine = KeywordSearchEngine(tree, device=DEVICE)
    t_build = time.perf_counter() - t0
    sizes = engine.index_sizes()
    print(
        f"corpus: {N_RELEASES} releases, {tree.num_nodes} nodes, "
        f"{sizes['tree_entries']} containment entries, {sizes['num_rcs']} RCs, "
        f"{sizes['rcpm_entries']} RCPM dummies; generate {t_gen:.2f} s, "
        f"host index build {t_build:.2f} s"
    )
    print(
        f"size cut: {N_RELEASES} of the paper's 4.2 M discogs releases; the "
        "pure-Python host build grows linearly and this is what one run "
        "allows"
    )

    # ---- main path: warm, then counted ------------------------------- #
    run_engine(engine, "fused")  # warm: CUDA context, allocator, pinned pool
    torch.cuda.synchronize()
    fallbacks0 = engine.plan_cache.fused_fallbacks
    fused_search.LAUNCHES = 0
    with Recorder() as recorder:
        fused, fused_lat = run_engine(engine, "fused", recorder)
        recorder.label = "service window"
        served, svc_stats = run_service(engine, "fused")
    torch.cuda.synchronize()
    main_launches = fused_search.LAUNCHES
    if main_launches <= 0:
        raise AssertionError("the main path launched no fused_search kernel")
    rounds = recorder.rounds
    if len(rounds) != main_launches:
        raise AssertionError(
            f"{main_launches} launches but {len(rounds)} fused batches packed"
        )
    if engine.plan_cache.fused_fallbacks != fallbacks0 or fallbacks0 != 0:
        raise AssertionError("a fused launch was demoted")
    print(
        f"main path: {len(fused)} engine queries + {len(served)} service "
        f"queries, fused_search launches {main_launches}, fused_fallbacks 0, "
        f"service batches {svc_stats.get('batches')} launches "
        f"{svc_stats.get('launches')}"
    )
    shapes = batch_shapes(rounds)
    routes = {r: sum(b["route"] == r for b in shapes) for r in fused_search.ROUTES}
    print(f"fused_search calls per route on the main path: {json.dumps(routes)}; "
          "batches (route R k m0 mo max-n0 rows-used sum-n0): " + "; ".join(
              f"{b['route']} {b['rows']} {b['k']} {b['m0']} {b['mo']} {b['max_n0']} "
              f"{b['rows_used']} {b['sum_n0']}" for b in shapes))

    # ---- answers against the scalar and torch backends ---------------- #
    scalar, scalar_lat = run_engine(engine, "scalar")
    run_engine(engine, "torch")  # warm
    vec, torch_lat = run_engine(engine, "torch")
    assert_equal(fused, scalar, "fused engine")
    assert_equal(served, scalar, "fused service")
    assert_equal(vec, scalar, "torch engine")
    n_ids = sum(v.size for v in scalar.values())
    print(f"answers: {len(fused)} fused + {len(served)} service + {len(vec)} "
          f"torch equal scalar ({n_ids} ids in all)")

    # ---- the chained path: warm on Q4-Q9, then counted ----------------- #
    run_engine(engine, "chained", names=("Q4", "Q5", "Q6", "Q7", "Q8", "Q9"))
    torch.cuda.synchronize()
    for name in CHAINED:
        module(name).LAUNCHES = 0
    with CallRecorder() as calls:
        chained, chained_lat = run_engine(engine, "chained", calls)
        calls.label = "service window"
        chained_served, chained_svc = run_service(engine, "chained")
    torch.cuda.synchronize()
    chained_launches = {name: module(name).LAUNCHES for name in CHAINED}
    for name, count in chained_launches.items():
        if count <= 0:
            raise AssertionError(f"the chained path launched no {name} kernel")
        if count != len(calls.calls[name]):
            raise AssertionError(
                f"{count} {name} launches but {len(calls.calls[name])} calls recorded"
            )
    if chained_launches["intersect"] != calls.queries:
        raise AssertionError(
            f"{chained_launches['intersect']} intersect launches for {calls.queries} "
            "chained queries that reach the intersection: want one each"
        )
    assert_equal(chained, scalar, "chained engine")
    assert_equal(chained_served, scalar, "chained service")
    windows = intersect_windows(calls.calls["intersect"])
    print(f"intersect windows on the chained path (tiles of 256 L0 entries x other "
          f"lists): {json.dumps(windows)}")
    print(
        f"chained path: {len(chained)} engine + {len(chained_served)} service "
        f"queries equal scalar; launches {json.dumps(chained_launches)} "
        f"({calls.queries} run_query_chained calls reach the intersection); "
        f"service batches {chained_svc.get('batches')} launches "
        f"{chained_svc.get('launches')}"
    )
    for name, lat in (("fused", fused_lat), ("chained", chained_lat),
                      ("torch", torch_lat), ("scalar", scalar_lat)):
        print(f"per-query ms {name}: p50 {np.percentile(lat, 50):.3f} "
              f"max {max(lat):.3f} over {len(lat)} queries")
    per_query = [
        {"query": f"{n} {s} {i}", "ids": int(fused[(n, s, i)].size),
         "fused_ms": f, "chained_ms": ch, "torch_ms": t, "scalar_ms": c}
        for (n, _w, s, i), f, ch, t, c in zip(
            query_matrix(), fused_lat, chained_lat, torch_lat, scalar_lat
        )
    ]
    for q in sorted(per_query, key=lambda q: -q["fused_ms"])[:4]:
        print(f"slowest fused: {q['query']} {q['ids']} ids: fused "
              f"{q['fused_ms']:.1f} ms chained {q['chained_ms']:.1f} ms torch "
              f"{q['torch_ms']:.1f} ms scalar {q['scalar_ms']:.1f} ms")

    # where a fused query's time goes: one profiled pass of the 36 queries
    wall_ms, dev, _ = profile_pass(lambda: run_engine(engine, "fused"))
    busy_ms = sum(dev.values())
    profile_rec = {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms if dev else None,
        "kernel_ms": kernel_device_ms(dev, "fused_search") if dev else None,
        "top_device_ops": sorted(dev.items(), key=lambda kv: -kv[1])[:8],
    }
    if dev:
        print(
            f"profiled fused pass (36 queries): wall {wall_ms:.1f} ms, device "
            f"busy {busy_ms:.3f} ms (idle share {1 - busy_ms / wall_ms:.4f}), "
            f"fused_search passes {profile_rec['kernel_ms']:.3f} ms"
        )
    else:
        print("profiled fused pass: device time not measured (no device events)")

    # ---- the fused kernel vs plain ----------------------------------- #
    random_recs = []
    for label, items, sem, min_rows in random_batches():
        plan = PlanCache(backend="fused", min_rows=min_rows, device=DEVICE)
        batch, _, _ = plan.pack(items, list(range(len(items))), sem, "fused")
        r = check_kernel(batch, sem)
        r["case"] = label
        random_recs.append(r)
        print(
            f"kernel==plain {label}: R={r['rows']} k={r['k']} m0={r['m0']} "
            f"mo={r['mo']} kernel {r['ms']:.4f} ms ({r['route']}) plain {r['plain_ms']:.4f} ms "
            f"bound {r['bound_ms']:.5f} ms ({r['bound_by']})"
        )
    round_recs = []
    for label, batch, sem in rounds:
        r = check_kernel(batch, sem)
        r["query"] = label
        r["routes_checked"] = check_routes(batch, sem)
        round_recs.append(r)
        print(
            f"kernel==plain round {label}: R={r['rows']} k={r['k']} "
            f"m0={r['m0']} mo={r['mo']} kernel {r['ms']:.4f} ms ({r['route']}) plain "
            f"{r['plain_ms']:.4f} ms bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']}); forced down {'/'.join(r['routes_checked'])}: == plain"
        )
    tot = {
        "ms": pass_ms([
            lambda b=b, s=s: fused_search.fused_search_batch(**b, semantics=s)
            for _l, b, s in rounds
        ]),
        "plain_ms": pass_ms([
            lambda b=plain_of(b), s=s: fused_search.fused_search_batch_plain(
                **b, semantics=s
            )
            for _l, b, s in rounds
        ]),
        "bound_ms": sum(r["bound_ms"] for r in round_recs),
    }
    want = expected_launches("fused_search", [(b, s) for _l, b, s in rounds])
    device_ops_ms = {}
    device_ms, device_events = device_pass_ms(lambda: [
        fused_search.fused_search_batch(**b, semantics=s) for _l, b, s in rounds
    ], want, "fused_search", ops_ms=device_ops_ms)
    big = max(round_recs, key=lambda r: r["bytes"])
    print(
        f"kernel==plain on all {len(round_recs)} main-path rounds; one pass of "
        f"them (CUDA events, median of {TIMING_REPS}): kernel {tot['ms']:.4f} ms "
        f"plain {tot['plain_ms']:.4f} ms bound "
        f"{tot['bound_ms']:.5f} ms; largest batch {big['query']} R={big['rows']} "
        f"k={big['k']} m0={big['m0']} mo={big['mo']} kernel {big['ms']:.4f} ms "
        f"plain {big['plain_ms']:.4f} ms bound {big['bound_ms']:.5f} ms"
    )
    print(
        "kernel device time over one pass of the main-path rounds (profiler): "
        + device_text(device_ms, device_events, want)
        + f"; by device op {json.dumps(device_ops_ms)}"
    )
    threshold_passes = route_threshold_passes(rounds)

    # ---- the chained kernels vs plain --------------------------------- #
    chained_recs = {name: {"random": [], "calls": []} for name in CHAINED}
    random_cases = chained_random_cases()
    for name, label, args in random_cases:
        r = check_chained(name, args)
        r["case"] = label
        chained_recs[name]["random"].append(r)
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(
            f"{name}==plain {label}: kernel {r['ms']:.4f} ms plain "
            f"{r['plain_ms']:.4f} ms library {lib} bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']})"
        )
    random_windows = intersect_windows(
        [(label, args) for name, label, args in random_cases if name == "intersect"])
    print(f"intersect windows of the random cases: {json.dumps(random_windows)}")
    if not random_windows["sampled"]:
        raise AssertionError("no random intersect case took the sampled route")
    chained_lines = []
    for name in CHAINED:
        kernel, plain, library = functions(name)
        recorded = calls.calls[name]
        recs = chained_recs[name]["calls"]
        for label, args in recorded:
            r = check_chained(name, args)
            r["query"] = label
            recs.append(r)
        largs = [library_args(name, a) for _l, a in recorded]
        kernel_calls = [lambda a=a: kernel(*a) for _l, a in recorded]
        passes = {"plain_ms": pass_ms([lambda a=a: plain(*a) for _l, a in recorded])}
        if library:  # in turns, so that both see the same host
            passes["ms"], passes["library_ms"] = paired_pass_ms(
                kernel_calls, [lambda a=a: library(*a) for a in largs])
        else:
            passes["ms"], passes["library_ms"] = pass_ms(kernel_calls), None
        n = library_calls(name, [a for _l, a in recorded])
        want = expected_launches(name, [a for _l, a in recorded])
        ops_ms = {}
        dev_ms, dev_events = device_pass_ms(lambda: [kernel(*a) for _l, a in recorded],
                                            want, name, ops_ms=ops_ms)
        lib_dev_ms, lib_events = (
            device_pass_ms(lambda: [library(*a) for a in largs], n)
            if library else (None, {}))
        by = {"bytes": 0.0, "operations": 0.0}
        for r in recs:
            by[r["bound_by"]] += r["bound_ms"]
        per_call = [r["ms"] for r in recs]
        big = max(recs, key=lambda r: r["bytes"])
        print(
            f"{name}==plain on all {len(recs)} chained-path calls; per call "
            f"{min(per_call):.4f}-{max(per_call):.4f} ms (median "
            f"{np.median(per_call):.4f}); one pass (CUDA events, median of "
            f"{TIMING_REPS}): kernel {passes['ms']:.4f} ms plain "
            f"{passes['plain_ms']:.4f} ms library "
            + ("none" if library is None else f"{passes['library_ms']:.4f} ms")
            + f" bound {sum(by.values()):.5f} ms; device (profiler) "
            + device_text(dev_ms, dev_events, want)
            + ("" if library is None else
               "; library device " + device_text(lib_dev_ms, lib_events, n))
            + f" (by device op {json.dumps(ops_ms)})"
            + f"; largest call {big['query']} {big['shapes']} kernel "
            f"{big['ms']:.4f} ms bound {big['bound_ms']:.5f} ms"
        )
        chained_lines.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": KERNELS[name].replaces,
            "launches": chained_launches[name],
            "max_abs_err": max(
                r["max_abs_err"] for r in recs + chained_recs[name]["random"]
            ),
            "ms": passes["ms"], "plain_ms": passes["plain_ms"],
            "bound_ms": sum(by.values()), "device_ms": dev_ms,
            "device_events": dev_events, "device_ops_ms": ops_ms,
            "library_device_events": lib_events,
            "bound_by": max(by, key=by.get),
            "library_ms": passes["library_ms"], "library_device_ms": lib_dev_ms,
            "matches_plain": True, "calls": len(recs),
        })

    breakdowns = {
        "searchsorted": searchsorted_breakdown(*calls.calls["searchsorted"][0][1]),
        "elca_segsum": segsum_breakdown(
            *max(calls.calls["elca_segsum"], key=lambda c: c[1][1].numel())[1]),
        "intersect": intersect_breakdown(
            *max(calls.calls["intersect"], key=lambda c: c[1][2])[1]),
    }
    fused_breakdowns = [
        fused_breakdown(b, s) for which in fused_search.ROUTES
        for b, s in [next(((b, s) for _l, b, s in rounds if fused_route(b, s) == which),
                          (None, None))] if b is not None
    ]

    OUT_DIR.mkdir(exist_ok=True)
    with open(OUT_DIR / "chip_smoke_rounds.json", "w") as f:
        json.dump({"card": card, "random": random_recs, "rounds": round_recs,
                   "chained": chained_recs, "main_path_profile": profile_rec,
                   "per_query": per_query, "chained_breakdowns": breakdowns,
                   "fused_breakdowns": fused_breakdowns, "fused_batches": shapes,
                   "intersect_windows": windows,
                   "intersect_random_windows": random_windows},
                  f, indent=1)

    err = max(r["max_abs_err"] for r in random_recs + round_recs)
    fused_line = {
        "name": "fused_search", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_search.cu",
        "replaces": KERNELS["fused_search"].replaces, "launches": main_launches,
        "max_abs_err": err,
        "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
        "device_ms": device_ms, "device_events": device_events,
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in round_recs)
        else "operations",
        "library_ms": None,
        "matches_plain": True,
        "rounds": len(round_recs), "routes": routes,
        "device_ops_ms": device_ops_ms, "route_threshold_passes": threshold_passes,
    }
    return [fused_line, *chained_lines]


# --------------------------------------------------------------------------- #
# LM serving: SmolLM-135M through decode_attention
# --------------------------------------------------------------------------- #

LM_ARCH = "smollm-135m"  # the serving launcher's default, at its published widths
LM_REQUESTS = 8
LM_PROMPT = 1024
LM_SHARED = 768  # prompt tokens all requests share
LM_GEN = 64  # tokens generated per request: 63 decode steps after the prefill
DECODE_TOL = 0.15  # tests/test_arch_smoke.py's decode-vs-prefill tolerance
KERNEL_TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # the reference kernel test's own
# the decode_32k cell (configs/registry.py SHAPES) for one SmolLM-135M layer
DECODE_32K = {"b": 128, "t": 32_768, "h": 9, "hk": 3, "hd": 64}
DECODE_32K_PROFILED = 10  # calls in the profiled pass at that shape


class DecodeRecorder:
    """Keeps every call the model makes to the decode-attention wrapper.

    Inside ``with DecodeRecorder() as rec`` the attention module's calls of
    ``kernels.decode_attention.decode_attention`` go to ``rec.calls`` as
    ``(rec.label, (q, k, v, cache_len))``, then run as they would.  K and V
    are the cache tensors themselves: later steps write past each call's
    lengths only, so a recorded call computes the same again.
    """

    def __init__(self):
        self.label = ""
        self.calls: list[tuple[str, tuple]] = []

    def __enter__(self):
        da = module("decode_attention")
        self._orig = da.decode_attention

        def wrapped(*args):
            self.calls.append((self.label, args))
            return self._orig(*args)

        da.decode_attention = wrapped
        return self

    def __exit__(self, *exc):
        module("decode_attention").decode_attention = self._orig


def decode_breakdown(q, k, v, cache_len) -> dict:
    """``host_breakdown`` of one ``decode_attention`` call on these inputs."""
    import torch

    da = module("decode_attention")
    b, h, hd = q.shape
    t, hk = k.shape[1], k.shape[2]
    chunk, splits = da.split_plan(b, hk, h // hk, t)
    out = torch.empty_like(q)
    part = torch.empty(max(splits, 2) * b * h * (hd + 2), dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), cache_len.data_ptr(), b, t, h, hk, hd,
            1.0 / math.sqrt(hd), chunk, splits, out.data_ptr(), part.data_ptr())
    rec = {"shapes": [list(q.shape), list(k.shape)], "splits": splits}
    rec.update(host_breakdown(
        f"decode_attention at q {rec['shapes'][0]} k {rec['shapes'][1]} ({splits} splits)",
        da._LAUNCH[q.dtype], q.device.index, args,
        {"checks": lambda: da._check(q, k, v, cache_len),
         "plan": lambda: da.split_plan(b, hk, h // hk, t),
         "allocation": lambda: (torch.empty_like(q), torch.empty(
             splits * b * h * (hd + 2), dtype=torch.float32, device=q.device)),
         "pointers": lambda: (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              cache_len.data_ptr(), out.data_ptr(), part.data_ptr())},
        {"whole_call_us": lambda: da.decode_attention(q, k, v, cache_len)}))
    return rec


def decode_bound(q, k, cache_len) -> tuple[float, str, int, int]:
    """Least time for one decode-attention call on these inputs.

    Bytes: the valid K/V prefix of each row (min(len, T) positions of Hk x hd
    each, K and V) read once, q and len read once, o written once.
    Operations: a dot product with each valid key and a weighted add of each
    valid value, 4 * H * hd flops per valid position (float32, outside the
    tensor cores, as the kernel computes them).
    """
    b, h, hd = q.shape
    t, hk = k.shape[1], k.shape[2]
    n_valid = int(cache_len.clamp(0, t).sum())
    n_bytes = 2 * n_valid * hk * hd * k.element_size() + 2 * q.numel() * q.element_size() + 4 * b
    return least_time(n_bytes, 4 * h * hd * n_valid)


def sdpa_inputs(q, k, v, cache_len):
    """The library call's inputs for a decode-attention call: [B, heads, len,
    hd] views and a [B, 1, 1, T] mask (built once, outside the timing)."""
    import torch

    t = k.shape[1]
    mask = (torch.arange(t, device=k.device)[None, :] < cache_len[:, None])[:, None, None]
    return q[:, :, None], k.transpose(1, 2), v.transpose(1, 2), mask


def sdpa_call(q, k, v, mask):
    """One ``scaled_dot_product_attention`` call computing the same function
    (timed as the yardstick only; the port never calls it)."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)[:, :, 0]


def check_decode(args, dtype_name: str) -> dict:
    """Kernel == plain within the tolerance, and two kernel calls bit for
    bit equal, on one call's inputs (raises otherwise); the bound of the
    call."""
    import torch

    da = module("decode_attention")
    got, want = da.decode_attention(*args), da.decode_attention_plain(*args)
    again = da.decode_attention(*args)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"decode_attention differs between two calls at "
                             f"{[list(a.shape) for a in args]}")
    err = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
    if not err <= KERNEL_TOL[dtype_name]:
        raise AssertionError(
            f"decode_attention kernel != plain: max abs err {err} > {KERNEL_TOL[dtype_name]} "
            f"at {[list(a.shape) for a in args]}"
        )
    bound_ms, bound_by, n_bytes, n_ops = decode_bound(args[0], args[1], args[3])
    return {"shapes": [list(a.shape) for a in args], "dtype": dtype_name,
            "max_abs_err": err, "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": n_bytes, "ops": n_ops}


def decode_random_cases():
    """(label, dtype name, inputs on the card) of the random decode checks:
    head dims 64-192, rep 1-8, a ragged T, rows of length 0, 1 and T."""
    import torch

    rng = np.random.default_rng(2)
    cases = []
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for hd in (64, 128, 160, 192):
            for rep in (1, 3, 4, 8):
                b, t, hk = 4, int(rng.integers(200, 1200)), 2
                lens = [0, 1, t, int(rng.integers(1, t + 1))]
                q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
                           .to(DEVICE, dtype)
                           for shape in ((b, rep * hk, hd), (b, t, hk, hd), (b, t, hk, hd)))
                cases.append((f"{dtype_name} hd={hd} rep={rep} T={t}", dtype_name,
                              (q, k, v, torch.tensor(lens, dtype=torch.int32, device=DEVICE))))
    return cases


def logits_agree(got, want, dtype: str) -> dict:
    """Decode logits against a prefill's: elementwise within DECODE_TOL
    absolute + relative (float32) or within DECODE_TOL x the RMS of the
    prefill's logits (bfloat16, where rounding noise follows the logits'
    scale, not each logit's); raises otherwise."""
    import torch

    got, want = got.float(), want.float()
    if not (torch.isfinite(got).all() and got.shape == want.shape):
        raise AssertionError(f"{dtype}: logits not finite or of shape {tuple(got.shape)}")
    err = (got - want).abs()
    rms = float(want.square().mean().sqrt())
    n_elementwise = int((err > DECODE_TOL + DECODE_TOL * want.abs()).sum())
    rec = {"max_abs_err": float(err.max()), "logits_rms": rms,
           "over_elementwise_tol": n_elementwise, "logits": want.numel(),
           "argmax_equal": int((got.argmax(-1) == want.argmax(-1)).sum())}
    ok = (n_elementwise == 0) if dtype == "float32" else (
        rec["max_abs_err"] <= DECODE_TOL * rms)
    print(f"decode vs prefill ({dtype}): max abs err {rec['max_abs_err']:.4f}, logits RMS "
          f"{rms:.3f}, {n_elementwise} of {want.numel()} logits over {DECODE_TOL} abs + rel, "
          f"argmax equal on {rec['argmax_equal']} of {want.shape[0]} rows")
    if not ok:
        raise AssertionError(f"decode vs prefill ({dtype}) disagree: {rec}")
    return rec


def decode_vs_prefill(model, cfg, prompts, out) -> dict:
    """The last decode step's logits (position p) against the last logits of
    one prefill over tokens[:p+1] (the plain attention path)."""
    import torch

    from repro_torch.models import init_cache, prefill

    seq = torch.cat([torch.as_tensor(np.stack(prompts), device=DEVICE),
                     out["tokens"][:, :-1]], dim=1)
    want, _ = prefill(model, cfg, seq, init_cache(cfg, seq.shape[0], seq.shape[1], DEVICE))
    return logits_agree(out["logits"], want, cfg.dtype)


def lm_phase() -> dict:
    """SmolLM-135M serving through ``repro_torch.launch.serve``, checked and
    measured; returns the decode_attention kernel line."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launcher
    from repro_torch.models import init_params

    da = module("decode_attention")
    big = decode_32k_call()  # one call at the decode_32k cell's shape, one layer
    torch.cuda.empty_cache()
    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    model = init_params(0, cfg, DEVICE)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"lm: {cfg.name} at its published widths ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}), {n_params} parameters from seed 0 "
          f"in {time.perf_counter() - t0:.2f} s")
    prompts = launcher.make_prompts(cfg.vocab, LM_REQUESTS, LM_PROMPT, LM_SHARED, seed=0)
    launcher.serve(model, cfg, [p[:64] for p in prompts[:2]], gen=4)  # warm
    launcher.serve(model, cfg, [p[:64] for p in prompts[:2]], gen=4, prefix_dag=True)

    runs = {}
    steps = LM_GEN - 1
    with DecodeRecorder() as rec:
        for mode in ("plain", "prefix-dag"):
            rec.label = mode
            torch.cuda.synchronize()
            da.LAUNCHES = 0
            out = launcher.serve(model, cfg, prompts, LM_GEN, prefix_dag=mode == "prefix-dag")
            torch.cuda.synchronize()
            launches = da.LAUNCHES
            if launches != cfg.n_layers * steps:
                raise AssertionError(f"lm {mode}: {launches} decode_attention launches, "
                                     f"want {cfg.n_layers} layers x {steps} steps")
            logits = out["logits"]
            if logits.shape != (LM_REQUESTS, cfg.vocab) or not torch.isfinite(logits.float()).all():
                raise AssertionError(f"lm {mode}: logits {tuple(logits.shape)} not finite")
            toks = out["tokens"]
            if toks.shape != (LM_REQUESTS, LM_GEN) or not ((toks >= 0) & (toks < cfg.vocab)).all():
                raise AssertionError(f"lm {mode}: tokens {tuple(toks.shape)} out of range")
            tok_s = steps * LM_REQUESTS / out["t_decode"]
            runs[mode] = dict(out, launches=launches, tok_s=tok_s)
            print(f"lm {mode}: {LM_REQUESTS} requests x {LM_PROMPT} prompt tokens "
                  f"({LM_SHARED} shared) + {LM_GEN} generated; prefill "
                  f"{out['t_prefill'] * 1e3:.2f} ms, decode {steps} steps in "
                  f"{out['t_decode'] * 1e3:.2f} ms = {tok_s:.1f} tok/s"
                  + ("" if out["savings"] is None else
                     f"; plan savings {100 * out['savings']:.1f}% of prefill tokens")
                  + f"; decode_attention launches {launches}")
    same = int((runs["plain"]["tokens"] == runs["prefix-dag"]["tokens"]).all(dim=1).sum())
    print(f"lm: plain and prefix-dag runs generate the same {LM_GEN} tokens on {same} of "
          f"{LM_REQUESTS} requests")
    agree = {"bfloat16": decode_vs_prefill(model, cfg, prompts, runs["plain"])}
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = init_params(0, cfg32, DEVICE)
    out32 = launcher.serve(model32, cfg32, prompts, LM_GEN)
    agree["float32"] = decode_vs_prefill(model32, cfg32, prompts, out32)
    del model32, out32

    # ---- decode_attention vs plain: random shapes, every recorded call -- #
    recs = {"random": [], "calls": []}
    for label, dtype_name, args in decode_random_cases():
        r = check_decode(args, dtype_name)
        r["case"] = label
        recs["random"].append(r)
    calls = [args for _l, args in rec.calls]
    for label, args in rec.calls:
        r = check_decode(args, "bfloat16")
        r["run"] = label
        recs["calls"].append(r)
    sdpa_args = [sdpa_inputs(*a) for a in calls]
    passes = {
        "ms": pass_ms([lambda a=a: da.decode_attention(*a) for a in calls]),
        "plain_ms": pass_ms([lambda a=a: da.decode_attention_plain(*a) for a in calls]),
        "library_ms": pass_ms([lambda a=a: sdpa_call(*a) for a in sdpa_args]),
    }
    want = expected_launches("decode_attention", calls)
    dev_ms, dev_events = device_pass_ms(lambda: [da.decode_attention(*a) for a in calls],
                                        want, "decode_attention")
    lib_dev_ms, lib_events = device_pass_ms(lambda: [sdpa_call(*a) for a in sdpa_args],
                                            len(calls))
    by = {"bytes": 0.0, "operations": 0.0}
    for r in recs["calls"]:
        by[r["bound_by"]] += r["bound_ms"]
    sdpa_err = max(float((sdpa_call(*s).float() - da.decode_attention_plain(*a).float())
                         .abs().max()) for s, a in zip(sdpa_args[:60], calls[:60]))
    print(
        f"decode_attention==plain on {len(recs['random'])} random shapes and all "
        f"{len(calls)} recorded calls (max abs err "
        f"{max(r['max_abs_err'] for r in recs['random'] + recs['calls']):.3g}); one pass of "
        f"the calls (CUDA events, median of {TIMING_REPS}): kernel {passes['ms']:.4f} ms plain "
        f"{passes['plain_ms']:.4f} ms library (scaled_dot_product_attention, max abs err "
        f"{sdpa_err:.3g} against plain) {passes['library_ms']:.4f} ms bound "
        f"{sum(by.values()):.5f} ms ({max(by, key=by.get)}); device (profiler) "
        + device_text(dev_ms, dev_events, want)
        + "; library device " + device_text(lib_dev_ms, lib_events, len(calls))
    )
    del sdpa_args
    breakdown = decode_breakdown(*calls[-1])

    # where a decode step's time goes: one profiled plain run of 8 steps
    wall_ms, dev, _ = profile_pass(lambda: launcher.serve(model, cfg, prompts, 9))
    busy_ms = sum(dev.values())
    profile_rec = {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms if dev else None,
        "kernel_ms": kernel_device_ms(dev, "decode_attention") if dev else None,
        "top_device_ops": sorted(dev.items(), key=lambda kv: -kv[1])[:10],
    }
    if dev:
        print(f"lm profiled plain run (prefill + 8 decode steps): wall {wall_ms:.1f} ms, "
              f"device busy {busy_ms:.3f} ms (idle share {1 - busy_ms / wall_ms:.4f}), "
              f"decode_attention {profile_rec['kernel_ms']:.3f} ms")
    else:
        print("lm profiled run: device time not measured (no device events)")

    OUT_DIR.mkdir(exist_ok=True)
    with open(OUT_DIR / "chip_smoke_lm.json", "w") as f:
        json.dump({
            "runs": {m: {k: r[k] for k in ("t_prefill", "t_decode", "savings", "launches",
                                           "tok_s")} for m, r in runs.items()},
            "decode_vs_prefill": agree, "decode_32k": big, "profile": profile_rec,
            "host_breakdown": breakdown,
            "random": recs["random"],
            "calls": recs["calls"],
        }, f, indent=1)
    return {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": KERNELS["decode_attention"].replaces,
        "launches": sum(r["launches"] for r in runs.values()),
        "max_abs_err": max(r["max_abs_err"] for r in recs["random"] + recs["calls"]
                           + [big]),
        "ms": passes["ms"], "plain_ms": passes["plain_ms"],
        "bound_ms": sum(by.values()), "bound_by": max(by, key=by.get),
        "library_ms": passes["library_ms"], "device_ms": dev_ms,
        "device_events": dev_events, "library_device_ms": lib_dev_ms,
        "library_device_events": lib_events,
        "matches_plain": True, "calls": len(calls),
        "decode_32k": big,
    }


def decode_32k_call() -> dict:
    """The kernel, its plain version and the library call at the decode_32k
    cell's shape for one SmolLM-135M layer (bf16, seeded lengths in [1, T])."""
    import torch

    da = module("decode_attention")
    b, t, h, hk, hd = (DECODE_32K[n] for n in ("b", "t", "h", "hk", "hd"))
    gen = torch.Generator(DEVICE).manual_seed(3)
    q = torch.randn((b, h, hd), generator=gen, device=DEVICE, dtype=torch.bfloat16)
    k = torch.randn((b, t, hk, hd), generator=gen, device=DEVICE, dtype=torch.bfloat16)
    v = torch.randn((b, t, hk, hd), generator=gen, device=DEVICE, dtype=torch.bfloat16)
    lens = torch.randint(1, t + 1, (b,), generator=gen, device=DEVICE, dtype=torch.int32)
    args = (q, k, v, lens)
    r = check_decode(args, "bfloat16")
    r["ms"] = cuda_ms(lambda: da.decode_attention(*args))
    # device time: a profiled pass of several calls, divided
    n = DECODE_32K_PROFILED
    want = expected_launches("decode_attention", [args] * n)
    ms, r["device_events"] = device_pass_ms(
        lambda: [da.decode_attention(*args) for _ in range(n)], want, "decode_attention")
    r["device_ms"] = None if ms is None else ms / n
    r["plain_ms"] = cuda_ms(lambda: da.decode_attention_plain(*args))
    sdpa_args = sdpa_inputs(*args)
    r["library_ms"] = cuda_ms(lambda: sdpa_call(*sdpa_args))
    ms, r["library_device_events"] = device_pass_ms(
        lambda: [sdpa_call(*sdpa_args) for _ in range(n)], n)
    r["library_device_ms"] = None if ms is None else ms / n
    r["library_max_abs_err"] = float(
        (sdpa_call(*sdpa_args).float() - da.decode_attention_plain(*args).float()).abs().max())
    r["mean_len"] = float(lens.float().mean())
    print(
        f"decode_attention at decode_32k (B={b} T={t} H={h}/{hk} hd={hd} bf16, mean len "
        f"{r['mean_len']:.0f}): kernel {r['ms']:.4f} ms, device (profiler) "
        + device_text(r["device_ms"], r["device_events"], want)
        + f", plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms (device "
        + device_text(r["library_device_ms"], r["library_device_events"], n)
        + ", max abs err "
        f"{r['library_max_abs_err']:.3g} against plain), bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']}, {r['bytes']} bytes); kernel max abs err {r['max_abs_err']:.3g}"
    )
    return r


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs one card",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    card = card_line()
    print(card)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")

    # ---- build: one nvcc per source, all started together --------------- #
    modules = [module(name) for name in KERNELS]

    def build(mod):
        t0 = time.perf_counter()
        lib = _build.build(mod._SOURCE)
        return lib, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(modules)) as pool:
        built = list(pool.map(build, modules))
    for mod, (lib, secs) in zip(modules, built):
        _build.load(mod._SOURCE)
        print(f"build: {lib.relative_to(ROOT)} in {secs:.2f} s")
    print(f"build: all {len(modules)} kernels in {time.perf_counter() - t0:.2f} s")

    lines = [*search_phase(card), lm_phase()]

    # ---- result lines --------------------------------------------------- #
    print(json.dumps({"kernels": lines}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
