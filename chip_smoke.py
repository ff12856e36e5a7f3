#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA card and check them.

    python3 chip_smoke.py            # from the repository root, one CUDA card

Phases (any failure exits non-zero, and no result line is printed):

  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the five kernels from ``src/repro_torch/csrc`` with nvcc, one
     process per source, all at once, with the time of each, and import
     each as a Python extension module; meanwhile the host builds phase
     3's corpus and index, and phase 14(a)'s two processes start;
  3. the fused search path at a realistic size: the synthetic discogs corpus
     of 20,000 releases (about 1.03 M nodes), ``KeywordSearchEngine`` on
     ``cuda``, the paper's nine queries x slca/elca x the tree and DAG
     indexes with ``backend="fused"`` through ``engine.query`` (warmed on
     Q4-Q9 first), then a
     ``QueryService(backend="fused")`` answering the 18 DAG queries
     submitted together.  The kernel's launch count is zeroed just before
     and read just after; the calls per route (rows / tiles) and each
     batch's shape are printed;
  4. every answer equals the port's ``"scalar"`` backend (the paper's host
     algorithms), and the ``"torch"`` backend's on Q4-Q9 equal it too (the
     DAG Q1-Q3 take seconds each in the host loop; they are left out of
     the torch pass for the run's time limit);
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
     4,096 and 8,192 slots; then, beside each main-path batch's bound and
     its device time (one profiled pass, cut per call), the roofline
     model's fused and chained bytes and ``fused_bw_ms``
     (``roofline/analysis.py::search_pipeline_bytes``, summed by route),
     and a traced fused query whose ``kernel.fused_round`` spans must carry
     the model and the route;
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
     (and ``torch.searchsorted``, in turns); for ``searchsorted``, a
     registered op, the whole call beside the direct launch (the wrapper
     before the op);
  8. the distributed search (``repro_torch.dist.search_shard``) on the
     same corpus: the nine queries' tree-index lists, packed once and
     handed to ranks spawned by ``torch.multiprocessing``: (a) one rank a
     card over NCCL, mesh (1, cards); (b) 4 ranks sharing the card over
     gloo, mesh (1, 4), each list cut into 4 segments; both with
     ``backend="torch"`` and ``"chained"``, the nine queries x slca/elca,
     each query's time beside the single-device ``run_query`` in turns
     (p50, max); (c) the same ranks on mesh (2, 2), chained; (d)
     ``make_distributed_search`` on (b)'s mesh, one call per k and
     semantics.  Every answer equals ``"scalar"`` on every rank ((d) also
     the single-device ``ca_search_batch``); each rank's searchsorted
     launches are zeroed before and read after its counted pass and each
     (d) call (> 0 under chained, == the calls recorded) and its recorded
     calls held against plain;
  9. the sharded cluster on the same corpus: ``build_cluster`` into 4
     shards on ``cuda``, then ``backends="fused"`` on the thread and process
     transports and ``"chained"`` on the thread and remote transports (4
     shard servers started by ``launch_cluster_servers``), each beside a
     mono ``QueryService`` on the same backend: the nine paper queries and
     ``tests/test_cluster.py``'s seven cross-shard cases x slca/elca, one at
     a time with the services in turns (p50, max; the mono service on the
     light queries only: its host loop on the heavy ones is phase 3's), then
     all at once through
     ``submit`` (wall, queries per second).  Every answer equals
     ``"scalar"``; the in-process fused_search / searchsorted counter is
     zeroed before and read after the thread transport's run (> 0), every
     shard's PlanCache launches are > 0, and the shard processes' device
     memory is read as the card's used memory before and after they exit
     (nvidia-smi's compute apps printed beside);
  10. the HTTP gateway and the rebalancer over phase 9's cluster: (a) an
     in-process ``Gateway`` over the thread transport with
     ``backends="fused"``: the 32 queries POSTed on localhost, each light one
     beside ``svc.query`` on the same service, in turns (p50, max; its
     fused_search calls recorded and held against the plain version), a
     second pass all ``cached``, and every debug route; (b) under traffic
     (a client POSTing the light queries through a second gateway whose
     1-entry cache always misses) ``plan_rebalance`` on the live load report
     with shard 0 hot proposes a split and ``repartition_publish`` applies it
     (4 -> 5 shards; publish and converge times; 0 client errors; the 32
     uncached afterwards); (c) a gateway over 4 shard servers with
     ``backends="chained"``, shard 0 moved to a new server by
     ``move_shard`` (cached entries stay valid; the new server's own
     searchsorted launches > 0); (d) a gateway child (``launch_gateway``,
     process transport, fused; each shard process's own fused_search
     launches > 0, read from its ``/debug/heat``).  Every answer equals
     ``scalar``;
  11. first, one decode-attention call at the decode_32k cell's shape (B
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
     time) and the host breakdown of one call (the registered op beside
     the direct launch, as searchsorted's); last, one profiled serving
     run of 8 decode steps (device busy and idle share);
  12. LM training (``train_phase``): (a) SmolLM-135M at its published
     widths in bf16 through ``repro_torch.launch.train``'s pieces (AdamW,
     ``data/pipeline.py``, batch 8 x 1,024, 20 steps, a checkpoint every
     10) under ``train.fault.run_supervised``, with a step that raises once
     before step 15: the supervisor restores step 10 and replays 10-14, whose
     losses must equal the first pass's (deterministic algorithms on); the
     last loss must be below the first, and the first batch must score
     lower after training than before; median step ms, tokens/s, 6·N·tokens
     a step as a share of the bf16 peak, peak device memory and the
     checkpoint save and restore seconds; (b) one step at SmolLM's widths
     cut to 2 layers (float32, 2 x 128) on the card against the CPU from one
     seeded state; (c) 4 gloo ranks sharing the card, mesh (2, 2) (9 heads
     over "model" 2: the positions route of ``dist/local.py``), two steps
     against one device, then the checkpoint's elastic restore onto mesh
     (1, 4).  No kernel of the port lies on this path;
  13. the MoE, MLA, Mamba and RWKV-6 blocks (``blocks_phase``): (a)
     DeepSeek-V2-Lite-16B whole (27 layers, MLA + 64 experts top-6 + 2
     shared, 15.7 B parameters) in bf16 with seeded weights, served through
     ``launch.serve`` as SmolLM is (8 x 1,024 + 64, plain and with the
     prefix DAG): prefill ms, decode tok/s, peak device memory; then the
     last decode step's logits against a prefill over the same tokens, on 2
     requests served again with ``capacity_factor = E/k`` (no token
     dropped: a decode step's capacity differs from a prefill's), each MoE
     layer's expert choices compared and a flip reported with its row.  In
     bf16 near-tied experts flip between the two on most rows, so the bf16
     gate is the bf16 model's own rounding: the decode-vs-prefill error at
     most twice the distance s of the bf16 prefill from a float32 copy's
     prefill on the same tokens (each side carries about s; 0.15 x the RMS
     recorded beside it); the float32 copy
     (62.8 GB) then takes the same check at the elementwise float32 gate
     with no flip; (b) one MLA and one MoE layer at its widths in float32
     over 512 tokens, card against CPU: the router's choices equal, the
     outputs within 1e-4 of their largest value; (c) rwkv6-1.6b at its
     published widths, served and checked as (a) on all 8 requests; (d)
     llama4-maverick at its published widths cut to its 2-layer period
     (dense + MoE, 18.7 B parameters), served the same way, its
     decode_attention launches counted from 0 over the run (2 GQA layers x
     63 steps) and every call held against the plain version (rep 5, hd
     128); its check on 2 requests at the bf16 gate (0.15 x the RMS) on the
     rows whose experts did not flip (its float32 copy would not fit); (e)
     the four archs at reduced widths with their kinds kept, float32: a
     forward, a prefill and decode steps, and 2 AdamW steps, card against
     CPU within 1e-4 of each output's and leaf's largest value (llama4's
     top-1 router gets no gradient in exact arithmetic: its moments are
     held to be float noise).  Each model is freed before the next is
     built;
  14. the dry-run (``dryrun_phase``): (a) ``python -m
     repro_torch.launch.dryrun --arch smollm-135m --shape decode_32k`` with
     its accounting, and ``--search``, each in a subprocess started with
     the build (fake tensors over a fake group of 256 ranks; the card is
     not used) and read here: each record's
     ok, mesh, chips, memory, costs and roofline terms, the
     ``repro_torch::decode_attention`` calls in the op table (30, one a
     layer) and the host seconds of the trace; (b) SmolLM-135M at this
     script's sizes in bf16 from seed 0, a prefill of 8 x 1,024, one decode
     step against a full cache of 1,088 and one AdamW train step on 8 x
     1,024: each step's one-device trace (``dryrun.lower_step``) beside the
     same step on the card under ``FlopCounterMode`` after
     ``reset_peak_memory_stats``: the FLOPs equal, the predicted bytes above
     the arguments within 2% of the measured peak above what was allocated
     before the step, and the step's CUDA-event ms beside the trace's
     roofline bound (FLOPs over the bf16 peak, the byte proxy over the HBM
     rate) and its share of it; each step traced on fake ``cpu`` tensors
     too (the trace a host without CUDA makes) with the same costs and
     memory; the decode step's 30 decode_attention launches each held
     against plain; (b') a reduced train step on a fake (2, 2) mesh traced
     on fake ``cuda`` and fake ``cpu`` tensors: the same costs;
  15. a ``{"kernels": [...]}`` line with all five kernels (searchsorted's
     with ``dist_launches`` per run and rank and ``dist_max_abs_err``,
     folded into ``max_abs_err``; decode_attention's launches summed over
     the SmolLM, llama4 and dry-run decode steps, each also apart), the
     nvidia-smi line, and as the last line ``{"ok": true, "device":
     {...}}``.

Profiler device times are reported only from a pass in which the profiler
recorded every launch the pass made (``expected_launches``), else as not
measured.  Per-call details go to ``OUT_DIR``: ``chip_smoke_rounds.json``
(search), ``chip_smoke_dist.json`` (distributed search),
``chip_smoke_cluster.json`` (cluster), ``chip_smoke_gateway.json`` (gateway),
``chip_smoke_lm.json`` (LM), ``chip_smoke_train.json`` (training),
``chip_smoke_blocks.json`` (the MoE, MLA, Mamba and RWKV-6 archs) and
``chip_smoke_dryrun.json`` (the dry-run, beside the CLI's own records
``dryrun_decode_32k.json`` and ``dryrun_search.json``).
"""
from __future__ import annotations

import importlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from pathlib import Path
from typing import NamedTuple

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.roofline.analysis import HW, search_pipeline_bytes  # noqa: E402

DEVICE = "cuda"
N_RELEASES = 20_000  # the paper's corpus is the 4.2 M-release discogs dump
SEMANTICS = ("slca", "elca")
INDEXES = ("dag", "tree")
HBM_BYTES_PER_S = HW["hbm_bw"]  # H100 SXM, NVIDIA data sheet (roofline/analysis.py)
SCALAR_OPS_PER_S = 67e12  # H100 SXM 32-bit rate outside the tensor cores
TIMING_REPS = 10  # was 25, then 15; later phases share the run's time limit
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


def profile_trace(fn) -> tuple[float, list[tuple[str, float, float]]]:
    """Run ``fn`` twice under torch.profiler, a warm-up step and then a
    recorded step: (wall ms, [(device op, start us, ms)] in start order) of
    the recorded one.

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
    ops = sorted(
        ((evt.name, evt.time_range.start, evt.time_range.elapsed_us() / 1e3)
         for evt in prof.events()
         if evt.device_type == DeviceType.CUDA and not evt.name.startswith("ProfilerStep")),
        key=lambda op: op[1],
    )
    return wall_ms, ops


def profile_pass(fn) -> tuple[float, dict[str, float], dict[str, int]]:
    """``profile_trace`` summed by device op: (wall ms, {device op: ms},
    {device op: events}) of the recorded step."""
    wall_ms, ops = profile_trace(fn)
    dev: dict[str, float] = {}
    events: dict[str, int] = {}
    for name, _start, ms in ops:
        dev[name] = dev.get(name, 0.0) + ms
        events[name] = events.get(name, 0) + 1
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


def device_ms_per_call(fn, per_call: list[dict[str, int]], name: str,
                       tries: int = 3) -> list[float] | None:
    """Device ms of each call of one profiled pass ``fn`` of kernel
    ``name``, whose calls launch ``per_call`` (``expected_launches`` of each
    call, in order): the pass's device ops of the kernel, in start order, cut
    into the calls' launches; each call's ops must be the ones it makes.
    None (not measured) when no pass of ``tries`` was recorded in full."""
    ops = KERNELS[name].device_ops
    for _ in range(tries):
        _, trace = profile_trace(fn)
        mine = [(op, ms) for op, _start, ms in trace if any(p in op for p in ops)]
        out, at, whole = [], 0, len(mine) == sum(sum(c.values()) for c in per_call)
        for launches in per_call if whole else ():
            n = sum(launches.values())
            got = {p: sum(p in op for op, _ms in mine[at:at + n]) for p in ops}
            whole = whole and got == {p: launches.get(p, 0) for p in ops}
            out.append(sum(ms for _op, ms in mine[at:at + n]))
            at += n
        if whole:
            return out
    return None


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


def fused_vs_plain(batch: dict, semantics: str) -> tuple[int, int]:
    """Kernel == plain on one packed batch (raises otherwise): the largest
    difference of the result ids (0) and the number of results kept."""
    import torch

    fused_search_batch, fused_search_batch_plain, _ = functions("fused_search")
    ids, mask = fused_search_batch(**batch, semantics=semantics)
    want_ids, want_mask = fused_search_batch_plain(**plain_of(batch), semantics=semantics)
    torch.cuda.synchronize()
    if not (torch.equal(ids, want_ids) and torch.equal(mask, want_mask)):
        bad = int((ids != want_ids).sum()) + int((mask != want_mask).sum())
        raise AssertionError(f"kernel != plain on {bad} slots ({semantics})")
    return int((ids.long() - want_ids.long()).abs().max()), int(mask.sum())


def check_kernel(batch: dict, semantics: str) -> dict:
    """Kernel == plain on one packed batch (raises otherwise); times both."""
    fused_search_batch, fused_search_batch_plain, _ = functions("fused_search")
    plain_args = plain_of(batch)
    err, kept = fused_vs_plain(batch, semantics)
    rows, m0 = batch["ids0"].shape
    rec = {
        "rows": int(rows), "k": int(batch["other_ids"].shape[1] + 1),
        "m0": int(m0), "mo": int(batch["other_ids"].shape[2]),
        "semantics": semantics, "max_abs_err": err,
        "kept": kept, "route": fused_route(batch, semantics),
    }
    bound_ms, bound_by, n_bytes, n_ops = bound_of(batch, semantics)
    model = search_pipeline_bytes(rows=rec["rows"], k=rec["k"], m0=rec["m0"],
                                  mo=rec["mo"], semantics=semantics)
    rec.update(
        model_fused_bytes=model.fused_bytes, model_fused_bw_ms=model.fused_bw_ms,
        model_chained_bytes=model.chained_bytes, model_bytes_ratio=model.bytes_ratio,
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


def check_fused_span(engine) -> list[dict]:
    """A traced fused query's ``kernel.fused_round`` spans carry the roofline
    model of their batch (``search_pipeline_bytes``) and the kernel's route
    (raises otherwise); returns their attributes."""
    fs = module("fused_search")
    phases: list = []
    engine._query(["vinyl", "reissue"], "slca", "dag", "fused", None, phases=phases)
    spans = [p["attrs"] for p in phases if p["name"] == "kernel.fused_round"]
    if not spans:
        raise AssertionError("the traced fused query recorded no kernel.fused_round span")
    for a in spans:
        want = search_pipeline_bytes(rows=a["rows"], k=a["k"], m0=a["m0"], mo=a["mo"],
                                     semantics=a["semantics"]).attrs()
        if ({key: a.get(key) for key in want} != want
                or a.get("route") != fs.route(a["m0"], a["k"], a["semantics"])):
            raise AssertionError(f"a kernel.fused_round span lacks the model: {a}")
    return spans


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


def chained_vs_plain(name: str, args) -> int:
    """Kernel == plain on one call's inputs (raises otherwise): the largest
    difference of the outputs (0)."""
    import torch

    kernel, plain, _ = functions(name)
    got, want = kernel(*args), plain(*args)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        bad = sum(int((g != w).sum()) for g, w in zip(got, want))
        raise AssertionError(f"{name} kernel != plain on {bad} outputs")
    return max(
        (int((g.long() - w.long()).abs().max()) for g, w in zip(got, want)
         if g.numel()),
        default=0,
    )


def check_chained(name: str, args) -> dict:
    """Kernel == plain on one call's inputs (raises otherwise); times all."""
    kernel, plain, library = functions(name)
    err = chained_vs_plain(name, args)
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
    ``torch.searchsorted``; the whole call (the registered op) beside the
    direct launch."""
    import torch

    ss = module("searchsorted")
    rows, m = a.shape
    out = torch.empty_like(q)
    args = (a.data_ptr(), q.data_ptr(), rows, m, q.shape[1], out.data_ptr())
    rec = {"shapes": [list(a.shape), list(q.shape)]}
    rec.update(host_breakdown(
        f"searchsorted at {rec['shapes']}", ss._LAUNCH, a.device.index, args,
        {"checks": lambda: ss._check(a, q),
         "allocation": lambda: torch.empty_like(q),
         "pointers": lambda: (a.data_ptr(), q.data_ptr(), out.data_ptr())},
        {"whole_call_us": lambda: ss.searchsorted(a, q),
         "direct_launch_us": lambda: ss._launch(a, q),
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


class Corpus(NamedTuple):
    tree: object
    engine: object
    gen_s: float
    build_s: float


def search_corpus() -> Corpus:
    """The corpus and its engine on the card (host work only: ``main``
    runs it while the kernels compile)."""
    from repro_torch.core import KeywordSearchEngine
    from repro_torch.data import generate_discogs_tree

    t0 = time.perf_counter()
    tree = generate_discogs_tree(n_releases=N_RELEASES, seed=0)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine = KeywordSearchEngine(tree, device=DEVICE)
    return Corpus(tree, engine, t_gen, time.perf_counter() - t0)


def search_phase(card: str, corpus: Corpus):
    """The fused and chained search paths, checked and measured; returns
    their kernel lines, the corpus, its engine on the card and the scalar
    answers."""
    import torch

    from repro_torch.core import PlanCache
    from repro_torch.kernels import fused_search

    # ---- corpus + engine on the card ---------------------------------- #
    tree, engine, t_gen, t_build = corpus
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
    # warm (CUDA context, allocator, pinned pool) on Q4-Q9: the DAG Q1-Q3
    # take seconds each in the host loop and need no warming
    run_engine(engine, "fused", names=("Q4", "Q5", "Q6", "Q7", "Q8", "Q9"))
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
    # the torch backend (no kernel of the port) runs the queries but the
    # DAG Q1-Q3, whose host loops take seconds each and are timed on the
    # kernels' paths: the run's time limit
    light = ("Q4", "Q5", "Q6", "Q7", "Q8", "Q9")
    scalar, scalar_lat = run_engine(engine, "scalar")
    run_engine(engine, "torch", names=light)  # warm
    vec, torch_ms = run_engine(engine, "torch", names=light)
    torch_lat = dict(zip(((n, s, i) for n, _w, s, i in query_matrix(light)), torch_ms))
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
                      ("torch Q4-Q9", torch_ms), ("scalar", scalar_lat)):
        print(f"per-query ms {name}: p50 {np.percentile(lat, 50):.3f} "
              f"max {max(lat):.3f} over {len(lat)} queries")
    per_query = [
        {"query": f"{n} {s} {i}", "ids": int(fused[(n, s, i)].size),
         "fused_ms": f, "chained_ms": ch, "torch_ms": torch_lat.get((n, s, i)),
         "scalar_ms": c}
        for (n, _w, s, i), f, ch, c in zip(query_matrix(), fused_lat, chained_lat, scalar_lat)
    ]
    for q in sorted(per_query, key=lambda q: -q["fused_ms"])[:4]:
        torch_text = "-" if q["torch_ms"] is None else f"{q['torch_ms']:.1f} ms"
        print(f"slowest fused: {q['query']} {q['ids']} ids: fused "
              f"{q['fused_ms']:.1f} ms chained {q['chained_ms']:.1f} ms torch "
              f"{torch_text} scalar {q['scalar_ms']:.1f} ms")

    # where a fused query's time goes: one profiled pass of the queries
    # other than the DAG Q1-Q3 (their host loops are timed above)
    wall_ms, dev, _ = profile_pass(lambda: run_engine(engine, "fused", names=light))
    busy_ms = sum(dev.values())
    profile_rec = {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms if dev else None,
        "kernel_ms": kernel_device_ms(dev, "fused_search") if dev else None,
        "top_device_ops": sorted(dev.items(), key=lambda kv: -kv[1])[:8],
    }
    if dev:
        print(
            f"profiled fused pass ({len(query_matrix(light))} queries, Q4-Q9): wall "
            f"{wall_ms:.1f} ms, device "
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

    # ---- the roofline model (roofline/analysis.py) beside each round ----- #
    round_dev = device_ms_per_call(lambda: [
        fused_search.fused_search_batch(**b, semantics=s) for _l, b, s in rounds
    ], [fused_launches(fused_route(b, s), s) for _l, b, s in rounds], "fused_search")
    model_routes: dict[str, dict] = {}
    for i, r in enumerate(round_recs):
        r["device_ms"] = None if round_dev is None else round_dev[i]
        print(
            f"roofline model, round {r['query']} ({r['route']}, R={r['rows']} k={r['k']} "
            f"m0={r['m0']} mo={r['mo']} {r['semantics']}): fused {r['model_fused_bytes']} B "
            f"= {r['model_fused_bw_ms']:.6f} ms at {HBM_BYTES_PER_S:.3e} B/s, chained "
            f"{r['model_chained_bytes']} B (ratio {r['model_bytes_ratio']:.3f}); bound "
            f"{r['bound_ms']:.6f} ms ({r['bytes']} B, {r['bound_by']}); device "
            + ("not measured" if round_dev is None else f"{round_dev[i]:.4f} ms")
        )
        t = model_routes.setdefault(r["route"], {
            "rounds": 0, "fused_fewer_bytes": 0, "model_fused_bytes": 0,
            "model_chained_bytes": 0, "model_fused_bw_ms": 0.0, "bound_bytes": 0,
            "bound_ms": 0.0, "device_ms": None if round_dev is None else 0.0})
        t["rounds"] += 1
        t["fused_fewer_bytes"] += r["model_fused_bytes"] < r["model_chained_bytes"]
        for key in ("model_fused_bytes", "model_chained_bytes", "model_fused_bw_ms",
                    "bound_ms"):
            t[key] += r[key]
        t["bound_bytes"] += r["bytes"]
        if round_dev is not None:
            t["device_ms"] += round_dev[i]
    print(f"roofline model over the {len(round_recs)} main-path rounds, by route: "
          f"{json.dumps(model_routes)}")
    spans = check_fused_span(engine)
    print(f"traced fused query (vinyl reissue, slca, dag): {len(spans)} kernel.fused_round "
          f"span(s) carry the model and the route: " + "; ".join(
              f"{a['route']} fused {a['fused_bytes']} B chained {a['chained_bytes']} B "
              f"ratio {a['bytes_ratio']:.3f}" for a in spans))

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
                   "intersect_random_windows": random_windows,
                   "roofline_model_by_route": model_routes,
                   "fused_round_spans": spans},
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
    return [fused_line, *chained_lines], tree, engine, scalar


# --------------------------------------------------------------------------- #
# The distributed search: every list cut into segments over a "model" group
# --------------------------------------------------------------------------- #

DIST_RANKS = 4  # ranks that share the card over gloo (NCCL refuses two on one card)
DIST_TIMEOUT_S = 60  # a hung rank fails its collective, and the phase
DIST_REPS = 4  # timed passes a (query, semantics): distributed and single-device in turns
DIST_BACKENDS = ("torch", "chained")


def dist_batch_arrays(lists: dict) -> dict:
    """``make_distributed_search``'s inputs from the nine queries' lists: per
    k, ``[Q, k, width]`` int32 ids (INT_PAD tails), parent ids and NDesc of
    each query's lists, shortest first, width the bucket of the longest list
    of the k's queries; and the queries' names."""
    from repro_torch.kernels.shapes import INT_PAD, bucket

    out = {}
    for k in sorted({len(ls) for ls in lists.values()}):
        names = [n for n, ls in lists.items() if len(ls) == k]
        width = bucket(max(len(l) for n in names for l in lists[n]))
        ids = np.full((len(names), k, width), INT_PAD, np.int32)
        pid = np.full_like(ids, -1)
        nd = np.zeros_like(ids)
        for q, name in enumerate(names):
            for j, l in enumerate(sorted(lists[name], key=len)):
                n = len(l)
                ids[q, j, :n], nd[q, j, :n] = l.ids, l.ndesc
                pid[q, j, :n] = np.where(l.pidpos >= 0, l.ids[np.clip(l.pidpos, 0, n - 1)], -1)
        out[k] = {"names": names, "ids": ids, "pid": pid, "ndesc": nd}
    return out


def dist_rank(rank: int, world: int, port: int, pg_backend: str, plan: dict,
              out_dir: str, job=None) -> None:
    """One rank of the distributed or the training phase (started by
    ``torch.multiprocessing`` with the spawn method): joins the process
    group, runs ``plan`` (``job``, by default ``dist_rank_runs``) and writes
    its result to ``out_dir``."""
    import datetime

    import torch.distributed as dist

    dist.init_process_group(pg_backend, init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    try:
        out = (job or dist_rank_runs)(plan)
    finally:
        dist.destroy_process_group()
    with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
        json.dump(out, f)


def dist_rank_runs(plan: dict) -> dict:
    """A rank's runs: for each (label, model-axis size, backends, timed) of
    ``plan["runs"]``, a mesh, a warm pass and a counted pass of the nine
    queries x slca/elca through ``distributed_query`` on each backend (every
    answer must equal scalar's; this rank's searchsorted launches zeroed
    before and read after the counted pass, its calls recorded and each held
    against plain), and when timed, ``DIST_REPS`` passes with each query
    beside the single-device ``run_query`` on the same backend, in turns.
    Then, when ``plan["batch"]`` is given, ``make_distributed_search`` on
    the first run's mesh for each k, against the single-device
    ``ca_search_batch`` and against scalar, its searchsorted launches
    counted, its calls recorded and each held against plain."""
    import torch

    from repro_torch.core.search_vec import INT_PAD, ca_search_batch, run_query
    from repro_torch.dist.search_shard import distributed_query, make_distributed_search
    from repro_torch.launch.mesh import make_host_mesh, rank_device

    dev = rank_device("cuda")
    lists, want = plan["lists"], plan["want"]
    queries = [(name, sem) for name in lists for sem in SEMANTICS]
    out, meshes = {"device": str(dev)}, {}
    for label, model, backends, timed in plan["runs"]:
        mesh = meshes[label] = make_host_mesh(model)
        run = out[label] = {"mesh": list(mesh.shape)}
        for backend in backends:
            def one(name, sem, backend=backend, mesh=mesh):
                return distributed_query(lists[name], mesh, sem, backend=backend)

            for name, sem in queries:  # warm
                one(name, sem)
            torch.cuda.synchronize()
            module("searchsorted").LAUNCHES = 0
            with CallRecorder() as calls:
                got = {(name, sem): one(name, sem) for name, sem in queries}
            launches = module("searchsorted").LAUNCHES
            for (name, sem), ids in got.items():
                if not np.array_equal(ids, want[f"{name} {sem}"]):
                    raise AssertionError(
                        f"{label} {backend} {name} {sem}: {ids.size} ids, scalar gives "
                        f"{len(want[f'{name} {sem}'])} (rank device {dev})")
            recorded = calls.calls["searchsorted"]
            if launches != len(recorded):
                raise AssertionError(f"{launches} searchsorted launches, {len(recorded)} calls")
            if backend == "chained" and launches <= 0:
                raise AssertionError(f"{label}: the chained distributed search launched "
                                     "no searchsorted kernel")
            rec = run[backend] = {
                "answers": len(got), "launches": launches,
                "max_abs_err": max((chained_vs_plain("searchsorted", a) for _l, a in recorded),
                                   default=0),
            }
            if not timed:
                continue
            lat = {"dist": {q: [] for q in queries}, "single": {q: [] for q in queries}}
            for rep in range(DIST_REPS):
                for name, sem in queries:
                    for which in (("dist", "single") if rep % 2 == 0 else ("single", "dist")):
                        t0 = time.perf_counter()
                        if which == "dist":
                            one(name, sem)
                        else:
                            run_query(lists[name], sem, backend, dev)
                        lat[which][(name, sem)].append((time.perf_counter() - t0) * 1e3)
            for which, per in lat.items():
                med = [float(np.median(ms)) for ms in per.values()]
                rec[f"{which}_p50_ms"] = float(np.percentile(med, 50))
                rec[f"{which}_max_ms"] = max(med)
    if plan.get("batch"):
        mesh = meshes[plan["runs"][0][0]]
        m, r = mesh.size(1), mesh.get_local_rank("model")
        batch = out["batch"] = {"calls": 0, "launches": 0, "max_abs_err": 0}
        for k, arr in plan["batch"].items():
            full = {n: torch.from_numpy(np.asarray(arr[n], np.int32)).to(dev)
                    for n in ("ids", "pid", "ndesc")}
            q, kk, width = full["ids"].shape
            seg = [full[n].reshape(q, kk, m, width // m)[:, :, r].contiguous()
                   for n in ("ids", "pid", "ndesc")]
            n_valid = (full["ids"] < INT_PAD).sum(dim=-1, dtype=torch.int32)
            for sem in SEMANTICS:
                fn = make_distributed_search(mesh, int(k), sem, backend="chained")
                module("searchsorted").LAUNCHES = 0
                with CallRecorder() as calls:
                    ids, mask = fn(*seg)
                launches = module("searchsorted").LAUNCHES
                recorded = calls.calls["searchsorted"]
                if not 0 < launches == len(recorded):
                    raise AssertionError(f"make_distributed_search k={k} {sem}: {launches} "
                                         f"searchsorted launches, {len(recorded)} calls")
                batch["launches"] += launches
                batch["max_abs_err"] = max([batch["max_abs_err"], *(
                    chained_vs_plain("searchsorted", a) for _l, a in recorded)])
                want_ids, want_mask = ca_search_batch(
                    full["ids"][:, 0], full["pid"][:, 0], full["ndesc"][:, 0],
                    full["ids"][:, 1:].contiguous(), full["ndesc"][:, 1:].contiguous(),
                    n_valid[:, 0], n_valid[:, 1:].contiguous(), semantics=sem,
                    backend="chained")
                if not (torch.equal(ids, want_ids) and torch.equal(mask, want_mask)):
                    raise AssertionError(f"make_distributed_search k={k} {sem} != one device")
                ids, mask = ids.cpu().numpy(), mask.cpu().numpy()
                for row, name in enumerate(arr["names"]):
                    if not np.array_equal(ids[row][mask[row]], want[f"{name} {sem}"]):
                        raise AssertionError(f"make_distributed_search {name} {sem} != scalar")
                batch["calls"] += 1
    return out


def run_dist_ranks(world: int, pg_backend: str, plan: dict, job=None) -> list[dict]:
    """``plan`` (through ``job``, by default ``dist_rank_runs``) on
    ``world`` ranks of one process group, spawned: the result of every rank.
    A rank that fails makes this raise (the others are stopped); a hung
    collective fails after ``DIST_TIMEOUT_S``."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out_dir = tempfile.mkdtemp(prefix="chip-smoke-dist-")
    try:
        mp.spawn(dist_rank, args=(world, port, pg_backend, plan, out_dir, job),
                 nprocs=world, join=True)
        out = []
        for rank in range(world):
            with open(Path(out_dir) / f"rank{rank}.json") as f:
                out.append(json.load(f))
        return out
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def dist_phase(card: str, engine, scalar: dict) -> dict:
    """The distributed search on the search phase's corpus (its nine queries'
    tree-index lists, packed once here and handed to the ranks): (a) one rank
    a card over NCCL, mesh (1, cards), both backends; (b) 4 ranks on one card
    over gloo, mesh (1, 4), both backends; (c) the same ranks on mesh (2, 2),
    chained; (d) ``make_distributed_search`` on (b)'s mesh, one call per k
    and semantics.  Every answer equals scalar's on every rank; returns the
    searchsorted line's ``dist_*`` fields."""
    import torch

    from repro_torch.data import QUERIES

    t0 = time.perf_counter()
    lists = {name: engine.base.idlists(engine.keyword_ids(words))
             for name, (_cat, words) in QUERIES.items()}
    want = {f"{name} {sem}": scalar[(name, sem, "tree")].tolist()
            for name in lists for sem in SEMANTICS}
    batch = dist_batch_arrays(lists)
    cards = torch.cuda.device_count()
    nccl = f"nccl_1x{cards}"
    results = {
        "nccl": run_dist_ranks(cards, "nccl", {
            "runs": [(nccl, cards, DIST_BACKENDS, True)], "lists": lists, "want": want}),
        "gloo": run_dist_ranks(DIST_RANKS, "gloo", {
            "runs": [("gloo_1x4", DIST_RANKS, DIST_BACKENDS, True),
                     ("gloo_2x2", 2, ("chained",), False)],
            "lists": lists, "want": want, "batch": batch}),
    }
    launches, err = {}, 0
    for group, ranks in results.items():
        for label in [k for k in ranks[0] if k not in ("device", "batch")]:
            runs = [res[label] for res in ranks]
            launches[label] = [run["chained"]["launches"] for run in runs]
            err = max([err, *(run[b]["max_abs_err"] for run in runs for b in DIST_BACKENDS
                              if b in run)])
            print(f"dist {label} ({group}, mesh {tuple(runs[0]['mesh'])}, "
                  f"{len(ranks)} rank(s) on {sorted({res['device'] for res in ranks})}): "
                  f"{runs[0]['chained']['answers']} answers per backend equal scalar on every "
                  f"rank; searchsorted launches per rank under chained {launches[label]}, "
                  f"each == plain")
            for backend in DIST_BACKENDS:
                r0 = runs[0].get(backend, {})
                if "dist_p50_ms" in r0:
                    print(f"dist {label} {backend}, per-query ms on rank 0 (median of "
                          f"{DIST_REPS}, in turns): distributed p50 {r0['dist_p50_ms']:.3f} "
                          f"max {r0['dist_max_ms']:.3f}; single-device run_query p50 "
                          f"{r0['single_p50_ms']:.3f} max {r0['single_max_ms']:.3f}")
    batch_out = [res["batch"] for res in results["gloo"]]
    launches["gloo_batch"] = [b["launches"] for b in batch_out]
    err = max([err, *(b["max_abs_err"] for b in batch_out)])
    print(f"dist make_distributed_search on gloo_1x4: {batch_out[0]['calls']} calls "
          f"(k in {sorted(batch)}, slca/elca) equal the single-device ca_search_batch and "
          f"scalar on every rank; searchsorted launches per rank {launches['gloo_batch']}, "
          f"each == plain")
    secs = time.perf_counter() - t0
    print(f"dist phase: {secs:.1f} s")
    OUT_DIR.mkdir(exist_ok=True)
    with open(OUT_DIR / "chip_smoke_dist.json", "w") as f:
        json.dump({"card": card, "seconds": secs, "ranks": results}, f, indent=1)
    return {"searchsorted": {"dist_launches": launches, "dist_max_abs_err": err}}


# --------------------------------------------------------------------------- #
# The sharded cluster: 4 shards of the same corpus on one card
# --------------------------------------------------------------------------- #

CLUSTER_SHARDS = 4  # the README's layout (partitioned indices behind one front door)
# tests/test_cluster.py's cross-shard / root-only cases, beside the paper's nine
CLUSTER_EXTRA = (
    ("releases",), ("release",), ("uk", "japan"), ("electronic", "jazz", "reggae"),
    ("img-3.jpg", "vinyl"), ("zzz-not-a-word",), ("vinyl",),
)
# backend -> transports that serve it; each run beside a mono QueryService
CLUSTER_RUNS = (("fused", ("thread", "process")), ("chained", ("thread", "remote")))
CLUSTER_HEAVY = {"Q1", "Q2", "Q3", "release", "vinyl"}  # thousands of ids each


def cluster_queries() -> list[tuple[str, tuple, str]]:
    from repro_torch.data import QUERIES

    named = [(n, tuple(w)) for n, (_c, w) in QUERIES.items()]
    named += [(" ".join(w), w) for w in CLUSTER_EXTRA]
    return [(n, w, sem) for n, w in named for sem in SEMANTICS]


def gpu_apps() -> list[str]:
    """nvidia-smi's line (pid, MiB) for each process holding a CUDA context.
    Inside a container it may report other pids and memory than the
    processes' own (one line per process, each with the container's pid and
    total): ``device_used_mib`` is the measure that counts."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()


def device_used_mib() -> float:
    """The card's used memory, every process's included (MiB), once it has
    held still for half a second (a child's context is freed as it exits)."""
    import torch

    def used() -> float:
        free, total = torch.cuda.mem_get_info()
        return (total - free) / 2**20

    prev, now = used(), None
    for _ in range(20):
        time.sleep(0.5)
        now = used()
        if now == prev:
            break
        prev = now
    return now


def open_cluster(path: str, transport: str, backend: str):
    """A ClusterService over the artifact at ``path`` on the card, and the
    shard servers it needs (the remote transport: one per shard, started
    by ``launch_cluster_servers``)."""
    from repro_torch.cluster import ClusterService
    from repro_torch.cluster.workers.server import launch_cluster_servers

    procs, endpoints = [], None
    if transport == "remote":
        procs, endpoints = launch_cluster_servers(path, backends=backend, device=DEVICE)
    try:
        svc = ClusterService.from_dir(path, transport=transport, backends=backend,
                                      endpoints=endpoints, device=DEVICE)
    except BaseException:
        stop_servers(procs)
        raise
    return svc, procs


def stop_servers(procs) -> None:
    for p in procs:
        p.terminate()
    for p in procs:
        try:
            p.wait(10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(10)


def shard_counts(svc, kernel: str) -> list[tuple[int, int | None]]:
    """Each shard's PlanCache runs so far and its process's launches of
    ``kernel`` so far, from the shard's own stats.  A thread worker reports
    no launches (None): its shards share this process's counter."""
    out = []
    for w in svc.workers:
        data = w.stats().data
        launched = data.get(f"kernel_launches_{kernel}")
        out.append((int(data.get("plan_launches_total", 0)),
                    None if launched is None else int(launched)))
    return out


def check_shard_counts(what: str, backend: str, runs: list, launched: list) -> None:
    """Every shard ran its PlanCache and launched its kernel in the counted
    burst.  A fused run is one fused_search launch; a chained run launches
    searchsorted once if its queries have two keywords or more, so at most
    once."""
    if min(runs) <= 0 or min(launched) <= 0:
        raise AssertionError(
            f"{what}: a shard launched nothing: runs {runs}, launches {launched}")
    if backend == "fused" and launched != runs:
        raise AssertionError(f"{what}: fused_search launches {launched} != runs {runs}")
    if backend == "chained" and any(k > r for k, r in zip(launched, runs)):
        raise AssertionError(f"{what}: searchsorted launches {launched} > runs {runs}")


def light_queries(queries) -> list[tuple[str, tuple, str]]:
    """The queries of ``cluster_queries`` that return few ids (Q4-Q6 and the
    light cross-shard cases): the warm-up set and the gateway's traffic."""
    return [(n, w, s) for n, w, s in queries
            if n in ("Q4", "Q5", "Q6") or (w in CLUSTER_EXTRA and n not in CLUSTER_HEAVY)]


def cluster_phase(card: str, tree, engine, path: str) -> dict:
    """4 shards of the search phase's corpus on the card, built into ``path``:
    every transport's answers against ``scalar``, kernel launches in every
    shard, latency beside a mono QueryService in turns, all queries at once,
    memory per process.  Returns, per kernel, the thread transport's counted
    launches and every such call held against the plain version, and the
    ``scalar`` answers of ``cluster_queries``."""
    import torch

    from repro_torch.cluster import build_cluster
    from repro_torch.serve import QueryService
    from repro_torch.serve.service import DRAIN_KERNELS

    queries = cluster_queries()
    heavy = CLUSTER_HEAVY
    warm = light_queries(queries)
    record = {"card": card, "shards": CLUSTER_SHARDS, "runs": []}
    in_process = {}
    t0 = time.perf_counter()
    manifest = build_cluster(tree, CLUSTER_SHARDS, path, device=DEVICE)
    t_build = time.perf_counter() - t0
    nodes = [s["node_end"] - s["node_start"] for s in manifest["shards"]]
    docs = [s["doc_hi"] - s["doc_lo"] for s in manifest["shards"]]
    print(f"cluster: {CLUSTER_SHARDS} shards of the {N_RELEASES}-release corpus "
          f"({tree.num_nodes} nodes) on one card: documents {docs}, nodes {nodes}; "
          f"host build + save {t_build:.2f} s")
    record.update(build_s=t_build, nodes=nodes, docs=docs)
    want = {(n, s): engine.query(list(w), semantics=s, backend="scalar")
            for n, w, s in queries}
    for backend, transports in CLUSTER_RUNS:
        name = DRAIN_KERNELS[backend]
        kernel = module(name)
        services, procs = {}, {}
        try:
            services["mono"] = QueryService(engine, backend=backend, device=DEVICE)
            start_s = {}
            for transport in transports:
                t0 = time.perf_counter()
                services[transport], procs[transport] = open_cluster(
                    path, transport, backend)
                start_s[transport] = time.perf_counter() - t0
            for svc in services.values():  # warm: a few light queries
                for _n, w, s in warm:
                    svc.query(list(w), s)
            # per-query latency, the services in turns (rotating order); the
            # mono service only on the light queries: its host loop on the
            # heavy ones is the search phase's, timed and checked there
            lat = {key: [] for key in services}
            keys = list(services)
            for i, (n, w, s) in enumerate(queries):
                turn = keys[i % len(keys):] + keys[:i % len(keys)]
                for key in (turn if n not in heavy else [k for k in turn if k != "mono"]):
                    t0 = time.perf_counter()
                    ids = services[key].query(list(w), s)
                    lat[key].append((time.perf_counter() - t0) * 1e3)
                    if not np.array_equal(ids, want[(n, s)]):
                        raise AssertionError(
                            f"cluster {backend} {key}: {n} {s} gives {ids.size} ids, "
                            f"scalar {want[(n, s)].size}")
            mono = lat["mono"]
            for transport in transports:
                svc = services[transport]
                # all queries at once: the counted run.  The thread
                # transport's kernel calls are recorded and held against
                # the plain version after it; a process or remote shard
                # counts its own launches, read before and after
                before = shard_counts(svc, name)
                torch.cuda.synchronize()
                for m in (CHAINED if backend == "chained" else (name,)):
                    module(m).LAUNCHES = 0
                recorder = (CallRecorder() if backend == "chained" else Recorder())
                with recorder if transport == "thread" else nullcontext():
                    recorder.label = f"cluster {transport}"
                    t0 = time.perf_counter()
                    futs = [svc.submit(list(w), s) for _n, w, s in queries]
                    got = [f.result(timeout=600) for f in futs]
                    wall = time.perf_counter() - t0
                    torch.cuda.synchronize()
                launches = kernel.LAUNCHES
                after = shard_counts(svc, name)
                for (n, _w, s), ids in zip(queries, got):
                    if not np.array_equal(ids, want[(n, s)]):
                        raise AssertionError(
                            f"cluster {backend} {transport} at once: {n} {s}")
                runs = [a[0] - b[0] for a, b in zip(after, before)]
                what = f"cluster {backend} {transport}"
                if transport == "thread":
                    recorded = (recorder.calls[name] if backend == "chained"
                                else recorder.rounds)
                    for m in (CHAINED if backend == "chained" else ()):
                        if module(m).LAUNCHES != len(recorder.calls[m]):
                            raise AssertionError(
                                f"{what}: {module(m).LAUNCHES} {m} launches but "
                                f"{len(recorder.calls[m])} calls recorded")
                    if launches != len(recorded):
                        raise AssertionError(
                            f"{what}: {launches} {name} launches but "
                            f"{len(recorded)} calls recorded")
                    # the shards share this process's counter: their runs add up
                    if min(runs) <= 0:
                        raise AssertionError(f"{what}: a shard ran nothing: {runs}")
                    check_shard_counts(what, backend, [sum(runs)], [launches])
                    shard_kernel = None
                    if backend == "fused":
                        errs = [fused_vs_plain(b, sem)[0] for _l, b, sem in recorded]
                    else:
                        errs = [chained_vs_plain(name, args) for _l, args in recorded]
                    in_process[name] = {
                        "cluster_thread_launches": launches,
                        "cluster_calls": len(recorded),
                        "cluster_matches_plain": True,
                        "cluster_max_abs_err": max(errs),
                    }
                    print(f"{what}: {name}==plain on all {len(recorded)} calls "
                          f"of the counted run (max abs err {max(errs)})")
                else:
                    if launches:
                        raise AssertionError(
                            f"{launches} in-process launches from a {transport} cluster")
                    shard_kernel = [a[1] - b[1] for a, b in zip(after, before)]
                    check_shard_counts(what, backend, runs, shard_kernel)
                stats = svc.stats().summary()
                if backend == "fused" and stats.get("fused_fallbacks"):
                    raise AssertionError(f"{transport}: a fused launch was demoted")
                # memory: the card's used memory before and after this
                # transport's shard processes exit is what they held; the
                # thread transport's shards live in this process
                apps = gpu_apps()
                used = device_used_mib()
                mem = {"device_used": used, "nvidia_smi_apps": apps,
                       "router_reserved": torch.cuda.memory_reserved() / 2**20}
                if transport != "thread":
                    svc.close()
                    stop_servers(procs[transport])
                    mem["after_exit"] = device_used_mib()
                    mem["shard_processes"] = used - mem["after_exit"]
                    if mem["shard_processes"] <= 0:
                        raise AssertionError(
                            f"{transport} shard processes held no device memory")
                c = lat[transport]
                heavy_ix = [i for i, (n, _w, _s) in enumerate(queries) if n in heavy]
                light_c = [t for i, t in enumerate(c) if i not in heavy_ix]
                run = {
                    "backend": backend, "transport": transport,
                    "start_s": start_s[transport],
                    "p50_ms": float(np.percentile(c, 50)), "max_ms": max(c),
                    "light_p50_ms": float(np.percentile(light_c, 50)),
                    "light_max_ms": max(light_c),
                    "mono_p50_ms": float(np.percentile(mono, 50)), "mono_max_ms": max(mono),
                    "heavy_ms": sum(c[i] for i in heavy_ix),
                    "at_once_wall_ms": wall * 1e3, "at_once_qps": len(queries) / wall,
                    "in_process_launches": launches, "shard_plan_runs": runs,
                    "shard_kernel_launches": shard_kernel,
                    "memory_mib": mem, "latency_ms": c, "mono_latency_ms": mono,
                }
                record["runs"].append(run)
                print(
                    f"cluster {backend} {transport}: started in {start_s[transport]:.2f} s; "
                    f"{len(queries)} queries equal scalar; per-query ms p50 "
                    f"{run['p50_ms']:.3f} max {run['max_ms']:.3f}; the "
                    f"{len(light_c)} light ones p50 {run['light_p50_ms']:.3f} max "
                    f"{run['light_max_ms']:.3f} (mono QueryService in turns, light only: "
                    f"p50 {run['mono_p50_ms']:.3f} max {run['mono_max_ms']:.3f}); "
                    f"the heavy 10 {run['heavy_ms']:.1f} ms; all at once {run['at_once_wall_ms']:.1f} "
                    f"ms, {run['at_once_qps']:.2f} queries/s; in that run, {name} "
                    f"launches in this process {launches}, PlanCache runs per shard "
                    f"{runs}"
                    + ("" if shard_kernel is None else
                       f", {name} launches per shard (its own count) {shard_kernel}"))
                print(
                    f"cluster {backend} {transport} memory (MiB): the card's used "
                    f"memory {used:.0f} with this backend's services up; this "
                    f"process's allocator holds {mem['router_reserved']:.0f}"
                    + ("" if transport == "thread" else
                       f"; {mem['after_exit']:.0f} once the {CLUSTER_SHARDS} shard "
                       f"processes exited: they held {mem['shard_processes']:.0f} ("
                       f"{mem['shard_processes'] / CLUSTER_SHARDS:.0f} each)")
                    + f"; nvidia-smi lists {len(apps)} compute apps "
                    f"(pid, MiB): {'; '.join(apps)}")
        finally:
            for svc in services.values():
                svc.close()
            for p in procs.values():
                stop_servers(p)
    OUT_DIR.mkdir(exist_ok=True)
    with open(OUT_DIR / "chip_smoke_cluster.json", "w") as f:
        json.dump(record, f, indent=1)
    return in_process, want


# --------------------------------------------------------------------------- #
# The HTTP gateway and the rebalancer over the cluster phase's 4 shards
# --------------------------------------------------------------------------- #

GATEWAY_ROUTES = ("/healthz", "/stats", "/metrics", "/debug/slow", "/debug/heat")


class HttpClient:
    """One keep-alive HTTP/1.1 connection to a gateway."""

    def __init__(self, endpoint: str):
        import http.client

        host, port = endpoint.rsplit(":", 1)
        self.conn = http.client.HTTPConnection(host, int(port), timeout=600)

    def request(self, method: str, path: str, body=None) -> tuple[int, bytes]:
        self.conn.request(method, path, body=None if body is None else json.dumps(body))
        resp = self.conn.getresponse()
        return resp.status, resp.read()

    def query(self, words, semantics: str) -> dict:
        """POST /query; the reply's JSON (raises on any status but 200)."""
        status, raw = self.request(
            "POST", "/query", {"keywords": list(words), "semantics": semantics})
        if status != 200:
            raise AssertionError(f"POST /query {list(words)} {semantics}: {status} {raw!r}")
        return json.loads(raw)

    def get(self, path: str) -> bytes:
        status, raw = self.request("GET", path)
        if status != 200:
            raise AssertionError(f"GET {path}: {status} {raw[:200]!r}")
        return raw

    def close(self) -> None:
        self.conn.close()


def http_pass(client, queries, want, what: str, cached: bool | None) -> list[float]:
    """Every query once over HTTP, in order: ids equal ``scalar`` and, unless
    ``cached`` is None, the reply's ``cached`` flag is ``cached``.  Returns the
    host-clock ms of each request."""
    lat = []
    for n, w, s in queries:
        t0 = time.perf_counter()
        out = http_check(client.query(w, s), want[(n, s)], f"{what}: {n} {s}")
        lat.append((time.perf_counter() - t0) * 1e3)
        if cached is not None and out["cached"] is not cached:
            raise AssertionError(f"{what}: {n} {s} cached={out['cached']}, want {cached}")
    return lat


def http_check(out: dict, want, what: str) -> dict:
    if not (all(type(i) is int for i in out["ids"])
            and np.array_equal(np.asarray(out["ids"], dtype=np.int64), want)):
        raise AssertionError(f"{what}: {len(out['ids'])} ids over HTTP, scalar {want.size}")
    return out


def ms_summary(lat: list[float]) -> dict:
    return {"p50_ms": float(np.percentile(lat, 50)), "max_ms": max(lat), "latency_ms": lat}


def subproc_pids(marker: str) -> list[int]:
    """Pids of this host's processes whose command line holds ``marker``."""
    pids = []
    for entry in Path("/proc").iterdir():
        if entry.name.isdigit():
            try:
                cmd = (entry / "cmdline").read_bytes().replace(b"\0", b" ").decode()
            except OSError:
                continue
            if marker in cmd:
                pids.append(int(entry.name))
    return pids


def stop_gateway(proc, marker: str) -> None:
    """Stop a gateway child as an operator would (SIGINT: it closes its
    service and with it its shard processes) and check that none of them
    outlives it; stragglers are killed and reported."""
    import signal

    proc.send_signal(signal.SIGINT)
    try:
        proc.wait(60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(10)
    left = []
    for _ in range(60):
        left = subproc_pids(marker)
        if not left:
            return
        time.sleep(0.5)
    for pid in left:
        os.kill(pid, signal.SIGKILL)
    raise AssertionError(f"shard processes {left} outlived their gateway")


def distinct_rounds(rounds) -> list[tuple[dict, str]]:
    """One ``(batch, semantics)`` of each distinct recorded fused call: the
    same semantics and the same input tensors, byte for byte."""
    import hashlib

    out = {}
    for _label, batch, sem in rounds:
        key = hashlib.sha256(sem.encode())
        for name in sorted(batch):
            t = batch[name].cpu()
            key.update(f"{name}{tuple(t.shape)}{t.dtype}".encode())
            key.update(t.numpy().tobytes())
        out.setdefault(key.digest(), (batch, sem))
    return list(out.values())


def shard_kernel_launches(client, name: str) -> list[int]:
    """Each shard's own launches of ``name``, from the gateway's load report."""
    heat = json.loads(client.get("/debug/heat"))
    return [int(row["kernel_launches"][name]) for row in heat["shards"]]


def gateway_phase(card: str, tree, want: dict, path: str) -> dict:
    """The cluster phase's 4 shards behind the HTTP gateway: fused in process
    (latency beside ``svc.query`` in turns, the edge cache, every route), a
    live split under traffic, chained over shard servers with a shard move,
    and fused behind a gateway child.  Every answer equals ``scalar``.
    Returns, per kernel, this phase's counted launches (and, for fused_search,
    every recorded call held against the plain version)."""
    import threading

    import torch

    from repro_torch.cluster import (
        ClusterService, move_shard, plan_rebalance, repartition_publish,
    )
    from repro_torch.cluster.workers.server import launch_cluster_servers
    from repro_torch.gateway import Gateway, launch_gateway

    t_phase = time.perf_counter()
    queries = cluster_queries()
    light = light_queries(queries)
    record = {"card": card, "shards": CLUSTER_SHARDS}
    out = {}
    fused = module("fused_search")
    # (a) and (b) repartition their copy, (c) moves a shard of its own copy;
    # (d) serves the cluster phase's layout as it was built
    path_ab, path_c = path + "-ab", path + "-c"
    shutil.copytree(path, path_ab)
    shutil.copytree(path, path_c)
    try:
        # ---- (a) fused, in process ------------------------------------- #
        svc = ClusterService.from_dir(path_ab, transport="thread", backends="fused",
                                      device=DEVICE)
        gw = traffic_gw = None
        try:
            gw = Gateway(svc).start()
            client = HttpClient(gw.endpoint)
            for _n, w, s in light:  # warm each shard's drain (not the edge cache)
                svc.query(list(w), s)
            torch.cuda.synchronize()
            fused.LAUNCHES = 0
            # HTTP on every query; svc.query beside it on the light ones (the
            # heavy ones' host loops would only repeat what HTTP runs)
            lat = {"http": [], "direct": [], "http_light": []}
            with Recorder() as rec:
                for i, (n, w, s) in enumerate(queries):
                    hows = ("http", "direct") if i % 2 == 0 else ("direct", "http")
                    for how in (hows if n not in CLUSTER_HEAVY else ("http",)):
                        rec.label = how
                        t0 = time.perf_counter()
                        if how == "http":
                            res = client.query(w, s)
                            ms = (time.perf_counter() - t0) * 1e3
                            http_check(res, want[(n, s)], f"gateway fused {n} {s}")
                            if res["cached"]:
                                raise AssertionError(f"gateway fused: {n} {s} was cached")
                        else:
                            ids = svc.query(list(w), s)
                            ms = (time.perf_counter() - t0) * 1e3
                            if not np.array_equal(ids, want[(n, s)]):
                                raise AssertionError(f"gateway fused svc.query: {n} {s}")
                        lat[how].append(ms)
                        if how == "http" and n not in CLUSTER_HEAVY:
                            lat["http_light"].append(ms)
            torch.cuda.synchronize()
            launches = fused.LAUNCHES
            http_calls = [r for r in rec.rounds if r[0] == "http"]
            if launches != len(rec.rounds) or not http_calls:
                raise AssertionError(
                    f"gateway fused: {launches} fused_search launches, {len(rec.rounds)} "
                    f"calls recorded, {len(http_calls)} of them for HTTP requests")
            errs = [fused_vs_plain(b, sem)[0] for _l, b, sem in rec.rounds]
            hits = http_pass(client, queries, want, "gateway fused, second pass", True)
            routes = {}
            for route in GATEWAY_ROUTES:
                t0 = time.perf_counter()
                raw = client.get(route)
                routes[route] = {"ms": (time.perf_counter() - t0) * 1e3, "bytes": len(raw)}
            heat = json.loads(client.get("/debug/heat"))
            if "proposal" not in heat or "proposal_error" in heat:
                raise AssertionError(f"/debug/heat without a proposal: {sorted(heat)}")
            cache = gw.cache.snapshot()
            # the HTTP hop: each light request against the svc.query beside it
            hop = float(np.median(np.subtract(lat["http_light"], lat["direct"])))
            record["fused_in_process"] = {
                "http": ms_summary(lat["http"]), "http_light": ms_summary(lat["http_light"]),
                "direct": ms_summary(lat["direct"]), "http_minus_direct_median_ms": hop,
                "cache_hits": ms_summary(hits), "cache": cache, "routes": routes,
                "launches": launches, "http_calls": len(http_calls),
                "max_abs_err": max(errs),
            }
            out["fused_search"] = {
                "gateway_launches": launches, "gateway_http_calls": len(http_calls),
                "gateway_max_abs_err": max(errs),
            }
            print(
                f"gateway fused, in process: {len(queries)} queries over HTTP equal scalar; "
                f"per-query ms p50 {np.percentile(lat['http'], 50):.3f} max "
                f"{max(lat['http']):.3f}; the {len(lat['http_light'])} light ones p50 "
                f"{np.percentile(lat['http_light'], 50):.3f} max {max(lat['http_light']):.3f} "
                f"(svc.query in turns on those: p50 "
                f"{np.percentile(lat['direct'], 50):.3f} max {max(lat['direct']):.3f}; "
                f"HTTP minus svc.query, per query, median {hop:.3f}); second pass all cached, a hit p50 {np.percentile(hits, 50):.3f} ms max "
                f"{max(hits):.3f}; fused_search launches {launches} "
                f"({len(http_calls)} for HTTP requests), each == plain (max abs err "
                f"{max(errs)}); " + ", ".join(
                    f"{r} {v['ms']:.1f} ms" for r, v in routes.items()))

            # ---- (b) a live split under traffic ------------------------- #
            # the traffic goes through a second gateway whose 1-entry cache
            # misses on every request, so every request reaches the shards
            traffic_gw = Gateway(svc, cache_entries=1).start()
            stop = threading.Event()
            seen = {"requests": 0, "errors": [], "layouts": {}}

            def traffic() -> None:
                tc = HttpClient(traffic_gw.endpoint)
                try:
                    i = 0
                    while not stop.is_set():
                        n, w, s = light[i % len(light)]
                        try:
                            res = http_check(tc.query(w, s), want[(n, s)], f"traffic {n} {s}")
                            k = len(res["generations"])
                            seen["layouts"][k] = seen["layouts"].get(k, 0) + 1
                        except Exception as e:  # counted; the phase fails below
                            seen["errors"].append(f"{type(e).__name__}: {e}")
                        seen["requests"] += 1
                        i += 1
                finally:
                    tc.close()

            timed = {}
            apply_layout = svc.apply_layout

            def timed_apply(*args, **kwargs):
                t0 = time.perf_counter()
                apply_layout(*args, **kwargs)
                timed["converge_s"] = time.perf_counter() - t0

            svc.apply_layout = timed_apply
            # every fused_search call from here to the end of the pass after
            # the split (the traffic on both layouts, the publish, the pass)
            # is recorded and counted
            torch.cuda.synchronize()
            fused.LAUNCHES = 0
            with Recorder() as split_rec:
                split_rec.label = "traffic"
                th = threading.Thread(target=traffic, name="gateway-traffic")
                th.start()
                try:
                    while seen["requests"] < 2 * len(light) and th.is_alive():
                        time.sleep(0.01)
                    report = svc.load_report()
                    # shard 0 hot, as tests/test_rebalance.py skews it; the
                    # others' 10 keeps the planner from also merging a cold pair
                    for row in report["shards"]:
                        row["qps"] = 50.0 if row["shard"] == 0 else 10.0
                    plan, actions = plan_rebalance(report)
                    if [a.kind for a in actions] != ["split"] or plan.num_shards != 5:
                        raise AssertionError(
                            f"the planner proposed {[a.to_json() for a in actions]}")
                    before = seen["requests"]
                    t0 = time.perf_counter()
                    manifest = repartition_publish(path_ab, tree, plan, service=svc,
                                                   device=DEVICE)
                    publish_s = time.perf_counter() - t0
                    during = seen["requests"] - before
                    while seen["layouts"].get(5, 0) < len(light) and th.is_alive():
                        time.sleep(0.01)
                finally:
                    stop.set()
                    th.join(120)
                if th.is_alive() or seen["errors"] or not seen["layouts"].get(5):
                    raise AssertionError(
                        f"traffic across the split: alive {th.is_alive()}, errors "
                        f"{seen['errors'][:5]}, answers per shard count {seen['layouts']}")
                health = json.loads(client.get("/healthz"))
                if (health["layout_epoch"], health["shards"]) != (1, 5):
                    raise AssertionError(f"/healthz after the split: {health}")
                split_rec.label = "after"
                after = http_pass(client, queries, want, "gateway after the split", False)
            torch.cuda.synchronize()
            split_launches = fused.LAUNCHES
            n_after = sum(r[0] == "after" for r in split_rec.rounds)
            if split_launches != len(split_rec.rounds) or not n_after:
                raise AssertionError(
                    f"gateway split: {split_launches} fused_search launches, "
                    f"{len(split_rec.rounds)} calls recorded, {n_after} of them after it")
            # identical inputs give identical outputs: one replay of each
            # distinct call holds every call against the plain version
            distinct = distinct_rounds(split_rec.rounds)
            split_errs = [fused_vs_plain(b, sem)[0] for b, sem in distinct]
            del split_rec
            docs = [s["doc_hi"] - s["doc_lo"] for s in manifest["shards"]]
            record["split"] = {
                "actions": [a.to_json() for a in actions], "docs": docs,
                "publish_s": publish_s, "converge_s": timed["converge_s"],
                "traffic_requests": seen["requests"], "traffic_during_publish": during,
                "traffic_answers_per_shard_count": seen["layouts"],
                "after": ms_summary(after), "launches": split_launches,
                "launches_after": n_after, "distinct_calls": len(distinct),
                "max_abs_err": max(split_errs),
            }
            out["fused_search"].update(
                gateway_split_launches=split_launches,
                gateway_split_max_abs_err=max(split_errs))
            print(
                f"gateway split under traffic: 4 -> 5 shards (documents {docs}) in "
                f"{publish_s:.2f} s, of it converging the live service "
                f"{timed['converge_s']:.3f} s; {seen['requests']} traffic requests "
                f"({during} while the publish ran, answers by shard count "
                f"{seen['layouts']}), 0 errors; /healthz epoch 1, 5 shards; the "
                f"{len(queries)} queries after it all uncached and equal scalar (p50 "
                f"{np.percentile(after, 50):.3f} ms, max {max(after):.3f}); fused_search "
                f"launches from the traffic's start to the pass's end {split_launches} "
                f"({n_after} in the pass), each of the {len(distinct)} distinct calls == "
                f"plain (max abs err {max(split_errs)})")
            client.close()
        finally:
            for g in (gw, traffic_gw):
                if g is not None:
                    g.close()
            svc.close()

        # ---- (c) chained over shard servers, with a move ---------------- #
        procs, endpoints = launch_cluster_servers(path_c, backends="chained",
                                                  device=DEVICE)
        moved = None
        try:
            svc = ClusterService.from_dir(path_c, transport="remote", backends="chained",
                                          endpoints=endpoints, device=DEVICE)
            with Gateway(svc, own_service=True).start() as gw:
                client = HttpClient(gw.endpoint)
                first = http_pass(client, queries, want, "gateway chained remote", False)
                t0 = time.perf_counter()
                moved, endpoint, _m = move_shard(path_c, 0, service=svc, backend="chained",
                                                 device=DEVICE)
                move_s = time.perf_counter() - t0
                hits = http_pass(client, queries, want, "gateway chained after the move",
                                 True)
                gw.cache.clear()
                before = svc.workers[0].stats().data["kernel_launches_searchsorted"]
                again = http_pass(client, queries, want, "gateway chained, moved shard",
                                  False)
                moved_launches = (svc.workers[0].stats().data["kernel_launches_searchsorted"]
                                  - before)
                if svc.pool.locality[0] != "remote" or moved_launches <= 0:
                    raise AssertionError(
                        f"the moved shard's server launched {moved_launches} searchsorted")
                client.close()
            record["chained_remote_move"] = {
                "first": ms_summary(first), "cache_hits_after_move": ms_summary(hits),
                "after_move": ms_summary(again), "move_s": move_s,
                "moved_server_launches": moved_launches,
            }
            out["searchsorted"] = {"gateway_moved_server_launches": moved_launches}
            print(
                f"gateway chained over {CLUSTER_SHARDS} shard servers: {len(queries)} queries "
                f"equal scalar (p50 {np.percentile(first, 50):.3f} ms, max {max(first):.3f}); "
                f"shard 0 moved to a new server in {move_s:.2f} s; then all {len(queries)} "
                f"cached; after a cache clear all equal scalar again (p50 "
                f"{np.percentile(again, 50):.3f} ms) and the moved shard's server "
                f"launched searchsorted {moved_launches} times (its own count)")
        finally:
            stop_servers(procs + ([moved] if moved is not None else []))

        # ---- (d) fused behind a gateway child --------------------------- #
        t0 = time.perf_counter()
        proc, endpoint = launch_gateway(path, transport="process", backend="fused",
                                        device=DEVICE)
        start_s = time.perf_counter() - t0
        try:
            client = HttpClient(endpoint)
            before = shard_kernel_launches(client, "fused_search")
            lat = http_pass(client, queries, want, "gateway child, process", False)
            per_shard = [a - b for a, b in
                         zip(shard_kernel_launches(client, "fused_search"), before)]
            if min(per_shard) <= 0:
                raise AssertionError(f"a shard process launched no fused_search: {per_shard}")
            client.close()
        finally:
            stop_gateway(proc, os.path.basename(path))
        record["fused_child_process"] = {
            "start_s": start_s, **ms_summary(lat), "shard_launches": per_shard,
        }
        out["fused_search"]["gateway_process_shard_launches"] = per_shard
        print(
            f"gateway child over {CLUSTER_SHARDS} shard processes: announced in "
            f"{start_s:.2f} s; {len(queries)} queries equal scalar (p50 "
            f"{np.percentile(lat, 50):.3f} ms, max {max(lat):.3f}); fused_search "
            f"launches per shard process (its own count) {per_shard}; the child and "
            f"its shard processes stopped")
    finally:
        for p in (path_ab, path_c):
            shutil.rmtree(p, ignore_errors=True)
    record["wall_s"] = time.perf_counter() - t_phase
    OUT_DIR.mkdir(exist_ok=True)
    with open(OUT_DIR / "chip_smoke_gateway.json", "w") as f:
        json.dump(record, f, indent=1)
    print(f"gateway phase: {record['wall_s']:.1f} s")
    return out


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
    """``host_breakdown`` of one ``decode_attention`` call on these inputs;
    the whole call (the registered op) beside the direct launch."""
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
        {"whole_call_us": lambda: da.decode_attention(q, k, v, cache_len),
         "direct_launch_us": lambda: da._launch(q, k, v, cache_len)}))
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


# --------------------------------------------------------------------------- #
# LM training: the trainer at full width, the card against the CPU, the
# sharded step on ranks sharing the card
# --------------------------------------------------------------------------- #

TRAIN_ARCH = "smollm-135m"  # at its published widths (configs/smollm_135m.py)
TRAIN_BATCH, TRAIN_SEQ = 8, 1024
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 20, 10, 15
# Adam's first steps move every weight by about the rate: at 1e-3 and above
# the loss of each new batch rose over 20 steps on the card (PERF.md §6),
# at 1e-4 it holds and the loss of a batch already seen falls
TRAIN_LR, TRAIN_WARMUP = 1e-4, 2
# 4 gloo ranks share the card (NCCL refuses two ranks on one card).  Gloo's
# all-gather of CUDA tensors kills a rank (SIGSEGV; DTensor's and the
# functional one alike), so the port's step gathers through
# ``dist/local.py`` (an all-to-all there) and no DTensor op of the AdamW
# step all-gathers: mesh (2, 2), SmolLM's 9 heads over "model" 2 (the
# positions route), its checkpoint restored onto (1, 4), every leaf
# sharded over "model", each rank's pieces checked on the rank
TRAIN_RANKS, TRAIN_MESH, TRAIN_RESTORE_MESH = 4, (2, 2), (1, 4)
# the widths of the card-vs-CPU and the sharded checks: SmolLM's, 2 layers,
# float32, batch 2 x 128.  Adam divides each gradient by its own RMS, so on
# an element whose gradient is near zero (a token row far from the batch)
# the float32 noise of another summation order moves the step by a share of
# the learning rate: at 1e-4 that stays well inside the limit
TRAIN_SMALL = dict(batch=2, seq=128, lr=1e-4, warmup=0, steps=10, optimizer="adamw")
TRAIN_TOL = 1e-4  # each metric, and each leaf's max |difference| over its max |value|
TRAIN_SHARDED = dict(TRAIN_SMALL, batch=4)  # the 2 data ranks take 2 rows each


def train_small_cfg():
    from repro_torch.configs import get_config

    cfg = get_config(TRAIN_ARCH)
    return cfg.reduced(n_layers=2, d_model=cfg.d_model, n_heads=cfg.n_heads,
                       n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim, d_ff=cfg.d_ff,
                       vocab=cfg.vocab, dtype="float32")


def state_err(got: dict, want: dict) -> float:
    """The largest, over the leaves of two reference-layout trees of numpy
    arrays (the same paths), of a leaf's max |got - want| over its max
    |want| (0 for two leaves of zeros)."""
    from repro_torch.tree import flatten_with_names

    want_flat = dict(flatten_with_names(want))
    worst = 0.0
    for name, a in flatten_with_names(got):
        b = np.asarray(want_flat[name], np.float64)
        diff = float(np.abs(np.asarray(a, np.float64) - b).max(initial=0.0))
        worst = max(worst, diff / float(np.abs(b).max(initial=0.0)) if diff else 0.0)
    return worst


def metric_err(got: dict, want: dict) -> float:
    return max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-30) for k in want)


def small_steps(device: str, steps: int, mesh=None, init=None, train=TRAIN_SMALL):
    """``steps`` AdamW steps of the small config through the launcher's
    pieces (``train``: their arguments) on ``device`` (or a mesh), from the
    pieces' fresh state or from ``init`` (a reference-layout numpy state):
    the metrics, the state and the state as numpy."""
    from repro_torch.launch import train as launcher
    from repro_torch.models.convert import state_from_numpy, state_to_numpy

    cfg = train_small_cfg()
    run = launcher.pieces(cfg, **train, device=device, mesh=mesh)
    step = run.make_step()
    state = run.fresh_state() if init is None else state_from_numpy(init, cfg, device)
    metrics = []
    for s in range(steps):
        state, m = step(state, run.next_batch(s))
        metrics.append({k: launcher.value(v) for k, v in m.items()})
    return metrics, state, state_to_numpy(state)


def restore_err(restored, saved, mesh) -> float:
    """The largest |difference| between each restored DTensor's local piece
    and the same piece of the saved state, gathered whole and cut on this
    rank (``dist.local.full``: gloo's DTensor all-gather of CUDA tensors
    kills the rank)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.dist.local import full as whole
    from repro_torch.dist.sharding import tensor_tree
    from repro_torch.tree import flatten_with_names

    saved_flat = dict(flatten_with_names(tensor_tree(saved)))
    worst = 0.0
    for name, r in flatten_with_names(tensor_tree(restored)):
        full = whole(saved_flat[name]).detach()
        want = distribute_tensor(full, mesh, r.placements, src_data_rank=None).to_local()
        worst = max(worst, float((r.to_local().double() - want.double()).abs().max()))
    return worst


def train_rank_runs(plan: dict) -> dict:
    """A rank of the sharded check: two steps on ``plan["mesh"]`` held
    against the single-device state in ``plan["want"]``, a checkpoint, and
    its elastic restore onto ``plan["restore_mesh"]`` held against the state
    saved."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.dist import sharding as shd
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.tree import unflatten_names

    world = dist.get_world_size()
    dev_type = plan["device_type"]
    if dev_type == "cuda":
        torch.cuda.set_device(0)
    mesh = DeviceMesh(dev_type, torch.arange(world).reshape(plan["mesh"]),
                      mesh_dim_names=("data", "model"))
    t0 = time.perf_counter()
    metrics, state, got = small_steps(dev_type, 2, mesh, train=TRAIN_SHARDED)
    t_steps = time.perf_counter() - t0
    with np.load(plan["want"]) as f:
        want = unflatten_names({k: f[k] for k in f.files})
    placed = {n: [str(p) for p in t.placements] for n, t in state["params"].named_parameters()}
    ckpt.save_checkpoint(plan["ckpt"], 2, state, extra={"next_step": 2})
    mesh2 = DeviceMesh(dev_type, torch.arange(world).reshape(plan["restore_mesh"]),
                       mesh_dim_names=("data", "model"))
    restored, _ = ckpt.restore_checkpoint(plan["ckpt"], state,
                                          shardings=shd.param_specs(state, mesh2), mesh=mesh2)
    want_placed = shd.param_specs(restored, mesh2)["params"]
    wrong = [n for n, p in restored["params"].named_parameters()
             if tuple(p.placements) != want_placed[n]]
    return {"metrics": metrics, "state_err": state_err(got, want),
            "restore_err": restore_err(restored, state, mesh2), "misplaced": wrong,
            "placed": placed, "steps_s": t_steps,
            "restored_placed": {n: [str(p) for p in t.placements]
                                for n, t in restored["params"].named_parameters()}}


def train_phase(card: str) -> dict:
    """SmolLM-135M training on the card (module docstring, phase 12)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import train as launcher
    from repro_torch.models import lm_loss
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.fault import run_supervised
    from repro_torch.train.optimizer import pick_optimizer
    from repro_torch.tree import flatten_with_names

    record = {"card": card}
    # ---- (a) the trainer at full width ------------------------------- #
    cfg = get_config(TRAIN_ARCH)
    n_params = cfg.param_count()
    opt = pick_optimizer(cfg)
    run = launcher.pieces(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=0, lr=TRAIN_LR,
                          warmup=TRAIN_WARMUP, steps=TRAIN_STEPS, optimizer=opt,
                          device=DEVICE)
    step_ms: dict[int, list[float]] = {}
    losses: dict[int, list[float]] = {}
    io_s = {"save": [], "restore": []}
    left = {"failures": 1}
    last = {}
    seen = run.next_batch(0)  # the first batch, scored again after training

    def seen_loss(state) -> float:
        with torch.no_grad():
            return float(lm_loss(state["params"], cfg, seen))

    def make_step():
        inner = run.make_step()

        def step(state, batch):
            s = int(state["step"])
            if left["failures"] and s == TRAIN_FAIL_AT:
                left["failures"] -= 1
                raise RuntimeError(f"injected failure before step {s}")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = inner(state, batch)
            torch.cuda.synchronize()
            step_ms.setdefault(s, []).append((time.perf_counter() - t0) * 1e3)
            last["state"] = state
            return state, metrics

        return step

    def timed(kind, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            io_s[kind].append(time.perf_counter() - t0)
            return out
        return call

    ckpt_dir = tempfile.mkdtemp(prefix="chip-smoke-train-")
    saved = (ckpt.save_checkpoint, ckpt.restore_checkpoint)
    ckpt.save_checkpoint = timed("save", saved[0])
    ckpt.restore_checkpoint = timed("restore", saved[1])
    torch.use_deterministic_algorithms(True)  # a replayed step must equal its first pass
    seen_before = seen_loss(run.fresh_state())
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        report = run_supervised(
            total_steps=TRAIN_STEPS, make_step=make_step, init_state=run.fresh_state,
            next_batch=run.next_batch, ckpt_dir=ckpt_dir, checkpoint_every=TRAIN_CKPT_EVERY,
            on_metrics=lambda s, m: losses.setdefault(s, []).append(float(m["loss"])))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        state = last.pop("state")
        seen_after = seen_loss(state)
        # where a step's time goes: one more step, profiled
        prof_step, prof_batch = run.make_step(), run.next_batch(TRAIN_STEPS)
        prof_wall, prof_dev, _ = profile_pass(lambda: prof_step(state, prof_batch))
        del state
    finally:
        ckpt.save_checkpoint, ckpt.restore_checkpoint = saved
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    replayed = sorted(s for s, v in losses.items() if len(v) > 1)
    if (report.failures_recovered != 1 or report.restarts != [TRAIN_FAIL_AT]
            or report.final_step != TRAIN_STEPS
            or replayed != list(range(TRAIN_CKPT_EVERY, TRAIN_FAIL_AT))):
        raise AssertionError(f"train: supervisor report {report}, replayed steps {replayed}")
    replay_diff = max(abs(losses[s][0] - losses[s][1]) for s in replayed)
    if replay_diff != 0.0:
        raise AssertionError(f"train: replayed losses differ by up to {replay_diff} "
                             f"(deterministic algorithms on): {losses}")
    first, final = losses[0][0], losses[TRAIN_STEPS - 1][-1]
    if not all(np.isfinite(v).all() for v in losses.values()) or not final < first:
        raise AssertionError(f"train: the loss did not fall: {first} -> {final}")
    if not seen_after < seen_before:
        raise AssertionError(f"train: step 0's batch scores {seen_before} -> {seen_after}")
    # step 0 carries the first call's setup; the rest (first pass and replay)
    ms = [t for s, ts in step_ms.items() if s > 0 for t in ts]
    med_ms = float(np.median(ms))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    share = 6.0 * n_params * tokens / (med_ms / 1e3) / HW["peak_flops"]
    record["trainer"] = {
        "arch": cfg.name, "params": n_params, "optimizer": opt, "batch": TRAIN_BATCH,
        "seq": TRAIN_SEQ, "steps": TRAIN_STEPS, "lr": TRAIN_LR, "warmup": TRAIN_WARMUP,
        "median_step_ms": med_ms, "step_ms": {str(k): v for k, v in sorted(step_ms.items())},
        "tokens_per_s": tokens / (med_ms / 1e3), "peak_flops_share": share,
        "peak_memory_bytes": peak, "save_s": io_s["save"], "restore_s": io_s["restore"],
        "losses": {str(k): v for k, v in sorted(losses.items())},
        "first_batch_loss_before": seen_before, "first_batch_loss_after": seen_after,
        "profiled_step": {"wall_ms": prof_wall, "device_busy_ms": sum(prof_dev.values()),
                          "top_device_ops": sorted(prof_dev.items(), key=lambda kv: -kv[1])[:12]},
        "restarts": report.restarts, "steps_run": report.steps_run, "wall_s": wall,
        "deterministic": True,
    }
    print(
        f"train (a): {cfg.name} at its published widths ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, vocab "
        f"{cfg.vocab}, {cfg.dtype}, {n_params} parameters), {opt}, batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ}, {TRAIN_STEPS} steps (lr {TRAIN_LR}, warmup {TRAIN_WARMUP}) through "
        f"launch/train.py's pieces and run_supervised, deterministic algorithms on: median "
        f"step {med_ms:.2f} ms (device synchronised, steps 1-19 and the replay), "
        f"{tokens / (med_ms / 1e3):.0f} tokens/s, 6*N*tokens/step = {100 * share:.2f}% of "
        f"the bf16 peak ({HW['peak_flops'] / 1e12:.0f} TFLOP/s); peak device memory "
        f"{peak / 2**30:.2f} GiB; checkpoint save s {[round(x, 2) for x in io_s['save']]}, "
        f"restore s {[round(x, 2) for x in io_s['restore']]}; loss {first:.4f} -> "
        f"{final:.4f} (step 0's batch scored again: {seen_before:.4f} -> "
        f"{seen_after:.4f}); failure injected before step {TRAIN_FAIL_AT}, "
        f"{report.failures_recovered} recovered from step {TRAIN_CKPT_EVERY}, steps "
        f"{replayed[0]}-{replayed[-1]} replayed with equal losses; {card}")
    busy = sum(prof_dev.values())
    top = sorted(prof_dev.items(), key=lambda kv: -kv[1])[:6]
    print(f"train (a) profiled step: wall {prof_wall:.1f} ms, device busy {busy:.1f} ms (idle "
          f"share {1 - busy / prof_wall:.4f}); top device ops: "
          + "; ".join(f"{op[:60]} {ms:.2f} ms" for op, ms in top) if prof_dev else
          "train (a) profiled step: device time not measured (no device events)")

    # ---- (b) one step on the card against the CPU --------------------- #
    # one seeded state, made on the CPU and carried to both devices (the
    # card's and the CPU's generators draw other numbers from one seed)
    from repro_torch.launch.train import pieces
    from repro_torch.models.convert import state_to_numpy

    init = state_to_numpy(pieces(train_small_cfg(), **TRAIN_SMALL, device="cpu").fresh_state())
    m_card, _s, card_state = small_steps(DEVICE, 1, init=init)
    m_cpu, _s, cpu_state = small_steps("cpu", 1, init=init)
    del _s, init
    b_metric, b_state = metric_err(m_card[0], m_cpu[0]), state_err(card_state, cpu_state)
    if b_metric > TRAIN_TOL or b_state > TRAIN_TOL:
        raise AssertionError(f"train (b): card vs CPU metrics {b_metric}, state {b_state}")
    record["card_vs_cpu"] = {"metrics_card": m_card, "metrics_cpu": m_cpu,
                             "metric_err": b_metric, "state_err": b_state}
    print(f"train (b): one AdamW step at SmolLM's widths cut to 2 layers (float32, batch "
          f"{TRAIN_SMALL['batch']} x {TRAIN_SMALL['seq']}) on the card against the CPU from "
          f"the same seeded state: loss {m_card[0]['loss']:.6f} vs {m_cpu[0]['loss']:.6f}, "
          f"worst metric {b_metric:.3g}, worst parameter/moment leaf {b_state:.3g} (limit "
          f"{TRAIN_TOL}, relative to each leaf's largest value)")

    # ---- (c) the sharded step on ranks sharing the card --------------- #
    want_metrics, _s, want = small_steps(DEVICE, 2, train=TRAIN_SHARDED)
    del _s
    work = tempfile.mkdtemp(prefix="chip-smoke-train-dist-")
    try:
        np.savez(Path(work) / "want.npz", **dict(flatten_with_names(want)))
        plan = {"mesh": TRAIN_MESH, "restore_mesh": TRAIN_RESTORE_MESH,
                "device_type": DEVICE, "want": str(Path(work) / "want.npz"),
                "ckpt": str(Path(work) / "ckpt")}
        t0 = time.perf_counter()
        ranks = run_dist_ranks(TRAIN_RANKS, "gloo", plan, train_rank_runs)
        t_ranks = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for r, res in enumerate(ranks):
        errs = [metric_err(g, w) for g, w in zip(res["metrics"], want_metrics)]
        if max(errs) > TRAIN_TOL or res["state_err"] > TRAIN_TOL:
            raise AssertionError(f"train (c) rank {r}: metrics {errs}, state {res['state_err']}")
        if res["restore_err"] != 0.0 or res["misplaced"]:
            raise AssertionError(f"train (c) rank {r}: restore err {res['restore_err']}, "
                                 f"misplaced {res['misplaced']}")
    record["sharded"] = {"mesh": TRAIN_MESH, "restore_mesh": TRAIN_RESTORE_MESH,
                         "ranks": ranks, "want_metrics": want_metrics, "wall_s": t_ranks}
    print(f"train (c): {TRAIN_RANKS} gloo ranks sharing the card, mesh {TRAIN_MESH} "
          f"(data, model), 2 AdamW steps on DTensors at (b)'s widths, batch "
          f"{TRAIN_SHARDED['batch']} x {TRAIN_SHARDED['seq']}: loss "
          f"{ranks[0]['metrics'][-1]['loss']:.6f} vs one device "
          f"{want_metrics[-1]['loss']:.6f}, worst state err "
          f"{max(r['state_err'] for r in ranks):.3g} (limit {TRAIN_TOL}); embed.table "
          f"{ranks[0]['placed']['embed.table']}; its checkpoint restored onto mesh "
          f"{TRAIN_RESTORE_MESH} (embed.table "
          f"{ranks[0]['restored_placed']['embed.table']}, wq "
          f"{ranks[0]['restored_placed']['blocks.0.mixer.wq']}) equal to the state "
          f"saved on every rank; {t_ranks:.1f} s")
    OUT_DIR.mkdir(exist_ok=True)
    with open(OUT_DIR / "chip_smoke_train.json", "w") as f:
        json.dump(record, f, indent=1)
    return record


# --------------------------------------------------------------------------- #
# The MoE, MLA, Mamba and RWKV-6 blocks: DeepSeek-V2-Lite-16B whole,
# rwkv6-1.6b, llama4 cut to its period; full-width layers and the reduced
# archs on the card against the CPU
# --------------------------------------------------------------------------- #

BLOCKS_ARCHS = {  # (a), (c), (d): arch -> layers kept (None: all)
    "deepseek-v2-lite-16b": None,
    "rwkv6-1.6b": None,
    "llama4-maverick-400b-a17b": 2,  # its dense + MoE period (PERF.md §4)
}
BLOCKS_PREFIX_DAG = ("deepseek-v2-lite-16b",)  # also served with --prefix-dag
# requests in the decode-vs-prefill check (MoE archs without drops, C = Tg):
# 2 for DeepSeek (its float32 copy, 62.8 GB, must take the same prefill
# beside its own weights) and llama4 (at 8, [128, 8,696, 8,192] bf16 expert
# tensors of 18 GB each would not fit beside its 37.4 GB); all 8 for rwkv6
BLOCKS_CHECK_REQUESTS = {"deepseek-v2-lite-16b": 2, "llama4-maverick-400b-a17b": 2}
# archs whose float32 copy fits the card: its prefill sets the bf16 check's
# gate, and its own decode-vs-prefill check runs at the float32 gate
# (llama4's 74.7 GB in float32 would not fit)
BLOCKS_FLOAT32 = ("deepseek-v2-lite-16b", "rwkv6-1.6b")
BLOCKS_LAYER_TOKENS = 512  # (b): one MLA and one MoE layer at (a)'s widths
BLOCKS_TOL = 1e-4  # (b), (e): of each output's / leaf's largest value
BLOCKS_NOISE = 1e-8  # (e): a top-1 router's moments, float noise on both devices
# (e): each arch's first N layers at reduced widths, their kinds kept
# (reduced() alone resets layer_pattern, which makes MoE and MLA archs GQA):
# deepseek (mla, swiglu) + (mla, moe); llama4 (gqa, swiglu) + (gqa, moe);
# jamba its 8-layer period (mamba, moe, swiglu, one gqa); rwkv6 two layers
BLOCKS_REDUCED = {"deepseek-v2-lite-16b": 2, "llama4-maverick-400b-a17b": 2,
                  "jamba-1.5-large-398b": 8, "rwkv6-1.6b": 2}


def no_drops(cfg):
    """``cfg`` with capacity_factor E/k: every expert takes every token (C >=
    Tg), so a decode step routes as a prefill does (ROADMAP §3)."""
    import dataclasses

    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))


def blocks_cfg(arch: str):
    """(a), (c), (d): the arch at its published widths, depth cut as
    ``BLOCKS_ARCHS`` says (whole scan units of its pattern)."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    layers = BLOCKS_ARCHS[arch]
    if layers is None:
        return cfg
    return dataclasses.replace(cfg, n_layers=layers, layer_pattern=cfg.layer_pattern[:layers])


class RouteRecorder:
    """Keeps each MoE layer's expert choices: inside ``with RouteRecorder()
    as rec`` every call of ``models.moe._route`` appends the top-k expert ids
    of each token, in ascending order, as a CPU tensor [G*Tg, k] (the
    router's softmax recomputed on the same inputs, then the same stable
    sort)."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        import torch

        from repro_torch.models import moe

        self._orig = moe._route

        def wrapped(params, xg, m, capacity):
            probs = torch.softmax(torch.einsum("gtd,de->gte", xg.float(), params.router.float()),
                                  dim=-1)
            top = torch.sort(probs, dim=-1, descending=True, stable=True)[1][..., :m.top_k]
            self.calls.append(top.reshape(-1, m.top_k).sort(dim=-1).values.cpu())
            return self._orig(params, xg, m, capacity)

        moe._route = wrapped
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe._route = self._orig


def measure_decode(model, cfg, prompts) -> dict:
    """The last decode step's logits against a prefill over the same tokens,
    for an MoE arch where no token is dropped (served again with
    capacity_factor E/k: a decode step's capacity differs from a
    prefill's, ROADMAP §3), each MoE layer's expert choices at the last
    step against the prefill's at the same position.  Measures and prints;
    the callers gate.  ``rec["seq"]``, ``["got"]`` and ``["want"]`` are the
    tokens and the two logits (popped by the callers)."""
    import torch

    from repro_torch.launch import serve as launcher
    from repro_torch.models import init_cache, prefill

    check_cfg = no_drops(cfg)
    n_moe = sum(f == "moe" for _m, f in cfg.layer_pattern)
    n = len(prompts)
    with RouteRecorder() as routes:
        out = launcher.serve(model, check_cfg, prompts, LM_GEN)
        last_step = routes.calls[len(routes.calls) - n_moe:]
        routes.calls.clear()
        seq = torch.cat([torch.as_tensor(np.stack(prompts), device=DEVICE),
                         out["tokens"][:, :-1]], dim=1)
        want, _ = prefill(model, check_cfg, seq, init_cache(check_cfg, n, seq.shape[1], DEVICE))
        at_last = [c.reshape(n, seq.shape[1], -1)[:, -1] for c in routes.calls]
    got = out["logits"]
    if got.shape != want.shape or not torch.isfinite(got.float()).all():
        raise AssertionError(f"decode vs prefill ({cfg.dtype}): logits {tuple(got.shape)} "
                             f"not finite")
    flips = torch.stack([(a != b).any(dim=-1) for a, b in zip(last_step, at_last)]
                        ) if n_moe else torch.zeros((0, n), dtype=torch.bool)
    err = (got.float() - want.float()).abs()
    rms = float(want.float().square().mean().sqrt())
    rec = {"requests": n, "capacity_factor": check_cfg.moe.capacity_factor if cfg.moe else None,
           "max_abs_err": float(err.max()), "logits_rms": rms,
           "flips_per_layer": flips.sum(dim=1).tolist(),
           "rows_flipped": torch.nonzero(flips.any(dim=0)).flatten().tolist(),
           "argmax_equal": int((got.argmax(-1) == want.argmax(-1)).sum()),
           "over_elementwise_tol": int((err > DECODE_TOL + DECODE_TOL * want.float().abs()).sum()),
           "seq": seq, "got": got, "want": want}
    print(f"decode vs prefill ({cfg.dtype}, {n} requests"
          + (f", capacity_factor {rec['capacity_factor']:.4g}: no drops" if cfg.moe else "")
          + f"): max abs err {rec['max_abs_err']:.4f}, logits RMS {rms:.3f} "
          f"({rec['max_abs_err'] / rms:.3f} x RMS), {rec['over_elementwise_tol']} of "
          f"{want.numel()} logits over {DECODE_TOL} abs + rel, argmax equal on "
          f"{rec['argmax_equal']} of {n} rows"
          + (f"; expert choices at the last step differ from the prefill's on rows "
             f"{rec['rows_flipped']} (flips per MoE layer {rec['flips_per_layer']})"
             if n_moe else ""))
    return rec


def serve_full_width(arch: str, rec: DecodeRecorder) -> dict:
    """One arch at its published widths, bf16, seeded weights: served through
    ``launch.serve`` (8 x 1,024 + 64, plain and, for BLOCKS_PREFIX_DAG, with
    the prefix DAG), decode_attention's launches counted from 0 over each
    run; then the decode-vs-prefill check (``measure_decode``) and its
    gate, for BLOCKS_FLOAT32 with a float32 copy of the model."""
    import dataclasses

    import torch

    from repro_torch.launch import serve as launcher
    from repro_torch.models import init_cache, init_params, prefill

    da = module("decode_attention")
    cfg = blocks_cfg(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_params(0, cfg, DEVICE)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    weights = torch.cuda.max_memory_allocated()
    if n_params != cfg.param_count():
        raise AssertionError(f"blocks {arch}: {n_params} parameters, config says "
                             f"{cfg.param_count()}")
    kinds = sorted({k for pair in cfg.layer_pattern for k in pair})
    print(f"blocks {arch}: {cfg.n_layers} layers {kinds}, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, vocab {cfg.vocab}, "
          f"{cfg.dtype}: {n_params} parameters from seed 0 in {t_init:.2f} s, "
          f"{weights / 2**30:.2f} GiB on the card")
    prompts = launcher.make_prompts(cfg.vocab, LM_REQUESTS, LM_PROMPT, LM_SHARED, seed=0)
    launcher.serve(model, cfg, [p[:64] for p in prompts[:2]], gen=4)  # warm
    steps = LM_GEN - 1
    want_launches = sum(m == "gqa" for m, _f in cfg.layer_pattern) * steps
    runs, plain = {}, None
    for mode in ("plain", "prefix-dag") if arch in BLOCKS_PREFIX_DAG else ("plain",):
        rec.label = f"{arch} {mode}"
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        da.LAUNCHES = 0
        out = launcher.serve(model, cfg, prompts, LM_GEN, prefix_dag=mode == "prefix-dag")
        torch.cuda.synchronize()
        launches = da.LAUNCHES
        peak = torch.cuda.max_memory_allocated()
        if launches != want_launches:
            raise AssertionError(f"blocks {arch} {mode}: {launches} decode_attention launches, "
                                 f"want {want_launches} (GQA layers x {steps} steps)")
        logits, toks = out["logits"], out["tokens"]
        if logits.shape != (LM_REQUESTS, cfg.vocab) or not torch.isfinite(logits.float()).all():
            raise AssertionError(f"blocks {arch} {mode}: logits {tuple(logits.shape)} not finite")
        if toks.shape != (LM_REQUESTS, LM_GEN) or not ((toks >= 0) & (toks < cfg.vocab)).all():
            raise AssertionError(f"blocks {arch} {mode}: tokens {tuple(toks.shape)} out of range")
        tok_s = steps * LM_REQUESTS / out["t_decode"]
        runs[mode] = {"t_prefill": out["t_prefill"], "t_decode": out["t_decode"],
                      "tok_s": tok_s, "launches": launches, "peak_memory_bytes": peak,
                      "savings": out["savings"]}
        print(f"blocks {arch} {mode}: {LM_REQUESTS} requests x {LM_PROMPT} prompt tokens "
              f"({LM_SHARED} shared) + {LM_GEN} generated; prefill "
              f"{out['t_prefill'] * 1e3:.2f} ms, decode {steps} steps in "
              f"{out['t_decode'] * 1e3:.2f} ms = {tok_s:.1f} tok/s; peak device memory "
              f"{peak / 2**30:.2f} GiB; decode_attention launches {launches}"
              + ("" if out["savings"] is None else
                 f"; plan savings {100 * out['savings']:.1f}% of prefill tokens"))
        plain = out if mode == "plain" else plain
    rec.label = ""
    del plain, out
    # decode vs prefill (measure_decode), then the gate.  Where a float32
    # copy fits: each bf16 result carries bf16 rounding of about s, the bf16
    # prefill's distance from the copy's prefill on the same tokens, so by
    # the triangle inequality decode and prefill differ by at most 2 s when
    # the decode step is as accurate as the prefill (in bf16 near-tied
    # experts flip between the two, and rounding grows over 24-27 layers
    # past 0.15 x the RMS); the copy's own check holds at the float32 gate.
    # Elsewhere the bf16 gate (0.15 x the RMS) on every row whose experts
    # did not flip.
    n = BLOCKS_CHECK_REQUESTS.get(arch, LM_REQUESTS)
    t0 = time.perf_counter()
    agree = measure_decode(model, cfg, prompts[:n])
    seq, got, want = agree.pop("seq"), agree.pop("got"), agree.pop("want")
    record = {"arch": arch, "layers": cfg.n_layers, "params": n_params, "weights_bytes": weights,
              "init_s": t_init, "runs": runs, "decode_vs_prefill": agree}
    if arch in BLOCKS_FLOAT32:
        del model
        torch.cuda.empty_cache()
        cfg32 = no_drops(dataclasses.replace(cfg, dtype="float32"))
        model32 = init_params(0, cfg32, DEVICE)  # the same seed: bf16's values unrounded
        want32, _ = prefill(model32, cfg32, seq, init_cache(cfg32, n, seq.shape[1], DEVICE))
        agree["bf16_rounding"] = float((want.float() - want32.float()).abs().max())
        agree["decode_vs_float32"] = float((got.float() - want32.float()).abs().max())
        agree["gate"] = 2 * agree["bf16_rounding"]
        print(f"blocks {arch}: the bf16 prefill against its float32 copy's on the same tokens: "
              f"max abs {agree['bf16_rounding']:.4f}, the bf16 decode step against it "
              f"{agree['decode_vs_float32']:.4f}; the bf16 gate 2 x {agree['bf16_rounding']:.4f}"
              f" ({DECODE_TOL} x RMS = {DECODE_TOL * agree['logits_rms']:.4f} "
              f"{'met' if agree['max_abs_err'] <= DECODE_TOL * agree['logits_rms'] else 'not met'})")
        if not agree["max_abs_err"] <= agree["gate"]:
            raise AssertionError(f"blocks {arch}: bf16 decode vs prefill beyond bf16 rounding: "
                                 f"{agree}")
        del seq, got, want, want32
        f32 = measure_decode(model32, cfg32, prompts[:n])
        for key in ("seq", "got", "want"):
            f32.pop(key)
        record["decode_vs_prefill_float32"] = f32
        if f32["over_elementwise_tol"] or f32["rows_flipped"]:
            raise AssertionError(f"blocks {arch}: float32 decode vs prefill: {f32}")
        del model32
    else:
        keep = torch.ones(n, dtype=torch.bool)
        keep[agree["rows_flipped"]] = False
        agree["gate"] = DECODE_TOL * float(want[keep].float().square().mean().sqrt()) if keep.any() \
            else None
        err = float((got[keep].float() - want[keep].float()).abs().max()) if keep.any() else None
        print(f"blocks {arch}: on the {int(keep.sum())} rows whose experts did not flip, max abs "
              f"err {err} (the bf16 gate, {DECODE_TOL} x their RMS: {agree['gate']})")
        if err is None or err > agree["gate"]:
            raise AssertionError(f"blocks {arch}: bf16 decode vs prefill: {agree}")
        del model, seq, got, want
    agree["seconds"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    return record


def full_width_layers() -> dict:
    """(b): one MLA and one MoE layer at DeepSeek-V2-Lite's widths, float32,
    from one seeded CPU model copied to the card, over BLOCKS_LAYER_TOKENS
    tokens: the router's choices equal (a flip is reported with its token)
    and each output within BLOCKS_TOL of its largest value."""
    import copy
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import attention, moe

    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b"), dtype="float32")
    m = cfg.moe
    gen = torch.Generator().manual_seed(0)
    mla = attention.MLA(cfg, torch.float32, "cpu")
    mla.reset_parameters(gen)
    ffn = moe.moe_init(gen, cfg, torch.float32, "cpu")
    b, s = 2, BLOCKS_LAYER_TOKENS // 2
    x = torch.randn((b, s, cfg.d_model), generator=gen)
    pos = torch.arange(s, dtype=torch.int32).expand(b, s)
    out = {}
    want, _ = attention.mla_apply(mla, x, cfg, pos)
    got, _ = attention.mla_apply(copy.deepcopy(mla).to(DEVICE), x.to(DEVICE), cfg, pos.to(DEVICE))
    out["mla_err"] = float((got.cpu() - want).abs().max()) / float(want.abs().max())
    # routing: the top-k margin of each token (CPU, float64) beside the choices
    xg = x.reshape(1, b * s, cfg.d_model)
    probs = torch.softmax(xg[0].double() @ ffn.router.double(), dim=-1)
    top = probs.sort(dim=-1, descending=True).values
    out["min_topk_margin"] = float((top[:, m.top_k - 1] - top[:, m.top_k]).min())
    cap = moe.capacity_of(b * s, m)
    ffn_card = copy.deepcopy(ffn).to(DEVICE)
    want_r = moe._route(ffn, xg, m, cap)
    got_r = moe._route(ffn_card, xg.to(DEVICE), m, cap)
    flips = {}
    for i, name in ((0, "take"), (1, "in_use"), (2, "slot"), (3, "inv"), (5, "stok")):
        where = torch.nonzero(got_r[i].cpu() != want_r[i]).tolist()
        if where:
            flips[name] = where[:16]
    out["route_flips"] = flips
    out["dropped"] = int((want_r[4] == 0).sum())
    out["capacity"] = cap
    want = moe.moe_apply(ffn, x, cfg)
    got = moe.moe_apply(ffn_card, x.to(DEVICE), cfg)
    out["moe_err"] = float((got.cpu() - want).abs().max()) / float(want.abs().max())
    print(f"blocks (b): one MLA and one MoE layer at DeepSeek-V2-Lite's widths (float32, "
          f"{b * s} tokens), card against CPU: MLA max err {out['mla_err']:.3g}, MoE max err "
          f"{out['moe_err']:.3g} of the largest output (limit {BLOCKS_TOL}); router choices "
          f"{'equal' if not flips else 'DIFFER: ' + json.dumps(flips)} (smallest top-{m.top_k} "
          f"margin {out['min_topk_margin']:.3g}, capacity {cap}, {out['dropped']} of "
          f"{b * s * m.top_k} entries dropped)")
    if flips or out["mla_err"] > BLOCKS_TOL or out["moe_err"] > BLOCKS_TOL:
        raise AssertionError(f"blocks (b): card vs CPU {out}")
    return out


def reduced_archs() -> dict:
    """(e): the four archs at BLOCKS_REDUCED sizes, float32, one seeded
    model: a forward, a prefill and 3 decode steps, and 2 AdamW steps, each
    on the card against the CPU (each output and leaf within BLOCKS_TOL of
    its largest value; a top-1 router's moments held to be noise)."""
    import copy

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, forward, init_cache, init_params, prefill
    from repro_torch.models.convert import state_from_numpy, state_to_numpy
    from repro_torch.train.train_step import make_train_step
    from repro_torch.tree import flatten_with_names

    def rel(a, b) -> float:
        a, b = a.detach().float().cpu(), b.detach().float().cpu()
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    out = {}
    for arch, n in BLOCKS_REDUCED.items():
        full = get_config(arch)
        cfg = full.reduced(dtype="float32", n_layers=n, scan_period=n,
                           layer_pattern=full.layer_pattern[:n])
        rng = np.random.default_rng(1)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 14)))
        cpu_model = init_params(0, cfg, "cpu")
        serving = {}
        for dev, model in (("cpu", cpu_model), (DEVICE, copy.deepcopy(cpu_model).to(DEVICE))):
            t = toks.to(dev)
            logits = [forward(model, cfg, tokens=t)[0]]
            cache = init_cache(cfg, 3, 14, dev)
            logits.append(prefill(model, cfg, t[:, :11], cache)[0])
            for i in range(11, 14):
                last, cache = decode_step(model, cfg, t[:, i:i + 1], cache, i)
                logits.append(last)
            serving[dev] = logits
        serve_err = max(rel(a, b) for a, b in zip(serving[DEVICE], serving["cpu"]))
        init_state, step = make_train_step(cfg, "adamw", base_lr=1e-4, warmup=1, total_steps=10)
        tree = state_to_numpy(init_state(cpu_model))
        batches = [rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32) for _ in range(2)]
        trained = {}
        for dev in ("cpu", DEVICE):
            state = state_from_numpy(tree, cfg, dev)
            for bt in batches:
                state, metrics = step(state, {"tokens": torch.as_tensor(bt, device=dev)})
            trained[dev] = ({k: float(v) for k, v in metrics.items()}, state_to_numpy(state))
        routers = (tuple(f"blocks/{u}/ffn/router" for u, (_m, f) in enumerate(cfg.scan_unit)
                         if f == "moe") if cfg.moe and cfg.moe.top_k == 1 else ())
        noise = tuple(f"{part}/{r}" for r in routers for part in ("m", "v"))
        (m_card, s_card), (m_cpu, s_cpu) = trained[DEVICE], trained["cpu"]
        metric = metric_err(m_card, m_cpu)
        worst, noise_max = 0.0, 0.0
        want_flat = dict(flatten_with_names(s_cpu))
        for name, a in flatten_with_names(s_card):
            b = np.asarray(want_flat[name], np.float64)
            a = np.asarray(a, np.float64)
            if name.endswith(noise):
                noise_max = max(noise_max, float(np.abs(a).max()), float(np.abs(b).max()))
                continue
            diff = float(np.abs(a - b).max(initial=0.0))
            worst = max(worst, diff / float(np.abs(b).max(initial=0.0)) if diff else 0.0)
        out[arch] = {"layers": cfg.n_layers, "pattern": [list(p) for p in cfg.scan_unit],
                     "serve_err": serve_err, "metric_err": metric, "state_err": worst,
                     "top1_router_moments_max": noise_max if noise else None,
                     "loss_card": m_card["loss"], "loss_cpu": m_cpu["loss"]}
        print(f"blocks (e) {arch} reduced with its kinds ({cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, float32), card against CPU: forward/prefill/decode max err "
              f"{serve_err:.3g}; 2 AdamW steps: metrics {metric:.3g}, worst parameter / moment "
              f"leaf {worst:.3g} (limit {BLOCKS_TOL})"
              + (f", top-1 router moments at most {noise_max:.3g} on either device (limit "
                 f"{BLOCKS_NOISE})" if noise else ""))
        if (serve_err > BLOCKS_TOL or metric > BLOCKS_TOL or worst > BLOCKS_TOL
                or noise_max >= BLOCKS_NOISE):
            raise AssertionError(f"blocks (e) {arch}: {out[arch]}")
    return out


def blocks_phase(card: str) -> dict:
    """The MoE, MLA, Mamba and RWKV-6 blocks (module docstring, phase 13);
    returns the decode_attention calls of the llama4 run, checked and timed."""
    import torch

    da = module("decode_attention")
    record = {"card": card}
    with DecodeRecorder() as rec:
        for arch in BLOCKS_ARCHS:
            record[arch] = serve_full_width(arch, rec)
    # the llama4 run's decode_attention calls (rep 5, hd 128) against plain
    calls = [args for label, args in rec.calls if label.startswith("llama4")]
    checked = [check_decode(args, "bfloat16") for args in calls]
    by = {"bytes": 0.0, "operations": 0.0}
    for r in checked:
        by[r["bound_by"]] += r["bound_ms"]
    sdpa_args = [sdpa_inputs(*a) for a in calls]
    llama4 = {
        "launches": record["llama4-maverick-400b-a17b"]["runs"]["plain"]["launches"],
        "calls": len(calls), "shapes": checked[0]["shapes"],
        "max_abs_err": max(r["max_abs_err"] for r in checked),
        "ms": pass_ms([lambda a=a: da.decode_attention(*a) for a in calls]),
        "plain_ms": pass_ms([lambda a=a: da.decode_attention_plain(*a) for a in calls]),
        "library_ms": pass_ms([lambda a=a: sdpa_call(*a) for a in sdpa_args]),
        "bound_ms": sum(by.values()), "bound_by": max(by, key=by.get),
    }
    del rec, calls, sdpa_args
    torch.cuda.empty_cache()
    q_shape, k_shape = llama4["shapes"][:2]
    print(f"blocks (d): decode_attention on the llama4 run's {llama4['calls']} calls (q "
          f"{q_shape}, k {k_shape}: rep {q_shape[1] // k_shape[2]}, hd {q_shape[2]}) == plain (max abs "
          f"err {llama4['max_abs_err']:.3g}, limit {KERNEL_TOL['bfloat16']}); one pass (CUDA "
          f"events, median of {TIMING_REPS}): kernel {llama4['ms']:.4f} ms plain "
          f"{llama4['plain_ms']:.4f} ms library {llama4['library_ms']:.4f} ms bound "
          f"{llama4['bound_ms']:.5f} ms ({llama4['bound_by']})")
    record["decode_attention_llama4"] = llama4
    record["layers"] = full_width_layers()
    record["reduced"] = reduced_archs()
    OUT_DIR.mkdir(exist_ok=True)
    with open(OUT_DIR / "chip_smoke_blocks.json", "w") as f:
        json.dump(record, f, indent=1)
    return llama4


# --------------------------------------------------------------------------- #
# Phase 14: the dry-run, and its predictions held against real steps
# --------------------------------------------------------------------------- #

DRYRUN_TIMEOUT_S = 240  # each CLI run (host time: imports, mesh, traces)
# predicted bytes above the arguments against measured: the runs in PERF.md
# read 0.0000-0.0013; the room is the caching allocator's rounding
DRYRUN_MEMORY_TOL = 0.02
DRYRUN_STEPS = {  # (b): chip_smoke's own sizes, as extra cells of the registry
    "smoke_prefill": ("prefill", LM_PROMPT),  # 8 x 1,024 prompt tokens
    "smoke_decode": ("decode", LM_PROMPT + LM_GEN),  # a full cache of 1,088
    "smoke_train": ("train", LM_PROMPT),  # one AdamW step on 8 x 1,024
}
DRYRUN_MESH_CELL = ("smoke_mesh_train", "train", 64, 16)  # (name, kind, seq, batch)
DRYRUN_MESH = (2, 2)  # traced on the explicit layout (dist/local.py), the heads route
DRYRUN_MESH_DEVICES = ("cuda", "cpu")  # the fake tensors' devices held equal in (b')


def dryrun_cli(args: list, out: Path) -> tuple[list[dict], list[str]]:
    """One run of ``python -m repro_torch.launch.dryrun`` (fake tensors over a
    fake group of 256 ranks; no card is used) writing ``out``: its records
    and the lines to print; raises unless it exits 0."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *args,
                           "--out", str(out)], capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=DRYRUN_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"dryrun {args} exited {proc.returncode}:\n"
                             f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    lines = [f"dryrun (a): {line.strip()}" for line in proc.stdout.splitlines()
             if line.startswith(("[dryrun]", "         roofline"))]
    lines.append(f"dryrun (a): {' '.join(args)}: {wall:.1f} s host wall")
    with open(out) as f:
        return json.load(f), lines


def start_dryrun_cli(pool: ThreadPoolExecutor) -> dict:
    """Phase 14(a)'s two CLI runs at full width, a decode cell with its
    accounting and the search, submitted to ``pool``: host work only, so
    ``main`` starts them first and they run while the kernels compile."""
    OUT_DIR.mkdir(exist_ok=True)
    return {"cell": pool.submit(dryrun_cli, ["--arch", LM_ARCH, "--shape", "decode_32k"],
                                OUT_DIR / "dryrun_decode_32k.json"),
            "search": pool.submit(dryrun_cli, ["--search"], OUT_DIR / "dryrun_search.json")}


def step_on_card(kind: str, model, cfg, seq: int) -> tuple:
    """(step function, its arguments) of one ``kind`` step of ``cfg`` on the
    card at chip_smoke's batch: the step the dry-run traces for such a cell
    (``launch/dryrun.py::_build_step``), on real tensors."""
    import torch

    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.train.train_step import make_train_step

    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, size=(LM_REQUESTS, seq),
                                           dtype=np.int32)).to(DEVICE)
    if kind == "train":
        init_state, train_step = make_train_step(cfg, optimizer="adamw")
        return train_step, (init_state(model), {"tokens": tokens})
    cache = init_cache(cfg, LM_REQUESTS, seq, DEVICE)
    if kind == "prefill":
        def fn(params, tokens, cache):
            for layer in cache:  # each run fills the cache from its start
                layer["len"] = 0
            return prefill(params, cfg, tokens, cache)

        return fn, (model, tokens, cache)
    for layer in cache:
        layer["len"] = seq - 1

    def fn(params, token, cache):
        return decode_step(params, cfg, token, cache, seq - 1)

    return fn, (model, tokens[:, :1].contiguous(), cache)


def measure_step(fn, args) -> dict:
    """FLOPs (``FlopCounterMode``), the peak of allocated bytes above what was
    allocated before the step, and the median CUDA-event ms of the step."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    fn(*args)  # warm: cuBLAS handles and workspaces exist before the count
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with FlopCounterMode(display=False) as fc:
        out = fn(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return {"flops": fc.get_total_flops(), "temp_bytes": peak,
            "ms": cuda_ms(lambda: fn(*args))}


def dryrun_phase(card: str, cli: dict) -> dict:
    """The dry-run on the card host (module docstring, phase 14), ``cli`` the
    CLI runs of :func:`start_dryrun_cli`; returns the decode step's
    decode_attention calls, checked."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.configs import get_config, registry
    from repro_torch.launch import dryrun
    from repro_torch.models import init_params
    from repro_torch.roofline.analysis import HW

    da = module("decode_attention")
    record = {"card": card}
    OUT_DIR.mkdir(exist_ok=True)
    # (a) the CLI at full width, started with the run (start_dryrun_cli)
    ((search,), search_lines), ((rec,), cell_lines) = cli["search"].result(), cli["cell"].result()
    print("\n".join(search_lines + cell_lines))
    calls = rec["ops"].get("repro_torch.decode_attention", {}).get("calls", 0)
    r = rec["roofline"]
    print(f"dryrun (a): {LM_ARCH} x decode_32k ok {rec['ok']} mesh {rec['mesh']} chips "
          f"{rec['chips']} device {rec['device']}; per device: memory {rec['memory']}; "
          f"flops {rec['trace_costs']['flops']:.6g} bytes {rec['trace_costs']['bytes']:.6g} "
          f"collective {rec['trace_costs']['collectives']}; roofline compute "
          f"{r['compute_s'] * 1e3:.4f} ms memory {r['memory_s'] * 1e3:.4f} ms collective "
          f"{r['collective_s'] * 1e3:.4f} ms -> {r['bottleneck']}; "
          f"repro_torch::decode_attention calls {calls}; trace_s {rec['trace_s']} (host)")
    if not (rec["ok"] and rec["mesh"] == "16x16" and rec["chips"] == 256 and calls == 30
            and rec["memory"]["argument_bytes"] > 0):
        raise AssertionError(f"dry-run decode_32k record off: {calls} decode_attention "
                             f"calls, {rec['mesh']}, {rec['chips']}")
    print(f"dryrun (a): search ok {search['ok']} mesh {search['mesh']} chips "
          f"{search['chips']}; collective {search['trace_costs']['collectives']}; "
          f"searchsorted calls {search['ops'].get('repro_torch.searchsorted', {}).get('calls')}; "
          f"trace_s {search['trace_s']} (host)")
    if not search["ok"]:
        raise AssertionError("dry-run search record not ok")
    record["cli"] = {"decode_32k": {k: v for k, v in rec.items() if k != "ops"},
                     "decode_attention_calls": calls,
                     "search": {k: v for k, v in search.items() if k != "ops"}}

    # (b) the one-device trace of each step beside the same step on the card
    cfg = get_config(LM_ARCH)
    for name, (kind, seq) in DRYRUN_STEPS.items():
        registry.SHAPES[name] = registry.ShapeCell(name, seq, LM_REQUESTS, kind)
    model = init_params(0, cfg, DEVICE)
    steps, decode_calls = {}, []
    for name, (kind, seq) in DRYRUN_STEPS.items():
        trace = dryrun.lower_step(cfg, name, None, 1)
        fn, args = step_on_card(kind, model, cfg, seq)
        if kind == "decode":
            launches = da.LAUNCHES
            with DecodeRecorder() as rec_calls:
                fn(*args)
            torch.cuda.synchronize()
            decode_calls = [a for _, a in rec_calls.calls]
            step_launches = da.LAUNCHES - launches
        got = measure_step(fn, args)
        del fn, args
        torch.cuda.empty_cache()
        bound_s = max(trace.costs["flops"] / HW["peak_flops"], trace.costs["bytes"] / HW["hbm_bw"])
        pred = trace.memory["temp_bytes"]
        err = abs(pred - got["temp_bytes"]) / max(got["temp_bytes"], 1)
        row = {"kind": kind, "seq": seq, "trace_s": trace.trace_s, "trace_costs": trace.costs,
               "memory": trace.memory, "measured": got, "memory_rel_err": err,
               "bound_ms": bound_s * 1e3,
               "bound_by": ("operations" if trace.costs["flops"] / HW["peak_flops"]
                            >= trace.costs["bytes"] / HW["hbm_bw"] else "bytes"),
               "share_of_bound": bound_s * 1e3 / got["ms"]}
        # a host whose PyTorch has no CUDA traces on fake cpu tensors
        cpu = dryrun.lower_step(cfg, name, None, 1, device="cpu")
        row["cpu_trace_costs"], row["cpu_memory"] = cpu.costs, cpu.memory
        if (cpu.costs, cpu.memory) != (trace.costs, trace.memory):
            raise AssertionError(f"{kind} trace on fake cpu {cpu.costs} {cpu.memory} != on "
                                 f"fake cuda {trace.costs} {trace.memory}")
        steps[name] = row
        print(f"dryrun (b): {LM_ARCH} {kind} {LM_REQUESTS} x {seq}: traced flops "
              f"{trace.costs['flops']:.6g} == card {got['flops']:.6g}; temp bytes above the "
              f"arguments predicted {pred} measured {got['temp_bytes']} (rel err {err:.4f}, "
              f"limit {DRYRUN_MEMORY_TOL}); traced bytes {trace.costs['bytes']:.6g}; step "
              f"{got['ms']:.4f} ms (CUDA events, median of {TIMING_REPS}) against the "
              f"roofline bound {bound_s * 1e3:.4f} ms ({row['bound_by']}): "
              f"{row['share_of_bound']:.4f} of it; trace {trace.trace_s:.2f} s (host); {card}")
        if got["flops"] != trace.costs["flops"]:
            raise AssertionError(f"{kind}: traced flops {trace.costs['flops']} != card "
                                 f"{got['flops']}")
        if not err <= DRYRUN_MEMORY_TOL:
            raise AssertionError(f"{kind}: predicted temp bytes {pred} against measured "
                                 f"{got['temp_bytes']}: {err:.3f} > {DRYRUN_MEMORY_TOL}")
    checked = [check_decode(a, "bfloat16") for a in decode_calls]
    if step_launches != 30 or len(checked) != 30:
        raise AssertionError(f"the decode step launched decode_attention {step_launches} "
                             f"times over {len(checked)} calls, not 30")
    decode = {"launches": step_launches,
              "max_abs_err": max(r["max_abs_err"] for r in checked)}
    print(f"dryrun (b): the decode step's {step_launches} decode_attention launches each "
          f"== plain (max abs err {decode['max_abs_err']:.3g}, limit "
          f"{KERNEL_TOL['bfloat16']})")
    del model, decode_calls, checked
    torch.cuda.empty_cache()

    # (b') a train cell on a fake mesh: traced on fake cuda == on fake cpu
    name, kind, seq, batch = DRYRUN_MESH_CELL
    registry.SHAPES[name] = registry.ShapeCell(name, seq, batch, kind)
    dryrun.fake_group(4)
    try:
        costs = {dev: dryrun.lower_step(cfg.reduced(), name, DeviceMesh(
            dev, torch.arange(4).reshape(DRYRUN_MESH), mesh_dim_names=("data", "model")), 1,
            device=dev).costs for dev in DRYRUN_MESH_DEVICES}
    finally:
        dist.destroy_process_group()
    first, second = (costs[d] for d in DRYRUN_MESH_DEVICES)
    print(f"dryrun (b'): reduced {LM_ARCH} train {batch} x {seq} on a fake {DRYRUN_MESH} mesh: "
          f"fake {DRYRUN_MESH_DEVICES[0]} {first['flops']:.6g} flops {first['bytes']:.6g} "
          f"bytes {first['collectives']}; fake {DRYRUN_MESH_DEVICES[1]} the same: "
          f"{first == second}")
    if first != second:
        raise AssertionError(f"mesh trace on fake {DRYRUN_MESH_DEVICES}: {first} != {second}")
    record.update(steps=steps, decode=decode, mesh_train=costs)
    with open(OUT_DIR / "chip_smoke_dryrun.json", "w") as f:
        json.dump(record, f, indent=1)
    return decode


def main() -> int:
    # cuBLAS reads this once, at its first handle: the training phase runs
    # with deterministic algorithms, which need it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs one card",
              file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    card = card_line()
    print(card)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")

    # host work that needs no kernel runs while the kernels compile: the
    # dry-run CLI's two processes (phase 14(a)) and the search corpus
    background = ThreadPoolExecutor(2)
    try:
        return run_phases(card, kind, t_start, start_dryrun_cli(background))
    finally:
        background.shutdown()  # a failed run waits for the CLI (its own timeout)


def run_phases(card: str, kind: str, t_start: float, cli: dict) -> int:
    """Every phase after the card check (module docstring); 0 when all pass."""
    import torch

    from repro_torch.kernels import _build

    # ---- build: one nvcc per source, all started together --------------- #
    modules = [module(name) for name in KERNELS]

    def build(mod):
        t0 = time.perf_counter()
        lib = _build.build(mod._SOURCE)
        return lib, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(modules)) as pool:
        builds = [pool.submit(build, mod) for mod in modules]
        corpus = search_corpus()
        built = [b.result() for b in builds]
    for mod, (lib, secs) in zip(modules, built):
        _build.load(mod._SOURCE)
        print(f"build: {lib.relative_to(ROOT)} in {secs:.2f} s")
    print(f"build: all {len(modules)} kernels in {time.perf_counter() - t0:.2f} s "
          f"(the corpus built on the host meanwhile)")

    search_lines, tree, engine, scalar = search_phase(card, corpus)
    del corpus
    print(f"search phase done at {time.perf_counter() - t_start:.1f} s")
    dist = dist_phase(card, engine, scalar)
    print(f"dist phase done at {time.perf_counter() - t_start:.1f} s")
    path = tempfile.mkdtemp(prefix="chip-smoke-cluster-")
    try:
        cluster, want = cluster_phase(card, tree, engine, path)
        print(f"cluster phase done at {time.perf_counter() - t_start:.1f} s")
        gateway = gateway_phase(card, tree, want, path)
        print(f"gateway phase done at {time.perf_counter() - t_start:.1f} s")
    finally:
        shutil.rmtree(path, ignore_errors=True)
    for line in search_lines:
        for phase in (dist, cluster, gateway):
            line.update(phase.get(line["name"], {}))
        line["max_abs_err"] = max(line["max_abs_err"],
                                  line.get("dist_max_abs_err", 0),
                                  line.get("cluster_max_abs_err", 0),
                                  line.get("gateway_max_abs_err", 0),
                                  line.get("gateway_split_max_abs_err", 0))
    del tree, engine
    torch.cuda.empty_cache()
    lines = [*search_lines, lm_phase()]
    print(f"lm phase done at {time.perf_counter() - t_start:.1f} s")
    torch.cuda.empty_cache()
    train_phase(card)
    print(f"train phase done at {time.perf_counter() - t_start:.1f} s")
    torch.cuda.empty_cache()
    llama4 = blocks_phase(card)
    print(f"blocks phase done at {time.perf_counter() - t_start:.1f} s")
    torch.cuda.empty_cache()
    dry = dryrun_phase(card, cli)
    print(f"dryrun phase done at {time.perf_counter() - t_start:.1f} s")
    decode_line = lines[-1]
    decode_line["lm_launches"] = decode_line["launches"]
    decode_line["llama4_launches"] = llama4["launches"]
    decode_line["dryrun_launches"] = dry["launches"]
    decode_line["launches"] += llama4["launches"] + dry["launches"]
    decode_line["max_abs_err"] = max(decode_line["max_abs_err"], llama4["max_abs_err"],
                                     dry["max_abs_err"])
    decode_line["llama4"] = llama4

    # ---- result lines --------------------------------------------------- #
    print(json.dumps({"kernels": lines}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
