#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card and check it.

    python3 chip_smoke.py            # from the repository root, one CUDA card

Phases (any failure exits non-zero, and no result line is printed):

  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the four kernels from ``src/repro_torch/csrc`` with nvcc, one
     process per source, all at once, with the time of each;
  3. the fused path at a realistic size: the synthetic discogs corpus of 20,000
     releases (about 1.03 M nodes), ``KeywordSearchEngine`` on ``cuda``, the
     paper's nine queries x slca/elca x the tree and DAG indexes with
     ``backend="fused"`` through ``engine.query``, then a
     ``QueryService(backend="fused")`` answering the 18 DAG queries
     submitted together.  The kernel's launch count is zeroed just before
     and read just after;
  4. every answer equals the port's ``"scalar"`` backend (the paper's host
     algorithms) and the ``"torch"`` backend on the same engine;
  5. the chained path on the same engine: warmed on Q4-Q9, then one counted
     pass of the 36 engine queries with ``backend="chained"`` and a
     ``QueryService(backend="chained")`` answering the 18 DAG queries in one
     window; the searchsorted, intersect and elca_segsum launch counts are
     zeroed just before and read just after, each must be > 0, and every
     answer must equal ``"scalar"``;
  6. the fused kernel against its plain PyTorch version, byte for byte, on
     seeded random packed batches (k = 1..4 x slca/elca/ca, all-pad rows,
     single-element lists, R up to 64) and on every batch the counted fused
     path launched (engine and service alike, kept as they were packed),
     with CUDA-event times of each batch and of one pass of them all, the
     plain version's times and the bound;
  7. each chained kernel against its plain version the same way, on seeded
     random shapes and on every call the counted chained path made, with
     the time of one ``torch.searchsorted`` call on the same inputs beside
     the searchsorted and intersect kernels (no single PyTorch call
     computes the ELCA child sums);
  8. a ``{"kernels": [...]}`` line, the nvidia-smi line, and as the last
     line ``{"ok": true, "device": {...}}``.

Per-call details go to ``chiprun_out/chip_smoke_rounds.json``.
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
    library: str | None  # the torch function computing the same, if one does


KERNELS = {
    "fused_search": Kernel(
        "fused_search_batch", "src/repro/kernels/fused_search.py:62",
        ("membership_kernel", "parent_kernel", "keep_kernel"), None,
    ),
    "searchsorted": Kernel(
        "searchsorted", "src/repro/kernels/searchsorted.py:18",
        ("searchsorted_kernel",), "searchsorted",
    ),
    # the library call gives the positions; found is one compare more
    "intersect": Kernel(
        "intersect_membership", "src/repro/kernels/intersect.py:36",
        ("intersect_kernel",), "searchsorted",
    ),
    # no single call: the plain version is searchsorted + index_add_
    "elca_segsum": Kernel(
        "elca_child_sums", "src/repro/kernels/elca_segsum.py:24",
        ("segsum_kernel", "Memset"), None,
    ),
}
CHAINED = ("searchsorted", "intersect", "elca_segsum")  # the chained path's


def module(name: str):
    return importlib.import_module(f"repro_torch.kernels.{name}")


def functions(name: str):
    """(kernel wrapper, plain version, library call or None) of a kernel."""
    import torch

    k, mod = KERNELS[name], module(name)
    return (
        getattr(mod, k.wrapper), getattr(mod, k.wrapper + "_plain"),
        getattr(torch, k.library) if k.library else None,
    )


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------- #
# Seeded random corpora: random trees, ancestor-closed lists
# --------------------------------------------------------------------------- #


def random_item(rng, k: int, max_nodes: int = 4000):
    """k ancestor-closed IDLists over one random tree (parents have lower ids)."""
    from repro_torch.core.idlist import IDList, make_pidpos

    n = int(rng.integers(5, max_nodes))
    par = np.full(n, -1, np.int64)
    for i in range(1, n):
        par[i] = int(rng.integers(max(0, i - 8), i))
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


def profile_pass(fn) -> tuple[float, dict[str, float]]:
    """Run ``fn`` once under torch.profiler: (wall ms, {device op: ms}).

    Device ops are the kernels and copies the profiler saw on the card; an
    empty dict means it saw none (then nothing is reported as measured).
    """
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev: dict[str, float] = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            dev[evt.name] = dev.get(evt.name, 0.0) + evt.time_range.elapsed_us() / 1e3
    return wall_ms, dev


def kernel_device_ms(dev: dict[str, float], name: str) -> float:
    """Device ms of kernel ``name``'s device operations in a profile."""
    ops = KERNELS[name].device_ops
    return sum(ms for op, ms in dev.items() if any(p in op for p in ops))


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
        "kept": int(mask.sum()),
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


# --------------------------------------------------------------------------- #
# The chained kernels vs plain
# --------------------------------------------------------------------------- #


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
    prefix per query (searchsorted; intersect, plus one compare for found);
    for the child sums one binary search per entry with a parent and k adds
    per parent found.
    """
    import torch

    from repro_torch.kernels.shapes import INT_PAD

    if name == "searchsorted":
        a, q = args
        n_valid = (a != INT_PAD).sum(dim=1).tolist()
        n_bytes = 4 * (sum(n_valid) + 2 * q.numel())
        n_ops = q.shape[1] * sum(log2_steps(n) for n in n_valid)
    elif name == "intersect":
        a, q = args
        n_bytes = 4 * a.numel() + 9 * q.numel()  # pos int32 + found bool out
        n_ops = q.numel() * (log2_steps(a.numel()) + 1)
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
    return {
        "shapes": [list(a.shape) for a in args], "max_abs_err": err,
        "ms": cuda_ms(lambda: kernel(*args)),
        "plain_ms": cuda_ms(lambda: plain(*args)),
        "library_ms": cuda_ms(lambda: library(*args)) if library else None,
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": n_bytes, "ops": n_ops,
    }


def chained_random_cases():
    """(kernel, label, inputs on the card) of the random chained checks."""
    import torch

    rng = np.random.default_rng(1)

    def sorted_unique(n, hi):
        return np.unique(rng.integers(0, hi, size=n)).astype(np.int32)

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(DEVICE)

    cases = []
    for na, nq in ((1, 1), (513, 511), (1000, 100), (100, 1000), (5000, 5000),
                   (0, 7), (60_001, 20_001)):
        a = sorted_unique(na, 10**6)
        pool = np.unique(np.concatenate([
            rng.choice(a, size=min(nq, a.size), replace=False),
            rng.integers(0, 10**6, size=nq),
        ]))
        # below and above the range, sorted, nq queries in all
        q = np.unique(np.concatenate([pool[: max(nq - 2, 0)], [-5, 2**31 - 2]]))
        cases.append(("intersect", f"na={a.size} nq={q.size}", (on(a), on(q[:nq]))))
    for rows, m, nq in ((1, 1, 1), (1, 513, 511), (8, 4096, 1000),
                        (64, 4096, 300), (64, 65_536, 64), (7, 65_536, 20_001)):
        a = np.full((rows, m), np.iinfo(np.int32).max, np.int32)
        for r in range(rows):
            row = sorted_unique(int(rng.integers(1, m + 1)), 10 * m)
            a[r, : row.size] = row[:m]
        q = rng.integers(-5, 10 * m + 5, size=(rows, nq))  # unsorted
        cases.append(("searchsorted", f"B={rows} M={m} Q={nq}", (on(a), on(q))))
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
    return cases


class CallRecorder:
    """Keeps every call the chained path makes to its three kernels.

    Inside ``with CallRecorder() as rec`` each kernel wrapper the chained
    path calls through ``repro_torch.kernels.ops`` (``KERNELS``) is wrapped:
    its inputs go to ``rec.calls[kernel]`` as ``(rec.label, args)``, then the
    wrapper runs as it would.
    """

    def __init__(self):
        self.label = ""
        self.calls: dict[str, list] = {name: [] for name in CHAINED}

    def __enter__(self):
        from repro_torch.kernels import ops

        self._orig = {name: getattr(ops, KERNELS[name].wrapper) for name in CHAINED}
        for name in CHAINED:
            def wrapped(*args, _name=name, _fn=self._orig[name]):
                self.calls[_name].append((self.label, args))
                return _fn(*args)

            setattr(ops, KERNELS[name].wrapper, wrapped)
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        for name in CHAINED:
            setattr(ops, KERNELS[name].wrapper, self._orig[name])


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs one card",
              file=sys.stderr)
        return 2
    from repro_torch.core import KeywordSearchEngine, PlanCache
    from repro_torch.data import generate_discogs_tree
    from repro_torch.kernels import _build, fused_search

    card = card_line()
    print(card)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")

    # ---- 1. build: one nvcc per source, all started together ------------ #
    modules = [module(name) for name in KERNELS]

    def build(mod):
        t0 = time.perf_counter()
        lib = _build.build(mod._SOURCE)
        return lib, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(modules)) as pool:
        built = list(pool.map(build, modules))
    for mod, (lib, secs) in zip(modules, built):
        _build.load(mod._SOURCE, mod._FUNCTIONS)
        print(f"build: {lib.relative_to(ROOT)} in {secs:.2f} s")
    print(f"build: all {len(modules)} kernels in {time.perf_counter() - t0:.2f} s")

    # ---- 2. corpus + engine on the card ---------------------------------- #
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

    # ---- 3. main path: warm, then counted ------------------------------- #
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

    # ---- 4. answers against the scalar and torch backends ---------------- #
    scalar, scalar_lat = run_engine(engine, "scalar")
    run_engine(engine, "torch")  # warm
    vec, torch_lat = run_engine(engine, "torch")
    assert_equal(fused, scalar, "fused engine")
    assert_equal(served, scalar, "fused service")
    assert_equal(vec, scalar, "torch engine")
    n_ids = sum(v.size for v in scalar.values())
    print(f"answers: {len(fused)} fused + {len(served)} service + {len(vec)} "
          f"torch equal scalar ({n_ids} ids in all)")

    # ---- 5. the chained path: warm on Q4-Q9, then counted ----------------- #
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
    assert_equal(chained, scalar, "chained engine")
    assert_equal(chained_served, scalar, "chained service")
    print(
        f"chained path: {len(chained)} engine + {len(chained_served)} service "
        f"queries equal scalar; launches {json.dumps(chained_launches)}; "
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
    wall_ms, dev = profile_pass(lambda: run_engine(engine, "fused"))
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

    # ---- 6. the fused kernel vs plain ----------------------------------- #
    random_recs = []
    for label, items, sem, min_rows in random_batches():
        plan = PlanCache(backend="fused", min_rows=min_rows, device=DEVICE)
        batch, _, _ = plan.pack(items, list(range(len(items))), sem, "fused")
        r = check_kernel(batch, sem)
        r["case"] = label
        random_recs.append(r)
        print(
            f"kernel==plain {label}: R={r['rows']} k={r['k']} m0={r['m0']} "
            f"mo={r['mo']} kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms "
            f"bound {r['bound_ms']:.5f} ms ({r['bound_by']})"
        )
    round_recs = []
    for label, batch, sem in rounds:
        r = check_kernel(batch, sem)
        r["query"] = label
        round_recs.append(r)
        print(
            f"kernel==plain round {label}: R={r['rows']} k={r['k']} "
            f"m0={r['m0']} mo={r['mo']} kernel {r['ms']:.4f} ms plain "
            f"{r['plain_ms']:.4f} ms bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']})"
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
    _, dev = profile_pass(lambda: [
        fused_search.fused_search_batch(**b, semantics=s) for _l, b, s in rounds
    ])
    device_ms = kernel_device_ms(dev, "fused_search") if dev else None
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
        + (f"{device_ms:.4f} ms in {3 * len(rounds)} pass launches"
           if device_ms is not None else "not measured (no device events)")
    )

    # ---- 7. the chained kernels vs plain --------------------------------- #
    chained_recs = {name: {"random": [], "calls": []} for name in CHAINED}
    for name, label, args in chained_random_cases():
        r = check_chained(name, args)
        r["case"] = label
        chained_recs[name]["random"].append(r)
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(
            f"{name}==plain {label}: kernel {r['ms']:.4f} ms plain "
            f"{r['plain_ms']:.4f} ms library {lib} bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']})"
        )
    chained_lines = []
    for name in CHAINED:
        kernel, plain, library = functions(name)
        recorded = calls.calls[name]
        recs = chained_recs[name]["calls"]
        for label, args in recorded:
            r = check_chained(name, args)
            r["query"] = label
            recs.append(r)
        passes = {
            "ms": pass_ms([lambda a=a: kernel(*a) for _l, a in recorded]),
            "plain_ms": pass_ms([lambda a=a: plain(*a) for _l, a in recorded]),
            "library_ms": pass_ms([lambda a=a: library(*a) for _l, a in recorded])
            if library else None,
        }
        _, dev = profile_pass(lambda: [kernel(*a) for _l, a in recorded])
        dev_ms = kernel_device_ms(dev, name) if dev else None
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
            + ("not measured" if dev_ms is None else f"{dev_ms:.4f} ms")
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
            "bound_by": max(by, key=by.get),
            "library_ms": passes["library_ms"],
            "matches_plain": True, "calls": len(recs),
        })

    OUT_DIR.mkdir(exist_ok=True)
    with open(OUT_DIR / "chip_smoke_rounds.json", "w") as f:
        json.dump({"card": card, "random": random_recs, "rounds": round_recs,
                   "chained": chained_recs, "main_path_profile": profile_rec,
                   "per_query": per_query}, f, indent=1)

    # ---- 8. result lines --------------------------------------------- #
    err = max(r["max_abs_err"] for r in random_recs + round_recs)
    print(json.dumps({"kernels": [{
        "name": "fused_search", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_search.cu",
        "replaces": KERNELS["fused_search"].replaces, "launches": main_launches, "max_abs_err": err,
        "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
        "device_ms": device_ms,
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in round_recs)
        else "operations",
        "library_ms": None,
        "matches_plain": True,
        "rounds": len(round_recs),
    }, *chained_lines]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
