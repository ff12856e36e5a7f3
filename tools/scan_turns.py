"""Time the two scan kernels of one source tree at the shapes their main path gives them.

    python3 tools/scan_turns.py [--tree DIR] [--label NAME]

imports ``repro_torch`` from ``DIR/src`` (default: this checkout), builds
its kernels into ``DIR/build``, and prints one JSON line, on an NVIDIA card
only (no CUDA: it exits 1).  For ``rwkv6_wkv`` at rwkv6-1.6b's widths (B 8,
32 heads of 64, bfloat16) and ``mamba_scan`` at jamba's Mamba layer (B 8, E
16,384, N 16, bfloat16), each on seeded inputs:

* ``prefill_ms``, ``decode_ms``: CUDA-event ms of one forward call at S
  1,024 and S 1 (the median of ``--reps``; a decode call, of 200 calls in a
  row);
* ``pass_ms``, ``pass_device_ms``: the main path's serving pass (rwkv6: 24
  layers x (a prefill + 63 decode steps), 1,536 calls; jamba's Mamba layer:
  1 + 63), by CUDA events and as the profiler's sum of the kernel's device
  time, with ``pass_launches`` the kernel launches it recorded;
* ``decode_host_us``: host µs a decode call, 200 calls in a row;
* ``backward_ms``: one backward call at the prefill shape (rwkv6 also at the
  training batch of 4, ``backward_b4_ms``).

To compare two trees on one card, run them in turns (A, B, B, A) in one
call: card and host change between calls.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
RWKV = dict(b=8, s=1024, h=32, hd=64, layers=24, steps=63)
MAMBA = dict(b=8, s=1024, e=16384, n=16, layers=1, steps=63)


def median_ms(torch, fn, reps: int, inner: int = 1) -> float:
    """Median CUDA-event ms of ``inner`` calls of ``fn`` over ``reps``, per call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_pass(torch, fn, kernel: str) -> tuple[float | None, int]:
    """(device ms, launches) of ``kernel`` in a profiled pass of ``fn``, the
    pass after a profiled warm-up pass; (None, 0) if no device event came."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    ms = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
          if e.device_type == DeviceType.CUDA and kernel in e.name]
    return (sum(ms) if ms else None), len(ms)


def measure(ss, torch, reps: int) -> dict:
    gen = torch.Generator("cuda").manual_seed(0)
    bf = torch.bfloat16

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    out = {}
    p = RWKV
    b, s, h, hd = p["b"], p["s"], p["h"], p["hd"]

    def rwkv_args(b, s):
        return (rnd(b, h, hd, hd), *(rnd(b, s, h, hd, scale=0.5, dtype=bf) for _ in range(3)),
                torch.exp(-torch.exp(rnd(b, s, h, hd, scale=0.5) - 2.0)), rnd(h, hd, scale=0.5))

    pre, dec = rwkv_args(b, s), rwkv_args(b, 1)
    calls = [pre] * p["layers"] + [dec] * (p["layers"] * p["steps"])

    def rwkv_pass():
        for a in calls:
            ss.rwkv6_wkv(*a)

    r = out["rwkv6_wkv"] = {
        "prefill_ms": median_ms(torch, lambda: ss.rwkv6_wkv(*pre), reps),
        "decode_ms": median_ms(torch, lambda: ss.rwkv6_wkv(*dec), reps, 200),
        "pass_ms": median_ms(torch, rwkv_pass, 3), "calls": len(calls)}
    r["pass_device_ms"], r["pass_launches"] = device_pass(torch, rwkv_pass, "wkv_fwd")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        ss.rwkv6_wkv(*dec)
    r["decode_host_us"] = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    for key, bb in (("backward_ms", b), ("backward_b4_ms", 4)):
        a = pre if bb == b else rwkv_args(bb, s)
        y, st = ss.rwkv6_wkv(*a)
        g = (rnd(*y.shape), rnd(*st.shape))
        r[key] = median_ms(torch, lambda: ss.RWKV_BWD_OP(*g, *a), max(reps // 2, 3))
    del pre, dec, calls
    torch.cuda.empty_cache()

    p = MAMBA
    b, s, e, n = p["b"], p["s"], p["e"], p["n"]

    def mamba_args(s):
        return (rnd(b, e, n), (rnd(b, s, e, scale=0.1).abs() + 0.001).to(bf),
                rnd(b, s, n, dtype=bf), rnd(b, s, n, dtype=bf), rnd(b, s, e, dtype=bf),
                -(rnd(e, n).abs() + 0.1))

    pre, dec = mamba_args(s), mamba_args(1)
    calls = [pre] * p["layers"] + [dec] * (p["layers"] * p["steps"])

    def mamba_pass():
        for a in calls:
            ss.mamba_scan(*a)

    m = out["mamba_scan"] = {
        "prefill_ms": median_ms(torch, lambda: ss.mamba_scan(*pre), reps),
        "decode_ms": median_ms(torch, lambda: ss.mamba_scan(*dec), reps, 200),
        "pass_ms": median_ms(torch, mamba_pass, 3), "calls": len(calls)}
    m["pass_device_ms"], m["pass_launches"] = device_pass(torch, mamba_pass, "mamba_fwd")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        ss.mamba_scan(*dec)
    m["decode_host_us"] = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    y, hl = ss.mamba_scan(*pre)
    g = (rnd(*y.shape), rnd(*hl.shape))
    m["backward_ms"] = median_ms(torch, lambda: ss.MAMBA_BWD_OP(*g, *pre), max(reps // 2, 3))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=ROOT, help="a source tree with src/repro_torch")
    ap.add_argument("--label", default=None, help="the name printed with the numbers")
    ap.add_argument("--reps", type=int, default=20, help="timed repetitions a median")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("scan_turns: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.tree.resolve() / "src"))
    from repro_torch.kernels import ssm_scan as ss

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    t0 = time.perf_counter()
    rec = {"label": args.label or str(args.tree), "card": card.strip().splitlines()[0],
           "torch": torch.__version__, "module": ss.__file__, **measure(ss, torch, args.reps)}
    rec["seconds"] = time.perf_counter() - t0
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
