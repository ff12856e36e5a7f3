"""Multi-pod dry-run: trace every (arch × shape × mesh) cell on fake tensors.

The reference lowers and compiles each cell's production step for 512
placeholder TPU devices and reads its memory and costs from XLA.  The port
*traces* the step the card would run: under ``FakeTensorMode`` (tensors
with shapes and no data), over torch's ``"fake"`` process group with 256
or 512 ranks (``FakeStore``; it runs no collective), with DTensor placing
every tensor on the production mesh.  No card is needed, as the reference
needed no TPU.  The trace takes the card's path: the kernels are the
registered ops ``repro_torch::decode_attention`` and
``repro_torch::searchsorted`` (``kernels/``), whose fake implementations
give their outputs' shapes on a fake tensor of any device, and no op of
the port picks its route by device.  So the fake tensors lie on
``"cuda"`` where PyTorch has CUDA and on ``"cpu"`` elsewhere
(:func:`trace_device`); ``chip_smoke.py`` holds the two traces equal on
the card for a prefill, a decode and a train step.

Per valid cell the dry-run:
  1. starts the fake group and builds the production mesh (16,16) or
     (2,16,16) (``launch/mesh.py``);
  2. builds the step's inputs from ``configs.input_specs_for`` and the
     parameters and optimizer state on fake tensors, placed by
     ``dist/sharding.py`` (``param_specs``, ``data_specs``,
     ``cache_specs``, ``to_named``);
  3. traces the step at full depth (``make_train_step``, ``prefill``, or
     ``forward`` over ``embeddings`` for encoder-only archs,
     ``decode_step``) under ``roofline/profile.py``'s ``TraceCounter``,
     which counts one device's FLOPs, bytes, collective bytes, live memory
     and an op table, below DTensor (the local shards);
  4. (single-pod) additionally traces the two *accounting clones*, 1 and
     2 scan units deep, and extrapolates
         total = m1 + (num_steps - 1) · (m2 - m1)
     as the reference does (it had to: XLA counts a while body once).  The
     clones run the cell's microbatches (the reference's ran one): under
     DTensor a rank's work depends on the rows it holds (ROADMAP §3).  The
     port's full-depth trace counts every layer, so the extrapolation can
     be checked against it exactly (``tests/test_torch_dryrun.py``; the
     record's ``accounting["matches_trace"]``); it is the cheap path
     ``hillclimb.measure`` takes;
  5. computes the H100 roofline from the full-depth trace's costs;
  6. appends a JSON record to --out.

The record keeps the reference's keys where their meaning holds (``arch``,
``shape``, ``mesh`` "16x16", ``chips``, ``microbatches``, ``ok``,
``memory``, ``accounting``, ``roofline``), plus ``share``: the one-device
trace's FLOPs at the cell's microbatches (``account_cell`` with no mesh)
and the chips' FLOPs over them (1 where each device computes its share);
a record of a ``cfg_override`` (a depth clone) has ``units``, its depth in
scan units, so that it cannot pass for the cell.  Two are renamed: ``compile_s``
is ``trace_s`` (host seconds to build and trace the step), and
``hlo_once_costs`` is ``trace_costs`` (every layer counted, not a while
body once).  ``ops`` is the trace's op table (op -> calls, flops, bytes,
result bytes), which ``roofline/profile.py`` reads where the reference
read HLO text.  Memory is per device: ``argument_bytes`` the local shards
of the step's inputs, ``output_bytes`` those of its outputs, ``temp_bytes``
the peak of live bytes during the step minus the arguments.

A decode cell's cache is full (``seq_len - 1`` positions held), so its
step reads all of T, as the reference's traced scalar length made it.

Usage:
  python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
  python -m repro_torch.launch.dryrun --all --multi-pod both --out results.json
  python -m repro_torch.launch.dryrun --search   # the paper's engine on the mesh
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from contextlib import nullcontext

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import (
    SHAPES,
    all_cells,
    cell_applicable,
    get_config,
    input_specs_for,
)
from repro_torch.dist import ctx as shard_ctx
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import ModelConfig, decode_step, prefill
from repro_torch.models.model import Model, forward
from repro_torch.roofline.analysis import analyze, model_flops_for
from repro_torch.roofline.profile import TraceCounter, storage_bytes, tracing_dtensor
from repro_torch.train.optimizer import pick_optimizer
from repro_torch.train.train_step import make_train_step
from repro_torch.tree import tree_map

COST_KEYS = ("flops", "bytes", "collective_bytes")


def microbatches_for(cfg: ModelConfig, shape: str) -> int:
    """Activation-memory knob for the big training cells (§Perf tunes this)."""
    if shape != "train_4k":
        return 1
    n = cfg.param_count()
    if n >= 100e9:
        return 16  # 340-400B: peak temp must stay under 16GB/chip
    if n >= 10e9:
        return 2
    return 1


def _depth_clone(cfg: ModelConfig, units: int) -> ModelConfig:
    """A depth-``units`` clone (``units`` scan units of layers), for the
    accounting extrapolation; traced, every layer is counted."""
    return dataclasses.replace(
        cfg,
        n_layers=cfg.scan_period * units,
        layer_pattern=cfg.scan_unit * units,
        scan_unroll=units,
        head_dim=cfg.head_dim,
    )


def fake_group(world: int) -> None:
    """Start torch's ``"fake"`` process group with ``world`` ranks (this
    process is rank 0), replacing a group of another size."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


@dataclasses.dataclass
class Trace:
    """What one traced step showed: per-device costs (``profile.TraceCounter``
    keys), memory and the op table."""

    costs: dict
    memory: dict
    counter: TraceCounter
    trace_s: float


def _on(device: str):
    """A stand-in (meta) tensor tree made on ``device`` (inside FakeTensorMode)."""
    return lambda t: (torch.empty(t.shape, dtype=t.dtype, device=device)
                      if isinstance(t, torch.Tensor) else t)


def _place(tree, specs_fn, mesh):
    return tree if mesh is None else shd.to_named(tree, specs_fn(tree, mesh), mesh)


def _build_step(cfg: ModelConfig, shape: str, mesh, microbatches: int, device: str,
                optimizer: str):
    """(step function, its arguments) of the production step, on fake
    tensors placed on ``mesh`` (one device when ``mesh`` is None)."""
    cell = SHAPES[shape]
    specs = tree_map(_on(device), input_specs_for(cfg, shape))
    model = Model(cfg, device)  # parameters as fake tensors: never initialised

    if cell.kind == "train":
        init_state, train_step = make_train_step(
            cfg, optimizer=optimizer, microbatches=microbatches)
        state = _place(init_state(model), shd.param_specs, mesh)
        batch = _place(specs["batch"], shd.data_specs, mesh)
        return train_step, (state, batch)

    model = _place(model, shd.param_specs, mesh)
    if cell.kind == "prefill":
        if cfg.encoder_only:
            @torch.no_grad()
            def enc_fwd(params, embeddings):
                logits, _ = forward(params, cfg, embeddings=embeddings)
                return logits

            return enc_fwd, (model, _place(specs["embeddings"], shd.data_specs, mesh))
        cache = _place(specs["cache"], shd.cache_specs, mesh)
        tokens = _place(specs["tokens"], shd.data_specs, mesh)
        if "embeddings" in specs:
            emb = _place(specs["embeddings"], shd.data_specs, mesh)

            def fn(params, tokens, cache, embeddings):
                return prefill(params, cfg, tokens, cache, embeddings=embeddings)

            return fn, (model, tokens, cache, emb)

        def fn(params, tokens, cache):
            return prefill(params, cfg, tokens, cache)

        return fn, (model, tokens, cache)

    cache = _place(specs["cache"], shd.cache_specs, mesh)
    token = _place(specs["token"], shd.data_specs, mesh)

    def fn(params, token, cache):
        return decode_step(params, cfg, token, cache, specs["step_position"])

    return fn, (model, token, cache)


def trace_device() -> str:
    """The fake tensors' device: ``"cuda"`` where PyTorch has CUDA, else
    ``"cpu"`` (module docstring)."""
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def lower_step(cfg: ModelConfig, shape: str, mesh, microbatches: int = 1, *,
               device: str | None = None, optimizer: str | None = None) -> Trace:
    """Build and trace the production step for (cfg, shape) on mesh.

    ``mesh`` None traces one device.  ``device`` defaults to
    :func:`trace_device`; the tests trace ``"cpu"`` to compare FLOPs with a
    real CPU run of the same step.  ``optimizer`` defaults to
    ``pick_optimizer(cfg)`` (a depth clone takes its model's).
    """
    device = device or trace_device()
    optimizer = optimizer or pick_optimizer(cfg)
    t0 = time.perf_counter()
    with FakeTensorMode(), tracing_dtensor(), (
            nullcontext() if mesh is None else shard_ctx.use(mesh)):
        step, args = _build_step(cfg, shape, mesh, microbatches, device, optimizer)
        counter = TraceCounter()
        arg_bytes = counter.hold(args)
        with counter:
            out = step(*args)
        memory = {
            "argument_bytes": arg_bytes,
            "output_bytes": storage_bytes(out),
            "temp_bytes": counter.peak - arg_bytes,
        }
        del out, args, step
    return Trace(counter.costs(), memory, counter, time.perf_counter() - t0)


def account_cell(cfg: ModelConfig, shape: str, mesh, microbatches: int, *,
                 device: str | None = None, optimizer: str | None = None) -> dict:
    """Per-device costs via the 1-unit / 2-unit clone extrapolation (each
    clone traced with ``microbatches`` and ``cfg``'s optimizer, by default
    ``pick_optimizer(cfg)``: a clone of a model of 100 B parameters or more
    is smaller, and would pick AdamW), as the reference's ``account_cell``;
    ``trace_s``, the host seconds of each clone's trace."""
    optimizer = optimizer or pick_optimizer(cfg)
    t1 = lower_step(_depth_clone(cfg, 1), shape, mesh, microbatches, device=device,
                    optimizer=optimizer)
    m1, trace_s = t1.costs, [t1.trace_s]
    steps = cfg.num_scan_steps
    if steps == 1:  # whole net in one unit (e.g. deepseek): m1 is exact
        m2 = m1
    else:
        t2 = lower_step(_depth_clone(cfg, 2), shape, mesh, microbatches, device=device,
                        optimizer=optimizer)
        m2 = t2.costs
        trace_s.append(t2.trace_s)

    def extra(key):
        # clamp, as the reference: an extrapolation never goes negative
        return max(0.0, m1[key] + (steps - 1) * (m2[key] - m1[key]))

    return {
        "flops": extra("flops"),
        "bytes": extra("bytes"),
        "collective_bytes": extra("collective_bytes"),
        "per_unit": {k: m2[k] - m1[k] for k in COST_KEYS},
        "outside": {k: 2 * m1[k] - m2[k] for k in COST_KEYS},
        "trace_s": [round(t, 2) for t in trace_s],
    }


def _mesh_name(mesh) -> str:
    return "x".join(str(s) for s in mesh.shape)


def lower_cell(
    arch: str,
    shape: str,
    multi_pod: bool,
    verbose: bool = True,
    with_accounting: bool | None = None,
    cfg_override: ModelConfig | None = None,
    microbatches: int | None = None,
) -> dict:
    """Trace one cell on the production mesh over a fake group of 256 (512
    with ``multi_pod``) ranks; returns its record (module docstring)."""
    cfg = cfg_override or get_config(arch)
    cell = SHAPES[shape]
    chips = 512 if multi_pod else 256
    fake_group(chips)
    device = trace_device()
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=device)
    mesh_name = _mesh_name(mesh)
    mb = microbatches_for(cfg, shape) if microbatches is None else microbatches
    if with_accounting is None:
        with_accounting = not multi_pod

    opt = pick_optimizer(get_config(arch))  # a depth clone's (cfg_override) too
    full = lower_step(cfg, shape, mesh, mb, optimizer=opt)
    acct = account_cell(cfg, shape, mesh, mb, optimizer=opt) if with_accounting else None
    one = account_cell(cfg, shape, None, mb, optimizer=opt)

    rec = {
        "arch": arch,
        "shape": shape,
        "mesh": mesh_name,
        "chips": chips,
        "microbatches": mb,
        "ok": True,
        "device": device,
        "trace_s": round(full.trace_s, 1),
        "memory": full.memory,
        "trace_costs": full.costs,  # every layer counted
        "ops": full.counter.table,
        # the step's FLOPs on one device at the same microbatches, and the
        # chips' FLOPs over them: 1 where each device computes its share
        "share": {"one_device_flops": one["flops"],
                  "ratio": chips * full.costs["flops"] / one["flops"] if one["flops"] else None},
    }
    if cfg_override is not None:  # not the cell's model: the record says how deep
        rec["units"] = cfg.num_scan_steps
    if acct is not None:
        acct["matches_trace"] = all(acct[k] == full.costs[k] for k in COST_KEYS)
        rec["accounting"] = acct
    rec["roofline"] = analyze(
        arch=arch,
        shape=shape,
        mesh_name=mesh_name,
        chips=chips,
        cost=full.costs,
        model_flops=model_flops_for(cfg, cell, cell.kind == "train"),
    ).to_dict()

    if verbose:
        ms = rec["memory"]
        line = (
            f"[dryrun] {arch}{'' if cfg_override is None else f' ({cfg.num_scan_steps} units)'}"
            f" × {shape} × {mesh_name}: OK "
            f"({rec['trace_s']}s host) args={_gb(ms['argument_bytes'])} "
            f"temp={_gb(ms['temp_bytes'])}"
        )
        r = rec["roofline"]
        line += (
            f"\n         roofline: compute={r['compute_s']*1e3:.2f}ms"
            f" memory={r['memory_s']*1e3:.2f}ms"
            f" collective={r['collective_s']*1e3:.2f}ms"
            f" -> {r['bottleneck']}-bound"
            f" useful={r['useful_ratio']:.2f} frac={r['hw_fraction']:.2f}"
            f" share={rec['share']['ratio']:.4f}x"
        )
        print(line, flush=True)
    return rec


def lower_search(multi_pod: bool, verbose: bool = True, *, backend: str = "chained",
                 device: str | None = None) -> dict:
    """Dry-run for the paper's engine: the batched distributed keyword search
    (``make_distributed_search``, ELCA, k = 3) traced on each rank's
    ``[q, k, SEG]`` segment of ``[q, k, M, SEG]`` int32 inputs."""
    from repro_torch.dist.search_shard import make_distributed_search

    chips = 512 if multi_pod else 256
    fake_group(chips)
    device = device or trace_device()
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=device)
    mesh_name = _mesh_name(mesh)
    k, seg, q = 3, 8192, 64 * (2 if multi_pod else 1)
    fn = make_distributed_search(mesh, k, "elca", backend=backend)
    t0 = time.perf_counter()
    with FakeTensorMode():
        args = [torch.empty((q, k, seg), dtype=torch.int32, device=device) for _ in range(3)]
        counter = TraceCounter()
        arg_bytes = counter.hold(args)
        with counter:
            out = fn(*args)
        memory = {"argument_bytes": arg_bytes, "output_bytes": storage_bytes(out),
                  "temp_bytes": counter.peak - arg_bytes}
    costs = counter.costs()
    rec = {
        "arch": "idcluster-search",
        "shape": f"q{q}_seg{seg}_k{k}",
        "mesh": mesh_name,
        "chips": chips,
        "backend": backend,
        "ok": True,
        "trace_s": round(time.perf_counter() - t0, 1),
        "memory": memory,
        "trace_costs": costs,
        "ops": counter.table,
    }
    if verbose:
        print(
            f"[dryrun] idcluster-search × {mesh_name}: OK ({rec['trace_s']}s host) "
            f"coll={_gb(costs['collective_bytes'])}",
            flush=True,
        )
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=["off", "on", "both"], default="off")
    ap.add_argument("--search", action="store_true")
    ap.add_argument("--no-accounting", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    pods = {"off": [False], "on": [True], "both": [False, True]}[args.multi_pod]
    records = []
    cells: list[tuple[str, str]] = []
    if args.all:
        cells = [(a, s) for a, s, ok, _ in all_cells() if ok]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    elif not args.search:
        ap.error("need --arch+--shape, --all, or --search")

    failed = 0
    for multi_pod in pods:
        if args.search:
            records.append(lower_search(multi_pod))
        for arch, shape in cells:
            ok, reason = cell_applicable(get_config(arch), shape)
            if not ok:
                print(f"[dryrun] {arch} × {shape}: SKIP ({reason})", flush=True)
                continue
            try:
                records.append(
                    lower_cell(
                        arch, shape, multi_pod,
                        with_accounting=(not multi_pod) and not args.no_accounting,
                    )
                )
            except Exception as e:  # a failure here is a bug in the system
                failed += 1
                traceback.print_exc()
                records.append(
                    {"arch": arch, "shape": shape, "multi_pod": multi_pod,
                     "ok": False, "error": f"{type(e).__name__}: {e}"}
                )
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
        print(f"[dryrun] wrote {len(records)} records -> {args.out}", flush=True)
    if failed:
        print(f"[dryrun] {failed} FAILURES", flush=True)
    return 1 if failed else 0


def _gb(n):
    return "-" if n is None else f"{n/2**30:.2f}GiB"


if __name__ == "__main__":
    sys.exit(main())
