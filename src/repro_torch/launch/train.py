"""Training driver: fault-tolerant LM training on the card, or on a mesh of ranks.

The port of ``repro.launch.train``, with the same flags and prints plus
``--device`` (default ``cuda``; it raises without CUDA unless ``--device
cpu`` is given).  Started alone it trains on one device with no mesh (the
reference's one-device mesh gives every leaf a replicated spec, which is the
same thing).  Started by ``torchrun`` (``WORLD_SIZE`` > 1 in the
environment) it starts the process group, NCCL on the card and gloo on the
CPU, and trains on ``launch.mesh.make_host_mesh()``: the state placed by
``dist.sharding.param_specs``, each batch by ``data_specs``, the step run
under ``dist.ctx.use(mesh)``, laid out by ``dist/local.py``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --reduced --steps 200 --batch 8 --seq 128 --ckpt-dir /path/to/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu

``pieces`` builds what ``main`` hands to ``train.fault.run_supervised``
(``make_step``, ``fresh_state``, ``next_batch``), for callers that drive
training themselves (``chip_smoke.py``).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from collections.abc import Callable
from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.api import resolve_device
from repro_torch.configs import get_config
from repro_torch.data.pipeline import PipelineConfig, global_batch
from repro_torch.dist import ctx as shard_ctx
from repro_torch.dist import local
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import make_host_mesh, rank_device
from repro_torch.models import ModelConfig, init_params
from repro_torch.train.fault import run_supervised
from repro_torch.train.optimizer import pick_optimizer
from repro_torch.train.train_step import make_train_step


class Pieces(NamedTuple):
    make_step: Callable[[], Callable]
    fresh_state: Callable[[], dict]
    next_batch: Callable[[int], dict]


def value(t) -> float:
    """A 0-d metric as a float (a DTensor gathered first)."""
    return float(local.full(t))


def pieces(cfg: ModelConfig, *, batch: int, seq: int, seed: int = 0, lr: float = 3e-4,
           steps: int = 100, warmup: int = 100, microbatches: int = 1,
           optimizer: str | None = None, device="cuda", mesh=None) -> Pieces:
    """The train step, the fresh state and the batches of one run (``main``
    uses the reference's warmup of 100 steps; a short run lowers it).

    Without a mesh everything lies on ``device``.  With a mesh (a process
    group started, one mesh per rank) on this rank's device, and the step
    places the state and each batch on the mesh before it runs."""
    dev = resolve_device(device) if mesh is None else rank_device(mesh.device_type)
    pipe = PipelineConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=seed)
    init_state, train_step = make_train_step(
        cfg,
        optimizer=optimizer or pick_optimizer(cfg),
        microbatches=microbatches,
        base_lr=lr,
        warmup=warmup,
        total_steps=steps,
    )

    def make_step():
        if mesh is None:
            return train_step

        def step(state, batch):
            with shard_ctx.use(mesh):
                state = shd.to_named(state, shd.param_specs(state, mesh), mesh)
                batch = shd.to_named(batch, shd.data_specs(batch, mesh), mesh)
                return train_step(state, batch)

        return step

    def fresh_state():
        return init_state(init_params(seed, cfg, dev))

    def next_batch(step: int):
        return {"tokens": torch.as_tensor(global_batch(pipe, step)["tokens"], device=dev)}

    return Pieces(make_step, fresh_state, next_batch)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    started = int(os.environ.get("WORLD_SIZE", "1")) > 1 and not dist.is_initialized()
    if started:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    try:
        mesh = make_host_mesh(device_type=dev.type) if dist.is_initialized() else None
        run = pieces(cfg, batch=args.batch, seq=args.seq, seed=args.seed, lr=args.lr,
                     steps=args.steps, microbatches=args.microbatches, device=dev, mesh=mesh)
        losses = []

        def on_metrics(step, metrics):
            if step % args.log_every == 0:
                loss = value(metrics["loss"])
                losses.append(loss)
                print(
                    f"step {step:5d} loss {loss:.4f} "
                    f"gnorm {value(metrics['grad_norm']):.3f} "
                    f"lr {value(metrics['lr']):.2e}",
                    flush=True,
                )

        t0 = time.time()
        report = run_supervised(
            total_steps=args.steps,
            make_step=run.make_step,
            init_state=run.fresh_state,
            next_batch=run.next_batch,
            ckpt_dir=args.ckpt_dir,
            checkpoint_every=args.ckpt_every,
            on_metrics=on_metrics,
        )
        dt = time.time() - t0
    finally:
        if started:
            dist.destroy_process_group()
    tokens = args.steps * args.batch * args.seq
    print(
        f"done: {report.steps_run} steps, {report.failures_recovered} recoveries, "
        f"{report.stragglers_detected} stragglers, {tokens/dt:.0f} tok/s",
        flush=True,
    )
    if len(losses) >= 2 and losses[-1] >= losses[0]:
        print("WARNING: loss did not decrease", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
