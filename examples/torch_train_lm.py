"""End-to-end training on the PyTorch/CUDA port: train a reduced
SmolLM for a few hundred steps with checkpointing and a simulated mid-run
crash + automatic recovery.

    PYTHONPATH=src python examples/torch_train_lm.py [--device cpu]

The counterpart of ``examples/train_lm.py`` on ``repro_torch``: the same
config, data pipeline, optimizer and schedule, through
``launch.train.pieces`` and ``train.fault.run_supervised``, which restores
the last checkpoint after the crash and replays from there.
``TRAIN_STEPS`` (default 200) sets the run's length; a checkpoint is kept
every 25 steps, or every quarter of a shorter run.
"""
import argparse
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.train import pieces  # noqa: E402
from repro_torch.train.fault import run_supervised  # noqa: E402

STEPS = int(os.environ.get("TRAIN_STEPS", "200"))
CRASH_AT = STEPS // 2
CKPT_EVERY = max(1, min(25, STEPS // 4))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg = get_config("smollm-135m").reduced()
    run = pieces(cfg, batch=8, seq=128, seed=0, lr=3e-3, warmup=20, steps=STEPS,
                 optimizer="adamw", device=args.device)
    ckpt_dir = tempfile.mkdtemp(prefix="train_lm_ckpt_")
    crashed = {"done": False}
    losses = []

    def make_step():
        train_step = run.make_step()

        def step(state, batch):
            step_no = int(state["step"])
            if step_no == CRASH_AT and not crashed["done"]:
                crashed["done"] = True
                raise RuntimeError("simulated host preemption")
            return train_step(state, batch)

        return step

    try:
        report = run_supervised(
            total_steps=STEPS,
            make_step=make_step,
            init_state=run.fresh_state,
            next_batch=run.next_batch,
            ckpt_dir=ckpt_dir,
            checkpoint_every=CKPT_EVERY,
            on_metrics=lambda s, m: (
                losses.append(float(m["loss"])),
                print(f"step {s:4d} loss {float(m['loss']):.4f}", flush=True)
                if s % 20 == 0 else None,
            ),
        )
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    print(
        f"\nfinished {report.final_step} steps; "
        f"recovered from {report.failures_recovered} failure(s) "
        f"(simulated crash at step {CRASH_AT})"
    )
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f}")
    if report.failures_recovered < 1:
        raise SystemExit("the simulated crash must be recovered")
    if not losses[-1] < losses[0]:
        raise SystemExit("training must make progress")
    print("OK")


if __name__ == "__main__":
    main()
