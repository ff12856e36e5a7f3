"""The port's seven examples (``examples/torch_*.py``) run on the CPU.

Each example runs with ``--device cpu`` at a toy size in a subprocess of its
own, all seven at once (``run_examples``: the slowest sets the file's
time), through a runner that records which modules the example imported:
neither ``jax`` nor the JAX package ``repro`` may be among them.  Each case
checks the exit code and the example's key lines: every backend's ids equal
to ``scalar``, the edge cache's ``cached=False -> True`` after a republish,
the training loss falling after the simulated crash and its restore.  Each
subprocess leads a process group of its own, killed whole when it ends,
so no shard process outlives its case.

``tests/test_torch_examples_cuda.py`` runs them on the card.
"""
import os
import re
import signal
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 240  # seconds an example may take here (the slowest takes ~40 s alone)

# the runner: the example as __main__, then the foreign modules it imported
RUNNER = """
import runpy, sys
path = sys.argv[1]
sys.argv = sys.argv[1:]
try:
    runpy.run_path(path, run_name="__main__")
finally:
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
    print("FOREIGN_MODULES", foreign, flush=True)
"""

# example -> arguments at a toy size on the CPU
CPU_ARGS = {
    "quickstart": [],
    "search_discogs": ["--releases", "60", "--repeats", "1"],
    "serve_index": ["--releases", "60"],
    "serve_cluster": ["60", "2", "thread"],
    "serve_gateway": ["60", "2", "2"],
    "serve_lm": ["--reduced"],
    "train_lm": [],
}
TRAIN_STEPS = 12  # the training example's run: crash at 6, a checkpoint every 3


def start(name: str, args: list[str], device: str, steps: int = TRAIN_STEPS) -> subprocess.Popen:
    # two threads each: the seven share the host's cores
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), TRAIN_STEPS=str(steps),
               OMP_NUM_THREADS="2")
    return subprocess.Popen(
        [sys.executable, "-c", RUNNER, str(ROOT / "examples" / f"torch_{name}.py"), *args,
         "--device", device],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)


def finish(proc: subprocess.Popen, timeout: float) -> tuple[int | None, str]:
    """(exit code, or None at the timeout; its output); the process group
    is killed either way."""
    try:
        out, _ = proc.communicate(timeout=timeout)
        rc = proc.returncode
    except subprocess.TimeoutExpired:
        rc, out = None, ""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    if rc is None:
        out, _ = proc.communicate()
    return rc, out


def run_examples(cases: dict, device: str, timeout: float, steps: int = TRAIN_STEPS) -> dict:
    procs = {name: start(name, args, device, steps) for name, args in cases.items()}
    return {name: finish(proc, timeout) for name, proc in procs.items()}


def check(name: str, rc, out: str) -> None:
    """The exit code, no foreign module, and ``name``'s key lines."""
    assert rc == 0, f"torch_{name} exited {rc}:\n{out[-4000:]}"
    assert "FOREIGN_MODULES []" in out, out[-2000:]
    CHECKS[name](out)


def _quickstart(out):
    for sem in ("slca", "elca"):
        ids = set(re.findall(rf"^  {sem} .*-> nodes (\[.*\])$", out, re.M))
        assert len(ids) == 1, (sem, ids)  # every index and backend alike
        assert len(re.findall(rf"^  {sem} ", out, re.M)) == 2 * 4
    assert "DAG nodes:" in out


def _search_discogs(out):
    assert "fused and chained == scalar on both indices for all 9 queries" in out
    assert len(re.findall(r"^Q\d ", out, re.M)) == 9


def _serve_index(out):
    assert re.search(r"^warm: 9 queries in .* plan hit-rate", out, re.M)
    assert len(re.findall(r"^  Q\d .* results$", out, re.M)) == 9


def _serve_cluster(out):
    assert len(re.findall(r"^  Q\d (slca|elca) == ", out, re.M)) == 18
    assert "!!" not in out
    assert re.search(r"rolling republish: generations=\[1(, 1)*\], post-swap ==", out)


def _serve_gateway(out):
    assert len(re.findall(r"^  Q\d slca == ", out, re.M)) == 4
    assert "edge cache: first cached=False, repeat cached=True" in out
    assert "killed replica: 0 client-visible errors" in out
    assert "repeat cached=False -> re-cached=True" in out


def _serve_lm(out):
    assert "prefix-DAG savings:" in out
    assert re.search(r"^prefill: 8×64 tokens", out, re.M)
    assert re.search(r"^decode: 11 steps × 8 seqs -> [\d.]+ tok/s", out, re.M)


def _train_lm(out):
    assert "recovered from 1 failure(s)" in out
    first, last = map(float, re.search(r"^loss: ([\d.]+) -> ([\d.]+)$", out, re.M).groups())
    assert last < first
    assert out.rstrip().splitlines()[-2] == "OK"


CHECKS = {"quickstart": _quickstart, "search_discogs": _search_discogs,
          "serve_index": _serve_index, "serve_cluster": _serve_cluster,
          "serve_gateway": _serve_gateway, "serve_lm": _serve_lm, "train_lm": _train_lm}


@pytest.fixture(scope="module")
def cpu_runs():
    return run_examples(CPU_ARGS, "cpu", TIMEOUT)


@pytest.mark.parametrize("name", list(CPU_ARGS))
def test_example_runs_on_the_cpu(cpu_runs, name):
    check(name, *cpu_runs[name])
