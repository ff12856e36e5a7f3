"""The port's seven examples (``examples/torch_*.py``) on the card.

Runs only where a CUDA device is present; on a host without one every test
here skips.  Each example runs with its default ``--device cuda``, at the
sizes below (``torch_serve_lm`` serves SmolLM-135M at its published widths,
its decode steps through the ``decode_attention`` kernel; the search
examples run the ``fused`` and ``chained`` kernels), all seven at once, and
is checked as ``test_torch_examples.py`` checks it on the CPU.  Imports
nothing of the JAX package:

    PYTHONPATH=src python -m pytest -q tests/test_torch_examples_cuda.py
"""
import pytest
import torch
from test_torch_examples import check, run_examples

CUDA_ARGS = {
    "quickstart": [],
    "search_discogs": ["--releases", "2000", "--repeats", "2"],
    "serve_index": ["--releases", "200"],
    "serve_cluster": ["200", "4", "process"],
    "serve_gateway": ["120", "2", "2"],
    "serve_lm": [],
    "train_lm": [],
}
TRAIN_STEPS = 100  # crash at 50, a checkpoint every 25


@pytest.fixture(scope="module")
def cuda_runs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the examples run their kernels on the card")
    return run_examples(CUDA_ARGS, "cuda", 600, TRAIN_STEPS)


@pytest.mark.parametrize("name", list(CUDA_ARGS))
def test_example_runs_on_the_card(cuda_runs, name):
    check(name, *cuda_runs[name])
