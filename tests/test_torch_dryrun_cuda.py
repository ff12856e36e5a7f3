"""The registered ops and the dry-run's predictions, on the card.

* ``repro_torch::decode_attention`` and ``repro_torch::searchsorted`` on
  CUDA tensors equal a direct launch of their kernels (``_launch``, the
  wrappers' path before the ops existed) bit for bit, and each op call
  counts one launch in ``LAUNCHES``.
* The dry-run's one-device trace of a step (``launch/dryrun.py::lower_step``
  on fake ``"cuda"`` tensors) against the same step run on the card at
  reduced widths: FLOPs equal ``FlopCounterMode``'s exactly, and the
  predicted bytes above the arguments are within 25% of
  ``torch.cuda.max_memory_allocated()`` above what was allocated before the
  step (the caching allocator rounds each block up to 512 bytes).

Runs only where a CUDA device is present; on a host without one every test
here skips.  Imports nothing of the JAX package:

    PYTHONPATH=src python -m pytest -q tests/test_torch_dryrun_cuda.py
"""
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.registry import ShapeCell
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import searchsorted as ss
from repro_torch.launch import dryrun
from repro_torch.models import decode_step, init_cache, init_params, prefill
from repro_torch.train.train_step import make_train_step

MEMORY_TOL = 0.25
CELLS = {
    "cuda_prefill": ShapeCell("cuda_prefill", 256, 8, "prefill"),
    "cuda_decode": ShapeCell("cuda_decode", 256, 8, "decode"),
    "cuda_train": ShapeCell("cuda_train", 256, 8, "train"),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels and the measured step run on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_op_equals_a_direct_launch(cuda, dtype):
    rng = np.random.default_rng(3)
    b, t, h, hk, hd = 4, 1088, 9, 3, 64
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(cuda, dtype)
               for s in ((b, h, hd), (b, t, hk, hd), (b, t, hk, hd)))
    lens = torch.tensor([1, 500, 1087, 1088], dtype=torch.int32, device=cuda)
    before = da.LAUNCHES
    got = da.decode_attention(q, k, v, lens)
    assert da.LAUNCHES == before + 1
    want = da._launch(q, k, v, lens)
    assert da.LAUNCHES == before + 2
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(da.OP(q, k, v, lens), want)


def test_searchsorted_op_equals_a_direct_launch(cuda):
    rng = np.random.default_rng(4)
    a = torch.from_numpy(np.sort(rng.integers(0, 10**6, size=(6, 5000)), axis=1)
                         .astype(np.int32)).to(cuda)
    q = torch.from_numpy(rng.integers(0, 10**6, size=(6, 700)).astype(np.int32)).to(cuda)
    before = ss.LAUNCHES
    got = ss.searchsorted(a, q)
    assert ss.LAUNCHES == before + 1
    want = ss._launch(a, q)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, ss.searchsorted_plain(a, q))


def _step(kind: str, model, cfg, cell, dev):
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, size=(cell.global_batch, cell.seq_len),
                                           dtype=np.int32)).to(dev)
    if kind == "train":
        init_state, train_step = make_train_step(cfg, optimizer="adamw")
        return train_step, (init_state(model), {"tokens": tokens})
    cache = init_cache(cfg, cell.global_batch, cell.seq_len, dev)
    if kind == "prefill":
        return (lambda m, t, c: prefill(m, cfg, t, c)), (model, tokens, cache)
    for layer in cache:
        layer["len"] = cell.seq_len - 1
    return ((lambda m, t, c: decode_step(m, cfg, t, c, cell.seq_len - 1)),
            (model, tokens[:, :1].contiguous(), cache))


@pytest.mark.parametrize("name", list(CELLS))
def test_trace_predicts_flops_and_memory_of_a_step_on_the_card(cuda, monkeypatch, name):
    monkeypatch.setitem(SHAPES, name, CELLS[name])
    cfg = get_config("smollm-135m").reduced(n_layers=4, vocab=16384)
    trace = dryrun.lower_step(cfg, name, None, 1, device="cuda")
    model = init_params(0, cfg, cuda)
    fn, args = _step(CELLS[name].kind, model, cfg, CELLS[name], cuda)
    fn(*args)  # warm: cuBLAS workspaces exist before the count
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated() - base
    assert trace.costs["flops"] == fc.get_total_flops() > 0
    predicted = trace.memory["temp_bytes"]
    assert abs(predicted - measured) <= MEMORY_TOL * measured, (predicted, measured)
