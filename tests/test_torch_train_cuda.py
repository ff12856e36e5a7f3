"""Training on the card: one step == the same step on the CPU; the sharded step.

* Two AdamW steps (the second with lr 1e-4 > 0) at SmolLM-135M's widths
  cut to 2 layers (batch 2 x 128, float32) on ``cuda`` and on the CPU from
  the same state: loss, grad_norm and lr within 1e-4 relative, each
  parameter and moment leaf to 1e-4 of its largest value (float32 on both;
  the card's matrix products sum in another order, and TF32 stays off,
  PyTorch's default for float32 matmuls; the small rate keeps Adam's step
  on a near-zero gradient, which another summation order moves, inside it).
* The sharded step of ``test_torch_train_dist.py`` on 4 gloo ranks sharing
  the card, mesh (4, 1) (data-parallel) and mesh (2, 2) (the explicit
  layout of ``dist/local.py``, heads over "model"), against the
  single-device step on the card, then the elastic restore of its
  checkpoint onto mesh (1, 4), every leaf sharded over "model", each
  rank's pieces checked on the rank.  Gloo's all-gather of CUDA tensors
  (DTensor's, or the functional collective's) kills a rank; DTensor's
  all-reduce, reduce-scatter and all-to-all take them, as a test here
  shows, and so do ``dist.local``'s collectives (its all-gather an
  all-to-all there) and ``dist.local.full``.
* ``python -m repro_torch.launch.train --reduced`` on the card.

Runs only where a CUDA device is present; on a host without one every test
here skips.  Imports nothing of the JAX package:

    PYTHONPATH=src python -m pytest -q tests/test_torch_train_cuda.py
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_torch_dist import run_ranks
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from test_torch_train_dist import check_sharded, single_device_steps, train_job

from repro_torch.configs import get_config
from repro_torch.data.pipeline import PipelineConfig, global_batch
from repro_torch.launch import train as launcher
from repro_torch.models import init_params
from repro_torch.models.convert import state_from_numpy, state_to_numpy
from repro_torch.train.train_step import make_train_step
from repro_torch.tree import flatten_with_names

CUDA_VS_CPU_TOL = 1e-4  # metrics relative; each leaf to 1e-4 of its largest value


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the train step runs on the card")


def test_train_step_on_the_card_equals_the_cpu(card):
    cfg = get_config("smollm-135m")
    cfg = cfg.reduced(n_layers=2, d_model=cfg.d_model, n_heads=cfg.n_heads,
                      n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim, d_ff=cfg.d_ff,
                      vocab=cfg.vocab, dtype="float32")
    init_state, step = make_train_step(cfg, "adamw", base_lr=1e-4, warmup=1, total_steps=10)
    tree = state_to_numpy(init_state(init_params(0, cfg, "cpu")))
    tokens = global_batch(PipelineConfig(vocab=cfg.vocab, seq_len=128, global_batch=2), 0)["tokens"]
    out = {}
    for dev in ("cuda", "cpu"):
        state = state_from_numpy(tree, cfg, dev)
        for _ in range(2):  # the second step has lr > 0
            state, m = step(state, {"tokens": torch.as_tensor(tokens, device=dev)})
        out[dev] = ({k: float(v) for k, v in m.items()}, state_to_numpy(state))
    (mc, sc), (mp, sp) = out["cuda"], out["cpu"]
    for k in mc:
        assert mc[k] == pytest.approx(mp[k], rel=CUDA_VS_CPU_TOL), k
    for (name, a), (_n, b) in zip(flatten_with_names(sc), flatten_with_names(sp)):
        np.testing.assert_allclose(a, b, rtol=0, atol=CUDA_VS_CPU_TOL * np.abs(b).max(initial=0.0),
                                   err_msg=name)


def test_sharded_step_four_gloo_ranks_share_the_card(card, tmp_path):
    results = run_ranks(4, "gloo", train_job, ((4, 1), (1, 4), "cuda", str(tmp_path / "ckpt")),
                        tmp_path / "ranks")
    check_sharded(results, *single_device_steps("cuda"))
    assert results[0]["restored_placed"]["embed.table"] == (Replicate(), Shard(0))


def test_sharded_step_on_mesh_2x2_shares_the_card(card, tmp_path):
    results = run_ranks(4, "gloo", train_job, ((2, 2), (1, 4), "cuda", str(tmp_path / "ckpt")),
                        tmp_path / "ranks")
    check_sharded(results, *single_device_steps("cuda"))
    assert results[0]["placed"]["blocks.0.mixer.wq"] == (Replicate(), Shard(0))


def _local_collectives_job():
    """``dist.local``'s collectives over the 4-rank world group, and
    ``full`` of a leaf sharded on both dims of mesh (2, 2), on CUDA
    tensors; the results on the host."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.dist import local

    torch.cuda.set_device(0)
    group, rank = dist.group.WORLD, dist.get_rank()
    x = torch.arange(6.0, device="cuda").reshape(2, 3) + 10 * rank
    mesh = DeviceMesh("cuda", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))
    leaf = distribute_tensor(torch.arange(16.0, device="cuda").reshape(4, 4), mesh,
                             (Shard(0), Shard(1)), src_data_rank=None)
    out = {
        "all_gather_1": local.all_gather(x, 1, group),
        "all_reduce": local.all_reduce(x, group),
        "reduce_scatter_1": local.reduce_scatter(
            torch.ones(2, 16, device="cuda") * (rank + 1), 1, group),
        "all_to_all": local.all_to_all(
            torch.arange(24.0, device="cuda").reshape(8, 3) + 100 * rank, 0, 1, group),
        "full": local.full(leaf),
    }
    return {k: v.cpu() for k, v in out.items()}


def test_local_collectives_take_cuda_tensors_under_gloo(card, tmp_path):
    out = run_ranks(4, "gloo", _local_collectives_job, (), tmp_path)
    xs = [torch.arange(6.0).reshape(2, 3) + 10 * r for r in range(4)]
    for r, got in enumerate(out):
        torch.testing.assert_close(got["all_gather_1"], torch.cat(xs, 1))
        torch.testing.assert_close(got["all_reduce"], sum(xs))
        torch.testing.assert_close(got["reduce_scatter_1"], torch.full((2, 4), 10.0))
        pieces = [torch.arange(24.0).reshape(8, 3)[2 * r:2 * r + 2] + 100 * q for q in range(4)]
        torch.testing.assert_close(got["all_to_all"], torch.cat(pieces, 1))
        torch.testing.assert_close(got["full"], torch.arange(16.0).reshape(4, 4))


def _collective_job(name):
    """One DTensor redistribution over the 4-rank world group (mesh (4, 1)'s
    "data" dim) on CUDA tensors; returns the local result."""
    mesh = DeviceMesh("cuda", torch.arange(4).reshape(4, 1), mesh_dim_names=("data", "model"))
    rank = dist.get_rank()
    local = torch.arange(8.0, device="cuda") + rank
    start, end = {
        "all_reduce": ((Partial(), Replicate()), (Replicate(), Replicate())),
        "reduce_scatter": ((Partial(), Replicate()), (Shard(0), Replicate())),
        "all_to_all": ((Shard(0), Replicate()), (Shard(1), Replicate())),
    }[name]
    if name == "all_to_all":
        local = local.reshape(2, 4)
    x = DTensor.from_local(local, mesh, start, run_check=False)
    return x.redistribute(mesh, end).to_local().cpu()


@pytest.mark.parametrize("name", ["all_reduce", "reduce_scatter", "all_to_all"])
def test_gloo_takes_cuda_tensors_over_the_world_group(card, tmp_path, name):
    """What the (4, 1) layout relies on: these DTensor collectives over a
    group of all 4 ranks take CUDA tensors under gloo.  Its all-gather
    (``Shard`` -> ``Replicate``) is not among them: a rank died of SIGSEGV
    in it on every try (PERF.md §6), which is why the sharded step
    runs data-parallel and its restore is checked piece by piece."""
    out = run_ranks(4, "gloo", _collective_job, (name,), tmp_path)
    full = torch.stack([torch.arange(8.0) + r for r in range(4)])
    want = {"all_reduce": [full.sum(0)] * 4, "reduce_scatter": list(full.sum(0).chunk(4)),
            "all_to_all": list(full.reshape(8, 4).chunk(4, dim=1))}[name]
    for got, w in zip(out, want):
        torch.testing.assert_close(got, w)


def test_launcher_trains_on_the_card(card, tmp_path, capsys):
    assert launcher.main(["--reduced", "--steps", "4", "--batch", "2", "--seq", "32",
                          "--log-every", "1", "--ckpt-dir", str(tmp_path)]) == 0
    assert "done: 4 steps, 0 recoveries" in capsys.readouterr().out
