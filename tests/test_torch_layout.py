"""The sharded step's explicit layout (``repro_torch.dist.local``), on the CPU.

* Per-device share: a reduced train step traced on fake meshes (2, 4) and
  ("pod", "data", "model") = (2, 2, 2), at 1 and 2 microbatches, for a
  config whose heads "model" divides (reduced SmolLM, 4 heads, 2 KV heads:
  the heads route, its KV heads or its columns of each KV head) and one
  whose heads it does not (3 heads: the positions route).  The ranks'
  matrix-product FLOPs together are at most 1.05 x one device's (they are
  equal: each rank computes its share).
* Adafactor on a (1, 4) fake mesh with 6 layers, more than the "model"
  ranks: no all-gather in the op table is larger than one layer's largest
  parameter in float32 (the update runs layer by layer on local shards).
* Real gloo ranks: two steps of the reduced config on meshes (2, 2) and (1,
  4), AdamW and Adafactor, each attention route, equal to one device's
  (``test_torch_train_dist.py``'s tolerances); the parameters keep the
  layout ``param_specs`` gives them.
* The collectives on local tensors against their definitions, on 4 gloo
  ranks; ``local.full`` on 8 gloo ranks, mesh ("pod", "data", "model") =
  (2, 2, 2), of a known tensor sharded on two or three mesh dims (axis 0
  over two of them: the pod-major order) or partial over "pod", against
  the tensor and DTensor's own ``full_tensor``.
"""
import math

import numpy as np
import numpy.testing as npt
import pytest
import torch
import torch.distributed as dist
from test_torch_dist import run_ranks
from test_torch_dryrun import TINY, _matmul_flops
from test_torch_train_dist import SHARDED_TOL, TRAIN
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

from repro_torch.configs import SHAPES, get_config
from repro_torch.dist import local
from repro_torch.dist import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.launch import train as launcher
from repro_torch.models.convert import state_to_numpy
from repro_torch.tree import flatten_with_names

ROUTES = {  # reduced SmolLM, one layer: heads "model" divides, and not
    "heads": dict(n_layers=1),
    "positions": dict(n_layers=1, n_heads=3, n_kv_heads=1),
}


def _names(shape):
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")


@pytest.fixture
def fake_world(monkeypatch):
    for name, cell in TINY.items():
        monkeypatch.setitem(SHAPES, name, cell)
    yield dryrun.fake_group
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("mb", [1, 2])
@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("mesh_shape", [(2, 4), (2, 2, 2)])
def test_each_rank_computes_its_share(fake_world, mesh_shape, route, mb):
    cfg = get_config("smollm-135m").reduced(**ROUTES[route])
    one = dryrun.lower_step(cfg, "tiny_train", None, mb, device="cpu")
    n = math.prod(mesh_shape)
    fake_world(n)
    mesh = DeviceMesh("cpu", torch.arange(n).reshape(mesh_shape),
                      mesh_dim_names=_names(mesh_shape))
    trace = dryrun.lower_step(cfg, "tiny_train", mesh, mb, device="cpu")
    assert _matmul_flops(one) > 0
    assert n * _matmul_flops(trace) <= 1.05 * _matmul_flops(one)
    assert trace.costs["collective_bytes"] > 0


def test_adafactor_gathers_no_stacked_group(fake_world, monkeypatch):
    cfg = get_config("smollm-135m").reduced(n_layers=6)
    monkeypatch.setattr(dryrun, "pick_optimizer", lambda cfg: "adafactor")
    fake_world(4)
    mesh = DeviceMesh("cpu", torch.arange(4).reshape(1, 4), mesh_dim_names=("data", "model"))
    table = dryrun.lower_step(cfg, "tiny_train", mesh, 1, device="cpu").counter.table
    layer = max(p.numel() * 4 for n, p in dryrun.Model(cfg, "meta").named_parameters()
                if n.startswith("blocks."))
    gathers = [row for op, row in table.items() if "all_gather" in op]
    assert gathers and all(row["max_result_bytes"] <= layer for row in gathers), gathers


# --------------------------------------------------------------------------- #
# Real ranks
# --------------------------------------------------------------------------- #

STEP_CASES = [(shape, opt, route) for shape in [(2, 2), (1, 4)]
              for opt in ("adamw", "adafactor") for route in ("heads", "positions")]
CFG = {  # the remat policies recompute the collectives in the backward pass
    "heads": dict(n_heads=4, n_kv_heads=2, remat_policy="dots"),
    "positions": dict(n_heads=3, n_kv_heads=1, remat_policy="full"),
}


def small_cfg(route):
    """``test_torch_train_dist.small_cfg``'s widths, float32, the route's heads."""
    return get_config("smollm-135m").reduced(n_layers=2, d_model=64, vocab=128,
                                             dtype="float32", **CFG[route])


def _two_steps(cfg, opt, mesh=None):
    run = launcher.pieces(cfg, **dict(TRAIN, optimizer=opt), device="cpu", mesh=mesh)
    step, state = run.make_step(), run.fresh_state()
    metrics = []
    for s in range(2):
        state, m = step(state, run.next_batch(s))
        metrics.append({k: launcher.value(v) for k, v in m.items()})
    return metrics, state


def collectives():
    """Each collective of ``dist.local`` on this rank's numbers."""
    group = dist.group.WORLD
    n, r = group.size(), group.rank()
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * r
    return {
        "all_reduce": local.all_reduce(x, group),
        "max": local.all_reduce(x, group, "max"),
        "all_gather_1": local.all_gather(x, 1, group),
        "reduce_scatter_1": local.reduce_scatter(torch.ones(2, 4 * n) * (r + 1), 1, group),
        "all_to_all": local.all_to_all(torch.arange(2 * n * 3).reshape(2 * n, 3) + 100 * r,
                                       0, 1, group),
    }


def layout_job(cases):
    """The collectives, then each case's two steps on its mesh: the metrics,
    whether every parameter kept its ``param_specs`` layout, and on rank 0
    the state as numpy."""
    torch.set_num_threads(1)  # four ranks share the host's cores
    steps = []
    for shape, opt, route in cases:
        mesh = DeviceMesh("cpu", torch.arange(dist.get_world_size()).reshape(shape),
                          mesh_dim_names=_names(shape))
        metrics, state = _two_steps(small_cfg(route), opt, mesh)
        specs = shd.param_specs(state["params"], mesh)
        kept = all(tuple(p.placements) == specs[n]
                   for n, p in state["params"].named_parameters())
        saved = state_to_numpy(state)
        steps.append({"metrics": metrics, "kept": kept,
                      "saved": saved if dist.get_rank() == 0 else None})
    return {"collectives": collectives(), "steps": steps}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(4, "gloo", layout_job, (STEP_CASES,), tmp_path_factory.mktemp("layout_ranks"))


@pytest.mark.parametrize("case", range(len(STEP_CASES)),
                         ids=[f"{s[0]}x{s[1]}-{o}-{r}" for s, o, r in STEP_CASES])
def test_sharded_steps_equal_one_device(ranks, case):
    _shape, opt, route = STEP_CASES[case]
    want_metrics, state = _two_steps(small_cfg(route), opt)
    want = state_to_numpy(state)
    for rank in ranks:
        res = rank["steps"][case]
        assert res["kept"]
        for got, w in zip(res["metrics"], want_metrics):
            for k in ("loss", "grad_norm", "lr"):
                assert got[k] == pytest.approx(w[k], rel=SHARDED_TOL), (k, got, w)
    for (name, got), (_n, w) in zip(flatten_with_names(ranks[0]["steps"][case]["saved"]),
                                    flatten_with_names(want)):
        w = np.asarray(w, np.float64)
        npt.assert_allclose(np.asarray(got, np.float64), w, rtol=0,
                            atol=SHARDED_TOL * float(np.abs(w).max(initial=0.0)), err_msg=name)


def test_collectives_on_local_tensors(ranks):
    xs = [torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * r for r in range(4)]
    for r, rank in enumerate(ranks):
        res = rank["collectives"]
        torch.testing.assert_close(res["all_reduce"], sum(xs))
        torch.testing.assert_close(res["max"], xs[-1])
        torch.testing.assert_close(res["all_gather_1"], torch.cat(xs, 1))
        torch.testing.assert_close(res["reduce_scatter_1"], torch.full((2, 4), 10.0))
        # rank r's part of axis 0 of every rank's piece, joined along axis 1
        pieces = [torch.arange(24).reshape(8, 3)[2 * r:2 * r + 2] + 100 * q for q in range(4)]
        torch.testing.assert_close(res["all_to_all"], torch.cat(pieces, 1))


FULL_CASES = {  # placements on ("pod", "data", "model"); axis 0 of 8, axis 1 of 12
    "rows_pod_data": (Shard(0), Shard(0), Replicate()),
    "rows_pod_model": (Shard(0), Replicate(), Shard(0)),
    "rows_data_model": (Replicate(), Shard(0), Shard(0)),
    "rows_all": (Shard(0), Shard(0), Shard(0)),
    "rows_pod_model_cols_data": (Shard(0), Shard(1), Shard(0)),
    "partial_pod": (Partial(), Shard(0), Shard(1)),
}
KNOWN = torch.arange(96, dtype=torch.float32).reshape(8, 12)


def full_job():
    """``local.full`` and ``full_tensor`` of ``KNOWN`` under each of
    ``FULL_CASES`` (a partial one holds half of its pieces on each pod)."""
    mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 2, 2),
                      mesh_dim_names=("pod", "data", "model"))
    out = {}
    for name, placements in FULL_CASES.items():
        if placements[0].is_partial():
            held = distribute_tensor(KNOWN / 2, mesh, (Replicate(), *placements[1:]),
                                     src_data_rank=None)
            t = DTensor.from_local(held.to_local(), mesh, placements)
        else:
            t = distribute_tensor(KNOWN, mesh, placements, src_data_rank=None)
        out[name] = {"local": local.full(t), "dtensor": t.full_tensor()}
    return out


@pytest.fixture(scope="module")
def full_ranks(tmp_path_factory):
    return run_ranks(8, "gloo", full_job, (), tmp_path_factory.mktemp("full_ranks"))


@pytest.mark.parametrize("case", list(FULL_CASES))
def test_full_gathers_a_222_mesh_in_order(full_ranks, case):
    for rank in full_ranks:
        torch.testing.assert_close(rank[case]["local"], KNOWN, rtol=0, atol=0)
        torch.testing.assert_close(rank[case]["dtensor"], KNOWN, rtol=0, atol=0)
