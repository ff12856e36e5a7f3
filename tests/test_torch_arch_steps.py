"""The port's train step == the reference's jitted step on the MoE, MLA, Mamba and RWKV-6 archs.

deepseek-v2-lite-16b, llama4-maverick-400b-a17b, jamba-1.5-large-398b and
rwkv6-1.6b at reduced sizes that keep their kinds
(``test_torch_blocks.PATTERNS``), float32: both packages start from the
reference's ``init_state`` (carried over with ``models.convert``) and take
3 steps on the same seeded numpy batches, with AdamW and with Adafactor
(its statistics over the reference's stacked groups, the expert banks
[L, E, D, F] among them), at lr 1e-4, with the MoE's capacity drops.  As
in ``test_torch_train_steps.py``: loss, grad_norm and lr within 1e-5
relative, and every parameter and optimizer leaf within 1e-4 of its
largest value (Adam moves an element whose gradient is near zero by up to
2 x lr whichever way summation order tips it, ROADMAP §3).

One leaf carries no signal: llama4's top-1 router.  Its one gate is
renormalised to 1, so its gradient is zero in exact arithmetic and both
packages' gradients are float noise (near 1e-10 against 1e-2 elsewhere),
different noise.  Its optimizer moments are held to be that noise in both
packages (below ``NOISE``), and its parameter to each package's move from
the initial value staying within 10 x the summed learning rate (Adafactor
normalises the noise into steps of about lr; AdamW's eps keeps them far
smaller, and its router still equals the reference's to 1e-4).

Then one MoE train step sharded on a (2, 2) mesh, 4 gloo CPU ranks
(``test_torch_train_dist.py``'s ranks and checks), top-2 routing,
against one device:
the MoE routes in two groups there (one per data shard) and in one on a
single device, so the two agree where no token is dropped
(``capacity_factor = E/k``, C >= Tg).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.models import init_params as jax_init
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.models.convert import state_from_numpy, state_to_numpy
from repro_torch.train.train_step import make_train_step
from repro_torch.tree import flatten_with_names

from test_torch_blocks import PATTERNS, configs, no_drops
from test_torch_train import F32_TOL, _smoke_batch, _to_jax, _to_torch
from test_torch_train_dist import check_sharded, run_ranks

LR = 1e-4
LEAF_TOL = 1e-4  # of each leaf's largest value (module docstring)
NOISE = 1e-8  # the top-1 router's moments in both packages (module docstring)
_JAX_STEPS = {}


def _leaf_close(got, want, noise=(), skip=()):
    """Every leaf within LEAF_TOL of its largest value; a leaf whose path
    ends in one of ``noise`` is checked to be float noise in both trees,
    one in ``skip`` is left to the caller."""
    want = dict(flatten_with_names(want))
    for name, g in flatten_with_names(got):
        g, w = np.asarray(g, np.float64), np.asarray(want.pop(name), np.float64)
        if name in skip:
            continue
        if name.endswith(noise):
            assert max(np.abs(g).max(), np.abs(w).max()) < NOISE, name
            continue
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=LEAF_TOL * float(np.abs(w).max(initial=0.0)),
                                   err_msg=name)
    assert not want


def _top1_routers(cfg) -> list[str]:
    """The reference paths of the routers of a top-1 MoE (module docstring)."""
    if cfg.moe is None or cfg.moe.top_k != 1:
        return []
    return [f"blocks/{u}/ffn/router" for u, (_m, f) in enumerate(cfg.scan_unit) if f == "moe"]


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", list(PATTERNS))
def test_train_step_equals_reference(arch, opt):
    jcfg, cfg = configs(arch)
    j_init_state, j_step = jax_make_train_step(jcfg, opt, 1, LR, warmup=1, total_steps=10)
    if (arch, opt) not in _JAX_STEPS:
        _JAX_STEPS[arch, opt] = jax.jit(j_step)
    jstate = j_init_state(jax_init(jax.random.key(0), jcfg))
    start = dict(flatten_with_names(jax.tree.map(np.asarray, jstate["params"])))
    _init_state, step = make_train_step(cfg, opt, 1, LR, warmup=1, total_steps=10)
    state = state_from_numpy(jax.tree.map(np.asarray, jstate), cfg, "cpu")
    rng = np.random.default_rng(11)
    lrs = []
    for _ in range(3):
        batch = _smoke_batch(cfg, rng)
        jstate, jm = _JAX_STEPS[arch, opt](jstate, _to_jax(batch, jax.numpy.float32))
        state, m = step(state, _to_torch(batch, torch.float32))
        for k in ("loss", "grad_norm", "lr"):
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=F32_TOL, abs=1e-12), k
        lrs.append(float(jm["lr"]))
    got, want = state_to_numpy(state), jax.tree.map(np.asarray, jstate)
    assert int(got["step"]) == int(want["step"]) == 3
    routers = _top1_routers(cfg)
    noise = tuple(r + s for r in routers for s in ("", "/vr", "/vc"))
    _leaf_close(got["opt"], want["opt"], noise=noise)
    if opt == "adafactor":  # the noise becomes steps of about lr (module docstring)
        for key in routers:
            for tree in (got, want):
                moved = np.abs(dict(flatten_with_names(tree["params"]))[key] - start[key]).max()
                assert moved <= 10 * sum(lrs), (key, moved)
        _leaf_close(got["params"], want["params"], skip=routers)
    else:
        _leaf_close(got["params"], want["params"])


# --------------------------------------------------------------------------- #
# The MoE step on a (2, 2) mesh
# --------------------------------------------------------------------------- #

MOE_TRAIN = dict(batch=8, seq=16, lr=1e-4, warmup=1, steps=10, optimizer="adamw")


def moe_cfg():
    """llama4's dense + MoE period at test_torch_train_dist's widths with
    top-2 routing (a top-1 router learns from float noise only, module
    docstring), no drops."""
    cfg = configs("llama4-maverick-400b-a17b", d_model=64, vocab=128, n_heads=4,
                  n_kv_heads=2)[1]
    return no_drops(dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, top_k=2)))


def moe_job(shape, device_type):
    """Two sharded steps of ``moe_cfg`` on mesh ``shape``; what each rank reports."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.dist import ctx as shard_ctx
    from repro_torch.launch import train as launcher

    mesh = DeviceMesh(device_type, torch.arange(dist.get_world_size()).reshape(shape),
                      mesh_dim_names=("data", "model"))
    with shard_ctx.use(mesh):
        groups = shard_ctx.moe_groups(MOE_TRAIN["batch"] * MOE_TRAIN["seq"],
                                      moe_cfg().moe.num_experts)
    run = launcher.pieces(moe_cfg(), **MOE_TRAIN, device=device_type, mesh=mesh)
    step, state = run.make_step(), run.fresh_state()
    metrics = []
    for s in range(2):
        state, m = step(state, run.next_batch(s))
        metrics.append({k: launcher.value(v) for k, v in m.items()})
    placed = {n: tuple(p.placements) for n, p in state["params"].named_parameters()}
    return {"metrics": metrics, "saved": state_to_numpy(state), "groups": groups,
            "placed": placed, "restored_placed": {}, "want_placements": {},
            "extra": {"next_step": 2}, "restore_err": 0.0}


def test_moe_step_on_a_2x2_mesh_equals_one_device(tmp_path):
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch import train as launcher

    run = launcher.pieces(moe_cfg(), **MOE_TRAIN, device="cpu")
    step, state = run.make_step(), run.fresh_state()
    want = []
    for s in range(2):
        state, m = step(state, run.next_batch(s))
        want.append({k: float(v) for k, v in m.items()})
    results = run_ranks(4, "gloo", moe_job, ((2, 2), "cpu"), tmp_path / "ranks")
    check_sharded(results, want, state_to_numpy(state))
    assert results[0]["groups"] == 2  # one routing group per data shard
    # the rules shard the expert bank [E, D, F] over "model" on its longest
    # axis (F), as the reference's do; the activations' experts go over
    # "model" by the constraint (dist.ctx.constrain_experts)
    assert results[0]["placed"]["blocks.1.ffn.w_gate"] == (Replicate(), Shard(2))
