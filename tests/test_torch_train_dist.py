"""The sharding rules and the sharded train step, on the CPU.

* ``param_specs`` / ``data_specs`` / ``cache_specs`` name the same tensor
  axis and mesh axes as the reference's ``PartitionSpec`` on meshes (4, 2),
  (2, 4), (1, 8), (8, 1) and (2, 2, 2) with a ``"pod"`` axis: on the same
  shapes, and on the port's train state against the reference's stacked
  one (a per-layer leaf's axis is the stacked leaf's less one).  The port's
  meshes are ``DeviceMesh``es over torch's ``"fake"`` process group in this
  process; the reference's are ``AbstractMesh``es (its rules read only the
  axis sizes).
* The reference test's sharded step (``tests/test_distributed.py``: reduced
  SmolLM, 2 layers, d_model 64, vocab 128, 4 / 2 heads, AdamW) on 8 gloo
  CPU ranks spawned by ``torch.multiprocessing``, mesh (4, 2), through the
  launcher's ``pieces``: two steps, held against the single-device step
  within 1e-4 (loss, grad_norm and lr relative; every parameter and moment
  leaf to 1e-4 of its largest value; float32 on both sides, the collectives
  sum in another order).  The
  reference's own sharded step fails under jax 0.9 (ROADMAP §3).  Then its
  checkpoint (rank 0 writes) restored onto mesh (2, 4): each rank's piece
  of every leaf equal to the same piece of the saved state, each leaf
  placed by ``param_specs`` on the new mesh.

``train_job`` and ``single_device_steps`` are shared with
``test_torch_train_cuda.py``; this module imports jax only inside the tests
that read the reference's rules.
"""
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_torch_dist import run_ranks
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro_torch.configs import get_config
from repro_torch.dist import local
from repro_torch.dist import sharding as shd
from repro_torch.launch import train as launcher
from repro_torch.models import init_cache, init_params
from repro_torch.models.convert import reference_groups, state_to_numpy
from repro_torch.train import checkpoint as ckpt
from repro_torch.tree import flatten_with_names

MESHES = [(4, 2), (2, 4), (1, 8), (8, 1), (2, 2, 2)]
SHARDED_TOL = 1e-4
# Adam divides each gradient by its own RMS, so on an element whose gradient
# is near zero another summation order moves the step by a share of the
# learning rate; at 1e-4 that stays well inside the tolerance
TRAIN = dict(batch=8, seq=32, lr=1e-4, warmup=1, steps=10, optimizer="adamw")


def small_cfg(dtype="float32", **kw):
    return get_config("smollm-135m").reduced(n_layers=2, d_model=64, vocab=128, n_heads=4,
                                             n_kv_heads=2, dtype=dtype, **kw)


def _names(shape):
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")


def _axes_of_placements(spec, mesh_names, ndim) -> list[tuple[str, ...]]:
    """Per tensor axis, the mesh axes that shard it (mesh order)."""
    out = [()] * ndim
    for name, p in zip(mesh_names, spec):
        if isinstance(p, Shard):
            out[p.dim] = out[p.dim] + (name,)
        else:
            assert isinstance(p, Replicate), p
    return out


def _axes_of_pspec(pspec, ndim) -> list[tuple[str, ...]]:
    entries = list(pspec) + [None] * (ndim - len(pspec))
    return [() if e is None else (e,) if isinstance(e, str) else tuple(e) for e in entries]


@pytest.fixture(scope="module")
def fake_meshes():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield {shape: DeviceMesh("cpu", torch.arange(8).reshape(shape), mesh_dim_names=_names(shape))
               for shape in MESHES}
    finally:
        dist.destroy_process_group()


SHAPES = [(), (8,), (7,), (2,), (64,), (128, 64), (64, 128), (16, 16), (3, 5), (8, 32),
          (64, 4, 16), (4, 16, 64), (64, 2, 16), (8, 24, 2, 16), (8, 24, 4, 16), (6, 24, 2, 16),
          (2, 64, 4, 16)]


@pytest.mark.parametrize("shape", MESHES)
def test_rules_name_the_reference_axes_on_the_same_shapes(fake_meshes, shape):
    import jax
    import jax.numpy as jnp
    from jax.sharding import AbstractMesh

    import repro.dist.sharding as jshd

    mesh, jmesh = fake_meshes[shape], AbstractMesh(shape, _names(shape))
    tree = {str(i): torch.zeros(s) for i, s in enumerate(SHAPES)}
    jtree = {str(i): jax.ShapeDtypeStruct(s, jnp.float32) for i, s in enumerate(SHAPES)}
    for fn, jfn in ((shd.param_specs, jshd.param_specs), (shd.data_specs, jshd.data_specs),
                    (shd.cache_specs, jshd.cache_specs)):
        got, want = fn(tree, mesh), jfn(jtree, jmesh)
        for key, s in zip(tree, SHAPES):
            assert (_axes_of_placements(got[key], mesh.mesh_dim_names, len(s))
                    == _axes_of_pspec(want[key], len(s))), (fn.__name__, s)


@pytest.mark.parametrize("shape", MESHES)
def test_param_specs_of_the_train_state_name_the_reference_axes(fake_meshes, shape):
    """The port's per-layer train state (params, AdamW moments, step)
    against the reference's stacked one, leaf by leaf."""
    import jax

    import repro.dist.sharding as jshd
    from jax.sharding import AbstractMesh
    from jax.sharding import PartitionSpec as P
    from repro.configs import get_config as jax_config
    from repro.models import init_params as jax_init
    from repro.train.optimizer import adamw_init

    cfg, jcfg = small_cfg(), jax_config("smollm-135m").reduced(
        n_layers=2, d_model=64, vocab=128, n_heads=4, n_kv_heads=2, dtype="float32")
    mesh = fake_meshes[shape]
    model = init_params(0, cfg, "cpu")
    opt = {"m": {n: p.float() for n, p in model.named_parameters()}}
    got = shd.param_specs({"params": model, "opt": opt, "step": torch.zeros(())}, mesh)
    jparams = jax.eval_shape(lambda: jax_init(jax.random.key(0), jcfg))
    jstate = {"params": jparams, "opt": {"m": adamw_init(jparams)["m"]}, "step": jax.numpy.int32(0)}
    specs = jshd.param_specs(jstate, AbstractMesh(shape, _names(shape)))
    want = {jax.tree_util.keystr(path, simple=True, separator="/"): spec for path, spec in
            jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, P))[0]}
    shapes = {n: leaf.shape for n, leaf in flatten_with_names(jstate)}
    checked = 0
    for part, leaves in (("params", got["params"]), ("opt/m", got["opt"]["m"])):
        for key, names in reference_groups(model).items():
            ref_axes = _axes_of_pspec(want[f"{part}/{key}"], len(shapes[f"{part}/{key}"]))
            for name in [names] if isinstance(names, str) else names:
                axes = _axes_of_placements(leaves[name], mesh.mesh_dim_names,
                                           model.get_parameter(name).ndim)
                assert axes == (ref_axes if isinstance(names, str) else ref_axes[1:]), (part, name)
                checked += 1
    assert checked == 2 * len(dict(model.named_parameters()))
    assert all(isinstance(p, Replicate) for p in got["step"])


def test_cache_specs_place_the_port_cache(fake_meshes):
    """Each layer's [B, T, Hk, hd] block: batch over data, heads over model."""
    mesh = fake_meshes[(4, 2)]
    cache = init_cache(small_cfg(), 8, 16, device="cpu")
    specs = shd.cache_specs(cache, mesh)
    for layer in specs:
        assert layer["k"] == layer["v"] == (Shard(0), Shard(2))
        assert layer["len"] == (Replicate(), Replicate())


# --------------------------------------------------------------------------- #
# The sharded step on spawned ranks
# --------------------------------------------------------------------------- #


def _gathered_placements(state) -> dict:
    return {name: tuple(p.placements) for name, p in state["params"].named_parameters()
            if isinstance(p, DTensor)}


def restore_err(restored, saved, mesh) -> float:
    """The largest |difference| between each restored DTensor's local piece
    and the same piece of the saved state, cut on this rank (no collective
    beyond gathering a saved leaf that is sharded: DTensor's own gather on
    the CPU, ``dist.local.full`` on the card, where gloo's all-gather of
    CUDA tensors through DTensor kills the rank)."""
    saved_flat = dict(flatten_with_names(shd.tensor_tree(saved)))
    worst = 0.0
    for name, r in flatten_with_names(shd.tensor_tree(restored)):
        leaf = saved_flat[name]
        full = (local.full(leaf) if leaf.is_cuda else leaf.full_tensor()).detach()
        want = distribute_tensor(full, mesh, r.placements, src_data_rank=None).to_local()
        worst = max(worst, float((r.to_local().double() - want.double()).abs().max()))
    return worst


def train_job(shape, restore_shape, device_type, ckpt_dir):
    """Two sharded steps on mesh ``shape``, a checkpoint, and an elastic
    restore onto ``restore_shape``; what rank 0 reports (every rank
    returns its metrics)."""
    mesh = DeviceMesh(device_type, torch.arange(dist.get_world_size()).reshape(shape),
                      mesh_dim_names=_names(shape))
    if device_type == "cuda":
        torch.cuda.set_device(0)
    run = launcher.pieces(small_cfg(), **TRAIN, device=device_type, mesh=mesh)
    step, state = run.make_step(), run.fresh_state()
    metrics = []
    for s in range(2):
        state, m = step(state, run.next_batch(s))
        metrics.append({k: launcher.value(v) for k, v in m.items()})
    placed = _gathered_placements(state)
    ckpt.save_checkpoint(ckpt_dir, 2, state, extra={"next_step": 2})
    saved = state_to_numpy(state)
    mesh2 = DeviceMesh(device_type, torch.arange(dist.get_world_size()).reshape(restore_shape),
                       mesh_dim_names=_names(restore_shape))
    restored, extra = ckpt.restore_checkpoint(ckpt_dir, state, shardings=shd.param_specs(state, mesh2),
                                              mesh=mesh2)
    want_placements = {n: s for n, s in shd.param_specs(restored, mesh2)["params"].items()}
    out = {"metrics": metrics, "placed": placed, "restored_placed": _gathered_placements(restored),
           "want_placements": want_placements, "extra": extra,
           "restore_err": restore_err(restored, state, mesh2)}
    if dist.get_rank() == 0:
        out["saved"] = saved
    return out


def single_device_steps(device="cpu"):
    """The same two steps on one device: (metrics, state as numpy)."""
    run = launcher.pieces(small_cfg(), **TRAIN, device=device)
    step, state = run.make_step(), run.fresh_state()
    metrics = []
    for s in range(2):
        state, m = step(state, run.next_batch(s))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state_to_numpy(state)


def check_sharded(results, want_metrics, want_state, tol=SHARDED_TOL):
    import numpy.testing as npt

    flat_want = flatten_with_names(want_state)
    for rank, res in enumerate(results):
        for got, want in zip(res["metrics"], want_metrics):
            for k in ("loss", "grad_norm", "lr"):
                assert got[k] == pytest.approx(want[k], rel=tol), (rank, k, got, want)
        assert res["restored_placed"] == res["want_placements"]
        assert res["extra"] == {"next_step": 2}
        assert res["restore_err"] == 0.0, (rank, res["restore_err"])
    for (name, got), (_n, want) in zip(flatten_with_names(results[0]["saved"]), flat_want):
        want = np.asarray(want, np.float64)
        # each leaf to ``tol`` of its largest value (moments are small numbers)
        npt.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                            atol=tol * float(np.abs(want).max(initial=0.0)), err_msg=name)


@pytest.fixture(scope="module")
def single_device():
    return single_device_steps("cpu")


def test_sharded_step_on_eight_gloo_ranks_equals_one_device(single_device, tmp_path):
    results = run_ranks(8, "gloo", train_job, ((4, 2), (2, 4), "cpu", str(tmp_path / "ckpt")),
                        tmp_path / "ranks")
    check_sharded(results, *single_device)
    placed = results[0]["placed"]
    # the rules took effect: tensor parallel over "model" where an axis divides
    assert placed["blocks.0.mixer.wq"] == (Replicate(), Shard(0))  # [64, 4, 16]: d_model
    assert placed["embed.table"] == (Replicate(), Shard(0))  # [128, 64]: vocab
    assert placed["blocks.0.ffn.w_down"] == (Replicate(), Shard(0))  # [256, 64]: d_ff
    assert results[0]["restored_placed"]["blocks.0.ffn.w_up"] == (Replicate(), Shard(1))
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["step_00000002", "step_00000002.done"]


def microbatch_job(shape, microbatches):
    """Two sharded steps on mesh ``shape`` with the batch cut into
    ``microbatches``: the metrics, and on rank 0 the state as numpy."""
    mesh = DeviceMesh("cpu", torch.arange(dist.get_world_size()).reshape(shape),
                      mesh_dim_names=_names(shape))
    run = launcher.pieces(small_cfg(), **TRAIN, microbatches=microbatches, device="cpu",
                          mesh=mesh)
    step, state = run.make_step(), run.fresh_state()
    metrics = []
    for s in range(2):
        state, m = step(state, run.next_batch(s))
        metrics.append({k: launcher.value(v) for k, v in m.items()})
    saved = state_to_numpy(state)
    return {"metrics": metrics, "saved": saved if dist.get_rank() == 0 else None}


def test_microbatched_sharded_step_equals_one_device(tmp_path):
    """Microbatches under a mesh with more data ranks than microbatches
    (8 rows, 2 microbatches of 4 over 4 data ranks: DTensor cannot split
    the sharded batch axis itself): the batch is made whole before the
    split and each microbatch sharded again; against the same two steps on
    one device."""
    run = launcher.pieces(small_cfg(), **TRAIN, microbatches=2, device="cpu")
    step, state = run.make_step(), run.fresh_state()
    want_metrics = []
    for s in range(2):
        state, m = step(state, run.next_batch(s))
        want_metrics.append({k: float(v) for k, v in m.items()})
    results = run_ranks(4, "gloo", microbatch_job, ((4, 1), 2), tmp_path / "ranks")
    import numpy.testing as npt

    for res in results:
        for got, want in zip(res["metrics"], want_metrics):
            for k in ("loss", "grad_norm", "lr"):
                assert got[k] == pytest.approx(want[k], rel=SHARDED_TOL), (k, got, want)
    for (name, got), (_n, want) in zip(flatten_with_names(results[0]["saved"]),
                                       flatten_with_names(state_to_numpy(state))):
        want = np.asarray(want, np.float64)
        npt.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                            atol=SHARDED_TOL * float(np.abs(want).max(initial=0.0)),
                            err_msg=name)
