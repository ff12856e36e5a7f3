"""The port's training path == the reference's, on the CPU at small sizes.

Inputs are made with numpy from a seed (or by the reference's own
``init_params``, carried over with ``models.convert``) and handed to both
packages.

Tolerances: the data pipeline and gradient compression are equal, with no
tolerance (numpy in both; the same IEEE operations on the same float32
values); float32 losses, optimizer updates and restored states within 1e-5
(matrix products accumulate in another order in XLA and in PyTorch).  The
whole train step against the reference's jitted one is in
``test_torch_train_steps.py``.
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.data.pipeline as jpipe
import repro.train.optimizer as jopt
from repro.configs import get_config as jax_config
from repro.dist.collectives import compress_grads_with_feedback as jax_compress
from repro.models import init_params as jax_init
from repro.models import lm_loss as jax_lm_loss
from repro.train import checkpoint as jax_ckpt
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.data.pipeline import PipelineConfig, global_batch, host_batch
from repro_torch.dist.collectives import compress_grads_with_feedback
from repro_torch.launch import train as launcher
from repro_torch.models import init_params, lm_loss
from repro_torch.models.convert import (
    params_from_numpy,
    per_param_from_numpy,
    reference_groups,
    state_to_numpy,
)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault import run_supervised
from repro_torch.train.optimizer import OPTIMIZERS, clip_by_global_norm, cosine_schedule
from repro_torch.train.train_step import make_train_step

F32_TOL = 1e-5
STEP_ARGS = dict(base_lr=1e-3, warmup=1, total_steps=10)  # lr > 0 from the second step


def _np(a):
    return np.asarray(a, np.float32)


def _tree_close(got, want, tol=F32_TOL):
    """Every leaf of two reference-layout numpy trees within ``tol``."""
    gl, wl = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(_np(g), _np(w), rtol=tol, atol=tol)


def _smoke_batch(cfg, rng, b=4, s=16):
    """The reference's per-arch batch kinds (tests/test_arch_smoke.py), from numpy."""
    tok = lambda ss: rng.integers(0, cfg.vocab, size=(b, ss)).astype(np.int32)  # noqa: E731
    emb = lambda ss: rng.standard_normal((b, ss, cfg.d_model), dtype=np.float32)  # noqa: E731
    if cfg.encoder_only:
        return {"embeddings": emb(s), "labels": tok(s)}
    if cfg.frontend != "none":
        return {"embeddings": emb(4), "tokens": tok(s - 4)}
    return {"tokens": tok(s)}


def _to_jax(batch, dtype):
    return {k: jnp.asarray(v, dtype if v.dtype == np.float32 else None) for k, v in batch.items()}


def _to_torch(batch, dtype):
    return {k: torch.from_numpy(v).to(dtype if v.dtype == np.float32 else torch.int32)
            for k, v in batch.items()}


# --------------------------------------------------------------------------- #
# Data pipeline
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("step", [0, 5, 1234])
@pytest.mark.parametrize("hosts", [1, 2, 4])
def test_pipeline_arrays_equal_reference(seed, step, hosts):
    for host in range(hosts):
        kw = dict(vocab=100, seq_len=16, global_batch=8, seed=seed, num_hosts=hosts,
                  host_id=host)
        got = host_batch(PipelineConfig(**kw), step)["tokens"]
        want = jpipe.host_batch(jpipe.PipelineConfig(**kw), step)["tokens"]
        assert got.dtype == want.dtype and got.shape == (8 // hosts, 16)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(global_batch(PipelineConfig(**kw), step)["tokens"],
                                      jpipe.global_batch(jpipe.PipelineConfig(**kw), step)["tokens"])


def test_pipeline_determinism_and_sharding():
    cfg = PipelineConfig(vocab=100, seq_len=16, global_batch=8, seed=3)
    a = global_batch(cfg, 5)["tokens"]
    np.testing.assert_array_equal(a, global_batch(cfg, 5)["tokens"])
    assert a.shape == (8, 16)
    assert not np.array_equal(a, global_batch(cfg, 6)["tokens"])
    h0 = host_batch(PipelineConfig(vocab=100, seq_len=16, global_batch=8, seed=3,
                                   num_hosts=2, host_id=0), 5)["tokens"]
    assert h0.shape == (4, 16)


# --------------------------------------------------------------------------- #
# Optimizers, schedule, clipping
# --------------------------------------------------------------------------- #


def _reference_model(arch, dtype="float32"):
    """(jax cfg, jax params as numpy, port model) of a reduced arch."""
    jcfg = jax_config(arch).reduced(dtype=dtype)
    tree = jax.tree.map(np.asarray, jax_init(jax.random.key(0), jcfg))
    return jcfg, tree, params_from_numpy(tree, get_config(arch).reduced(dtype=dtype), "cpu")


def _seeded_like(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ["smollm-135m", "llama4-maverick-400b-a17b"])
def test_optimizer_updates_equal_reference_on_stacked_leaves(opt, arch):
    """Three updates on the reduced model's tree with seeded grads; llama4
    reduced has a scan unit of 2 layers, so layer ``2 * step + u`` is row
    ``step`` of the reference's ``blocks[u]`` leaves."""
    _jcfg, tree, model = _reference_model(arch)
    j_init, j_update = getattr(jopt, f"{opt}_init"), getattr(jopt, f"{opt}_update")
    init, update = OPTIMIZERS[opt]
    jparams, jstate, state = tree, j_init(tree), init(model)
    if opt == "adafactor":  # the trap: every stacked leaf is factored, norm scales too
        assert set(state["stats"]["blocks/0/norm1/scale"]) == {"vr", "vc"}
        assert set(state["stats"]) == set(reference_groups(model))
    for i in range(3):
        grads = _seeded_like(tree, i)
        jparams, jstate = j_update(jparams, grads, jstate, lr=0.05)
        update(model, per_param_from_numpy(grads, model, "cpu"), state, lr=0.05)
    got = state_to_numpy({"params": model, "opt": state, "step": torch.tensor(0)})
    _tree_close(got["params"], jparams)
    _tree_close(got["opt"], jstate)


def _quad_loss(p):
    return ((p["w"] - 3.0) ** 2).sum() + ((p["b"] + 1.0) ** 2).sum()


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_optimizers_descend(opt):
    params = {"w": torch.zeros((4, 4), requires_grad=True),
              "b": torch.zeros((4,), requires_grad=True)}
    init, update = OPTIMIZERS[opt]
    state = init(params)
    loss0 = float(_quad_loss(params).detach())
    for _ in range(200):
        g = dict(zip(params, torch.autograd.grad(_quad_loss(params), list(params.values()))))
        update(params, g, state, lr=5e-2, weight_decay=0.0)
    assert float(_quad_loss(params).detach()) < loss0 * 0.05


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_optimizer_on_flat_dict_equals_reference(opt):
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "s": rng.standard_normal((3, 4, 5)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32)}
    j_init, j_update = getattr(jopt, f"{opt}_init"), getattr(jopt, f"{opt}_update")
    init, update = OPTIMIZERS[opt]
    params = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    jparams, jstate, state = tree, j_init(tree), init(params)
    for i in range(3):
        grads = _seeded_like(tree, 10 + i)
        jparams, jstate = j_update(jparams, grads, jstate, lr=0.1)
        update(params, {k: torch.from_numpy(v) for k, v in grads.items()}, state, lr=0.1)
    for k in tree:
        np.testing.assert_allclose(params[k].numpy(), _np(jparams[k]), rtol=F32_TOL, atol=F32_TOL)


def test_cosine_schedule_equals_reference():
    for warmup, total in ((10, 100), (0, 50), (100, 10_000)):
        for step in (0, 1, 5, 10, 11, 50, 99, 100, 200, 20_000):
            got = float(cosine_schedule(torch.tensor(step, dtype=torch.int32), 3e-4, warmup, total))
            want = float(jopt.cosine_schedule(jnp.int32(step), 3e-4, warmup, total))
            assert got == pytest.approx(want, rel=1e-6, abs=1e-12), (warmup, total, step)
    assert float(cosine_schedule(torch.tensor(0), 1.0, 10, 100)) == 0.0
    assert abs(float(cosine_schedule(torch.tensor(10), 1.0, 10, 100)) - 1.0) < 1e-6
    assert 0.0 < float(cosine_schedule(torch.tensor(100), 1.0, 10, 100)) < 0.2


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_equals_reference(max_norm):
    rng = np.random.default_rng(1)
    tree = {"a": rng.standard_normal((5, 7)).astype(np.float32),
            "b": {"c": rng.standard_normal(3).astype(np.float32)}}
    jclipped, jnorm = jopt.clip_by_global_norm(tree, max_norm)
    clipped, norm = clip_by_global_norm(jax.tree.map(torch.from_numpy, tree), max_norm)
    assert float(norm) == pytest.approx(float(jnorm), rel=1e-6)
    np.testing.assert_allclose(clipped["a"].numpy(), jclipped["a"], rtol=1e-6)
    np.testing.assert_allclose(clipped["b"]["c"].numpy(), jclipped["b"]["c"], rtol=1e-6)
    bf = {"x": torch.ones(4, dtype=torch.bfloat16) * 3}
    assert clip_by_global_norm(bf, max_norm)[0]["x"].dtype == torch.bfloat16  # cast back


# --------------------------------------------------------------------------- #
# Loss
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("arch", ["smollm-135m", "hubert-xlarge", "pixtral-12b"])
def test_lm_loss_equals_reference(arch, masked):
    """Decoder, encoder-only (labels over embeddings) and a frontend prefix
    (its positions carry no labels); with and without ``mask``."""
    jcfg, tree, model = _reference_model(arch)
    cfg = model.cfg
    rng = np.random.default_rng(5)
    batch = _smoke_batch(cfg, rng)
    if masked:
        width = batch["tokens"].shape[1] if "tokens" in batch else batch["labels"].shape[1]
        batch["mask"] = (rng.random((4, width)) < 0.6).astype(np.int32)
    want = float(jax.jit(jax_lm_loss, static_argnums=1)(tree, jcfg, _to_jax(batch, jnp.float32)))
    got = float(lm_loss(model, cfg, _to_torch(batch, torch.float32)))
    assert got == pytest.approx(want, rel=F32_TOL)


# --------------------------------------------------------------------------- #
# Architectures
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "jamba-1.5-large-398b",
                                  "llama4-maverick-400b-a17b", "rwkv6-1.6b"])
def test_param_count_with_the_kinds_kept_matches_the_reference(arch):
    """``reduced()`` resets ``layer_pattern``, so MoE and MLA archs reduce to
    GQA; with the pattern kept (test_torch_blocks.PATTERNS) the port's
    MoE, MLA, Mamba and RWKV-6 blocks count the reference's parameters, and
    the model built from a seed has that many."""
    from test_torch_blocks import configs

    jcfg, cfg = configs(arch)
    assert cfg.param_count() == jcfg.param_count()
    model = init_params(0, cfg, "cpu")
    assert sum(p.numel() for p in model.parameters()) == jcfg.param_count()


# --------------------------------------------------------------------------- #
# Remat policies
# --------------------------------------------------------------------------- #


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.calls = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
            self.calls += 1
        return func(*args, **(kwargs or {}))


def _grads_and_backward_matmuls(policy):
    cfg = get_config("smollm-135m").reduced(dtype="float32", remat_policy=policy)
    model = init_params(0, cfg, "cpu").requires_grad_(True)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (2, 32)).astype(np.int32))
    loss = lm_loss(model, cfg, {"tokens": tokens})
    names, params = zip(*model.named_parameters())
    with _CountMatmuls() as count:
        grads = torch.autograd.grad(loss, params)
    return dict(zip(names, grads)), count.calls


def test_remat_policies_give_the_same_grads():
    none, none_mm = _grads_and_backward_matmuls("none")
    dots, dots_mm = _grads_and_backward_matmuls("dots")
    full, full_mm = _grads_and_backward_matmuls("full")
    for name in none:
        torch.testing.assert_close(dots[name], none[name], rtol=0, atol=0)
        torch.testing.assert_close(full[name], none[name], rtol=0, atol=0)
    # the backward recomputes: "dots" the attention's two batched products a
    # block, "full" the block's forward up to the last tensor the backward
    # needs: 4 projections, 2 attention products, 2 of the 3 MLP products
    n = get_config("smollm-135m").reduced().n_layers
    assert dots_mm == none_mm + 2 * n
    assert full_mm == none_mm + 8 * n


# --------------------------------------------------------------------------- #
# Checkpoints (the reference's test_runtime.py cases) and across packages
# --------------------------------------------------------------------------- #


def _tiny_state(seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {"a": torch.randn((4, 8), generator=g), "b": {"c": torch.ones((3,))}}
    return {"params": params, "step": torch.tensor(7, dtype=torch.int32)}


def test_checkpoint_roundtrip(tmp_path):
    state = _tiny_state()
    ckpt.save_checkpoint(str(tmp_path), 7, state, extra={"next_step": 7})
    assert ckpt.latest_step(str(tmp_path)) == 7
    restored, extra = ckpt.restore_checkpoint(str(tmp_path), _tiny_state(seed=1))
    assert extra["next_step"] == 7
    torch.testing.assert_close(restored["params"]["a"], state["params"]["a"], rtol=0, atol=0)
    assert int(restored["step"]) == 7 and restored["step"].dtype == torch.int32


def test_checkpoint_partial_write_ignored(tmp_path):
    ckpt.save_checkpoint(str(tmp_path), 5, _tiny_state())
    os.makedirs(tmp_path / "step_00000009", exist_ok=True)  # a crashed write, no marker
    assert ckpt.latest_step(str(tmp_path)) == 5


def test_checkpoint_latest_of_many(tmp_path):
    for s in (1, 3, 2):
        ckpt.save_checkpoint(str(tmp_path), s, _tiny_state())
    assert ckpt.latest_step(str(tmp_path)) == 3


def test_checkpoint_of_a_generic_tree_reads_in_the_reference(tmp_path):
    ckpt.save_checkpoint(str(tmp_path), 7, _tiny_state(), extra={"next_step": 7})
    like = {"params": {"a": jnp.zeros((4, 8)), "b": {"c": jnp.zeros((3,))}}, "step": jnp.int32(0)}
    restored, extra = jax_ckpt.restore_checkpoint(str(tmp_path), like)
    np.testing.assert_array_equal(np.asarray(restored["params"]["a"]),
                                  _tiny_state()["params"]["a"].numpy())
    assert int(restored["step"]) == 7 and extra == {"next_step": 7}


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_lm_checkpoints_restore_across_packages(tmp_path, opt):
    """A bfloat16 train state after one step: each package restores the
    other's checkpoint leaf for leaf (names, stacked shapes, dtypes)."""
    jcfg = jax_config("smollm-135m").reduced()
    cfg = get_config("smollm-135m").reduced()
    j_init_state, j_step = jax_make_train_step(jcfg, opt, **STEP_ARGS)
    jstate = j_init_state(jax_init(jax.random.key(0), jcfg))
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    jstate, _ = jax.jit(j_step)(jstate, {"tokens": jnp.asarray(tokens)})
    want = jax.tree.map(np.asarray, jstate)

    jax_ckpt.save_checkpoint(str(tmp_path / "ref"), 1, jstate, extra={"next_step": 1})
    init_state, step = make_train_step(cfg, opt, **STEP_ARGS)
    like = init_state(init_params(1, cfg, "cpu"))
    state, extra = ckpt.restore_checkpoint(str(tmp_path / "ref"), like)
    assert extra == {"next_step": 1}
    assert state["params"].embed.table.dtype == torch.bfloat16
    _tree_close(state_to_numpy(state), want, tol=0)

    ckpt.save_checkpoint(str(tmp_path / "port"), 1, state, extra={"next_step": 1})
    jlike = j_init_state(jax_init(jax.random.key(1), jcfg))
    back, extra = jax_ckpt.restore_checkpoint(str(tmp_path / "port"), jlike)
    assert extra == {"next_step": 1}
    assert jax.tree.map(lambda a: a.dtype, back) == jax.tree.map(lambda a: a.dtype, jlike)
    _tree_close(jax.tree.map(np.asarray, back), want, tol=0)
    step(state, {"tokens": torch.from_numpy(tokens)})  # the restored state trains


# --------------------------------------------------------------------------- #
# Supervisor (the reference's test_runtime.py cases)
# --------------------------------------------------------------------------- #


def test_supervisor_recovers_from_crashes(tmp_path):
    cfg = get_config("smollm-135m").reduced(n_layers=2, d_model=64, vocab=128)
    init_state, train_step = make_train_step(cfg, optimizer="adamw", base_lr=1e-3)
    pipe = PipelineConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)
    crashes = {"left": 2}
    made = []

    def make_step():
        made.append(1)

        def step(state, batch):
            if crashes["left"] and int(state["step"]) == 6:
                crashes["left"] -= 1
                raise RuntimeError("boom")
            return train_step(state, batch)

        return step

    losses = {}
    report = run_supervised(
        total_steps=12,
        make_step=make_step,
        init_state=lambda: init_state(init_params(0, cfg, "cpu")),
        next_batch=lambda s: {"tokens": torch.from_numpy(global_batch(pipe, s)["tokens"])},
        ckpt_dir=str(tmp_path),
        checkpoint_every=3,
        on_metrics=lambda s, m: losses.setdefault(s, []).append(float(m["loss"])),
    )
    assert report.final_step == 12 and report.steps_run == 12
    assert report.failures_recovered == 2 and report.restarts == [6, 6]
    assert len(made) == 3  # make_step again on every restart
    assert all(len(v) == 1 for v in losses.values())  # the crash came before step 6 ran
    assert ckpt.latest_step(str(tmp_path)) == 12


def test_supervisor_replays_identically(tmp_path):
    """A failure after step 5 restores step 3 and replays 3-5 bit for bit."""
    cfg = get_config("smollm-135m").reduced(n_layers=2, d_model=64, vocab=128, dtype="float32")
    init_state, train_step = make_train_step(cfg, optimizer="adamw", base_lr=1e-3, warmup=1)
    pipe = PipelineConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)
    fail = {"left": 1}

    def make_step():
        def step(state, batch):
            if fail["left"] and int(state["step"]) == 5:
                fail["left"] -= 1
                raise RuntimeError("injected")
            return train_step(state, batch)

        return step

    losses = {}
    report = run_supervised(
        total_steps=8, make_step=make_step,
        init_state=lambda: init_state(init_params(0, cfg, "cpu")),
        next_batch=lambda s: {"tokens": torch.from_numpy(global_batch(pipe, s)["tokens"])},
        ckpt_dir=str(tmp_path), checkpoint_every=3,
        on_metrics=lambda s, m: losses.setdefault(s, []).append(float(m["loss"])))
    assert report.restarts == [5] and report.failures_recovered == 1
    assert [len(losses[s]) for s in range(8)] == [1, 1, 1, 2, 2, 1, 1, 1]
    for s in (3, 4):
        assert losses[s][0] == losses[s][1]


def test_supervisor_gives_up_after_max_retries(tmp_path):
    def make_step():
        def step(state, batch):
            raise RuntimeError("always fails")

        return step

    with pytest.raises(RuntimeError):
        run_supervised(total_steps=3, make_step=make_step,
                       init_state=lambda: {"step": torch.tensor(0, dtype=torch.int32)},
                       next_batch=lambda s: None, ckpt_dir=str(tmp_path), max_retries=2)


# --------------------------------------------------------------------------- #
# Gradient compression
# --------------------------------------------------------------------------- #


def test_gradient_compression_equals_reference():
    rng = np.random.default_rng(0)
    tree = {"w": rng.normal(size=(64, 64)).astype(np.float32),
            "layer": (rng.normal(size=(4,)).astype(np.float32), np.full((4,), 2.0, np.float32)),
            "z": np.zeros((3,), np.float32)}
    t = jax.tree.map(torch.from_numpy, tree)
    deq, resid = compress_grads_with_feedback(t, None)
    jdeq, jresid = jax_compress(jax.tree.map(jnp.asarray, tree), None)
    for got, want in ((deq, jdeq), (resid, jresid)):
        for g, w in zip(jax.tree.leaves(jax.tree.map(lambda x: x.numpy(), got)), jax.tree.leaves(want)):
            np.testing.assert_array_equal(g, np.asarray(w))
    deq2, resid2 = compress_grads_with_feedback(t, resid)
    jdeq2, jresid2 = jax_compress(jax.tree.map(jnp.asarray, tree), jresid)
    np.testing.assert_array_equal(deq2["w"].numpy(), np.asarray(jdeq2["w"]))
    np.testing.assert_array_equal(resid2["w"].numpy(), np.asarray(jresid2["w"]))
    # the reference test's bounds: error within half a step, captured by the residual
    scale = float(np.abs(tree["w"]).max()) / 127.0
    err = tree["w"] - deq["w"].numpy()
    np.testing.assert_allclose(err, resid["w"].numpy(), rtol=1e-5, atol=1e-6)
    assert np.abs(err).max() <= scale * 0.5 + 1e-6
    np.testing.assert_allclose((deq["w"] + deq2["w"]).numpy(), 2 * tree["w"], atol=2 * scale)
    np.testing.assert_allclose(deq["layer"][1].numpy(), 2.0, atol=0.1)
    assert isinstance(deq["layer"], tuple)


def test_half_to_even_rounding():
    """``torch.round`` and ``jnp.round`` both round halves to even."""
    g = {"x": torch.tensor([127.0, 0.5, 1.5, 2.5, -2.5])}
    got, _ = compress_grads_with_feedback(g)
    want, _ = jax_compress({"x": jnp.asarray(g["x"].numpy())})
    np.testing.assert_array_equal(got["x"].numpy(), np.asarray(want["x"]))


# --------------------------------------------------------------------------- #
# Launcher
# --------------------------------------------------------------------------- #


def test_launcher_trains_on_cpu(tmp_path, capsys):
    rc = launcher.main(["--reduced", "--device", "cpu", "--steps", "4", "--batch", "2",
                        "--seq", "16", "--log-every", "1", "--ckpt-every", "2",
                        "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0
    assert len(re.findall(r"^step\s+\d+ loss \d", out, re.M)) == 4
    assert "done: 4 steps, 0 recoveries" in out
    assert ckpt.latest_step(str(tmp_path)) == 4


def test_launcher_resumes_from_its_checkpoint(tmp_path, capsys):
    args = ["--reduced", "--device", "cpu", "--batch", "2", "--seq", "16", "--log-every", "1",
            "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)]
    launcher.main(args + ["--steps", "2"])
    capsys.readouterr()
    launcher.main(args + ["--steps", "4"])
    out = capsys.readouterr().out
    assert re.findall(r"^step\s+(\d+)", out, re.M) == ["2", "3"]


def test_launcher_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launcher.main(["--reduced", "--steps", "1", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launcher.pieces(get_config("smollm-135m").reduced(), batch=2, seq=8)
