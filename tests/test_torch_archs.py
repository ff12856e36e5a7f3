"""The four archs the MoE, MLA, Mamba and RWKV-6 blocks unlock, whole, against the reference.

deepseek-v2-lite-16b (MLA + MoE), llama4-maverick-400b-a17b (GQA + MoE),
jamba-1.5-large-398b (its 8-layer period: Mamba, GQA, MoE) and rwkv6-1.6b
(RWKV-6 time and channel mix), each at a reduced size that keeps its kinds
(``test_torch_blocks.PATTERNS``), float32.  Weights come from the
reference's ``init_params`` through ``params_from_numpy``; tokens are made
with numpy from a seed.

MoE capacity drops are the reference's semantics, so parity with the
reference holds with them (the default capacity factor, 1.25).  A decode
step routes a few tokens at a time, so its capacity differs from a full
forward's and it drops other tokens: decode equals a forward over the same
tokens only where every expert can take every token (``capacity_factor =
E/k``, C >= Tg; ROADMAP §3).

Tolerances: float32 1e-4 absolute and relative (``test_torch_lm.py``),
losses 1e-5 relative; round trips and checkpoints equal with no tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as jm
from repro.serve import prefix_dag as jax_dag
from repro.train import checkpoint as jax_ckpt
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.models import decode_step, forward, init_cache, init_params, lm_loss, prefill
from repro_torch.models.convert import (
    params_from_numpy,
    reference_groups,
    state_from_numpy,
    state_to_numpy,
)
from repro_torch.serve import prefix_dag
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.train_step import make_train_step
from repro_torch.tree import flatten_with_names

from test_torch_blocks import PATTERNS, configs, no_drops
from test_torch_lm import _close

ARCHS = list(PATTERNS)
_MODELS = {}
# the reference's entry points, jitted once per config
_init = jax.jit(jm.init_params, static_argnums=1)
_forward = jax.jit(lambda p, cfg, t: jm.forward(p, cfg, tokens=t)[0], static_argnums=1)
_loss = jax.jit(jm.lm_loss, static_argnums=1)
_prefill = jax.jit(jm.prefill, static_argnums=1)
_decode = jax.jit(jm.decode_step, static_argnums=1)


def models(arch, dtype="float32"):
    """(reference cfg, reference params, port model) of a reduced arch, built once."""
    if (arch, dtype) not in _MODELS:
        jcfg, cfg = configs(arch, dtype)
        params = _init(jax.random.key(0), jcfg)
        model = params_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
        _MODELS[arch, dtype] = (jcfg, params, model)
    return _MODELS[arch, dtype]


def tokens(b, s, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_equal_the_reference(arch):
    jcfg, params, model = models(arch)
    toks = tokens(2, 20, jcfg.vocab)
    want = _forward(params, jcfg, jnp.asarray(toks))
    got, _ = forward(model, model.cfg, tokens=torch.from_numpy(toks))
    _close(got, want, 1e-4)
    jloss = float(_loss(params, jcfg, {"tokens": jnp.asarray(toks)}))
    loss = float(lm_loss(model, model.cfg, {"tokens": torch.from_numpy(toks)}))
    assert loss == pytest.approx(jloss, rel=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_equal_the_reference_with_drops(arch):
    jcfg, params, model = models(arch)
    cfg = model.cfg
    b, s, steps = 3, 11, 3
    toks = tokens(b, s, jcfg.vocab, seed=2)
    jcache = jm.init_cache(jcfg, b, s + steps)
    jlast, jcache = _prefill(params, jcfg, jnp.asarray(toks), jcache)
    cache = init_cache(cfg, b, s + steps, device="cpu")
    last, cache = prefill(model, cfg, torch.from_numpy(toks), cache)
    _close(last, jlast, 1e-4)
    for i in range(steps):
        jtok = jnp.argmax(jlast, axis=-1)[:, None].astype(jnp.int32)
        tok = last.argmax(dim=-1)[:, None].to(torch.int32)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        jlast, jcache = _decode(params, jcfg, jtok, jcache, jnp.int32(s + i))
        last, cache = decode_step(model, cfg, tok, cache, s + i)
        _close(last, jlast, 1e-4)
    # every layer's cache holds what the reference's does (stacked per scan unit)
    jflat = dict(flatten_with_names(jax.tree.map(np.asarray, jcache)))
    for layer, c in enumerate(cache):
        step, u = divmod(layer, cfg.scan_period)
        for name, leaf in flatten_with_names(c):
            key = f"{u}/{'' if name.startswith('ffn') else 'mixer/'}{name}"
            if name.endswith("len"):
                assert leaf == s + steps == int(jflat[key][step])
            else:
                _close(leaf, jflat[key][step], 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_equals_a_forward_without_drops(arch):
    """With C >= Tg no token is dropped, and a prefill plus decode steps
    equal one forward over the same tokens (the reference's own
    ``test_decode_matches_prefill`` property)."""
    _jcfg, _params, model = models(arch)
    cfg = no_drops(model.cfg) if model.cfg.moe else model.cfg
    toks = torch.from_numpy(tokens(2, 14, cfg.vocab, seed=3))
    full, _ = forward(model, cfg, tokens=toks)
    cache = init_cache(cfg, 2, 14, device="cpu")
    last, cache = prefill(model, cfg, toks[:, :10], cache)
    _close(last, full[:, 9].numpy(), 1e-4)
    for i in range(10, 14):
        last, cache = decode_step(model, cfg, toks[:, i:i + 1], cache, i)
        _close(last, full[:, i].numpy(), 1e-4)


def _prompts(vocab):
    rng = np.random.default_rng(3)
    shared = rng.integers(0, vocab, size=32, dtype=np.int32)
    return [np.concatenate([shared, [7]]).astype(np.int32),
            np.concatenate([shared, rng.integers(0, vocab, size=5)]).astype(np.int32),
            rng.integers(0, vocab, size=10).astype(np.int32)]


@pytest.mark.parametrize("arch", ARCHS)
def test_run_with_prefix_dag_equals_the_reference(arch, monkeypatch):
    """Chains prefilled once, each request's tail continuing from a copy of
    its chain's cache (the recurrent states too)."""
    jcfg, params, model = models(arch)
    prompts = _prompts(jcfg.vocab)
    monkeypatch.setattr(jm, "prefill", _prefill)  # the reference's runner, jitted steps
    want, _, jplan = jax_dag.run_with_prefix_dag(params, jcfg, prompts, 48)
    got, caches, plan = prefix_dag.run_with_prefix_dag(model, model.cfg, prompts, 48)
    assert plan.groups == jplan.groups
    _close(got, want, 1e-4)
    # the shared chain's requests hold their own tails: the copies did not share
    a, b = caches[0], caches[1]
    assert any(not torch.equal(x, y) for x, y in zip(
        (leaf for _, leaf in flatten_with_names(a) if isinstance(leaf, torch.Tensor)),
        (leaf for _, leaf in flatten_with_names(b) if isinstance(leaf, torch.Tensor))))


@pytest.mark.parametrize("arch", ARCHS)
def test_params_and_states_round_trip(arch):
    """A reference tree -> the port -> the reference's layout, leaf for leaf
    and dtype for dtype (a bfloat16 model with float32 router and SSM
    leaves), for the parameters and for AdamW's and Adafactor's whole train
    states (the expert banks stacked [L, E, D, F] among them)."""
    jcfg, cfg = configs(arch, "bfloat16")
    params = jax.tree.map(np.asarray, _init(jax.random.key(0), jcfg))
    model = params_from_numpy(params, cfg, device="cpu")
    flat = dict(flatten_with_names(params))
    dtypes = set()
    for key, names in reference_groups(model).items():
        for name in [names] if isinstance(names, str) else names:
            got = str(model.get_parameter(name).dtype).removeprefix("torch.")
            assert got == str(flat[key].dtype), (name, got, flat[key].dtype)
            dtypes.add(got)
    assert dtypes == {"bfloat16", "float32"}
    for opt in ("adamw", "adafactor"):
        j_init_state, _ = jax_make_train_step(jcfg, opt)
        jstate = jax.tree.map(np.asarray, _seeded_state(j_init_state(params)))
        back = state_to_numpy(state_from_numpy(jstate, cfg, "cpu"))
        _equal_trees(back, jstate)


def _seeded_state(jstate):
    """The reference's fresh train state with its optimizer's float32
    tensors (zeros) replaced by seeded numbers, so a round trip that
    loses or swaps a leaf shows."""
    rng = np.random.default_rng(4)

    def seeded(path, a):
        name = jax.tree_util.keystr(path)
        if "opt" in name and a.dtype == jnp.float32 and a.ndim:
            return jnp.asarray(rng.random(a.shape, dtype=np.float32))
        return a

    return jax.tree_util.tree_map_with_path(seeded, jstate)


def _equal_trees(got, want):
    want = dict(flatten_with_names(want))
    for name, leaf in flatten_with_names(got):
        w = want.pop(name)
        np.testing.assert_array_equal(np.asarray(leaf), np.asarray(w, np.asarray(leaf).dtype),
                                      err_msg=name)
    assert not want, sorted(want)


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_read_across_packages(tmp_path, arch, opt):
    """A bfloat16 train state (its optimizer tensors seeded): the reference
    writes it and the port restores it, then the port writes it back and
    the reference restores that, leaf for leaf and dtype for dtype."""
    jcfg, cfg = configs(arch, "bfloat16")
    j_init_state, _ = jax_make_train_step(jcfg, opt)
    jstate = _seeded_state(j_init_state(_init(jax.random.key(0), jcfg)))
    want = jax.tree.map(np.asarray, jstate)
    jax_ckpt.save_checkpoint(str(tmp_path / "ref"), 3, jstate, extra={"next_step": 3})

    init_state, _ = make_train_step(cfg, opt)
    like = init_state(init_params(1, cfg, "cpu"))
    state, extra = ckpt.restore_checkpoint(str(tmp_path / "ref"), like)
    assert extra == {"next_step": 3}
    _equal_trees(state_to_numpy(state), want)

    ckpt.save_checkpoint(str(tmp_path / "port"), 3, state, extra={"next_step": 3})
    jlike = j_init_state(_init(jax.random.key(1), jcfg))
    back, extra = jax_ckpt.restore_checkpoint(str(tmp_path / "port"), jlike)
    assert extra == {"next_step": 3}
    assert jax.tree.map(lambda a: a.dtype, back) == jax.tree.map(lambda a: a.dtype, jlike)
    _equal_trees(jax.tree.map(np.asarray, back), want)
