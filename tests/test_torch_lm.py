"""The port's LM serving path == the reference's, on SmolLM-135M reduced.

Weights come from the reference's ``init_params`` and are carried into the
port's model with ``params_from_numpy``; inputs are made with numpy from a
seed and handed to both packages.

Tolerances: in a float32 config the two agree to 1e-4 (absolute and
relative), and greedy tokens are equal.  In bfloat16 the two round at
other places (the reference's XLA keeps intermediates of a fused expression
in float32 where PyTorch rounds each operation's output; its ``_sdpa``
rounds scores and probabilities where the port's decode kernel does not),
and the rounding noise scales with the logits as a whole (RMS about 11 on
this model: tied N(0, 1) embeddings over d_model 128), not with each logit.
So in bfloat16 every logit is held to 0.15 times the RMS of the reference's
logits, the 0.15 of the reference's own decode-vs-prefill test
(``tests/test_arch_smoke.py``) taken relative to that scale.  An
elementwise 0.15 absolute and relative holds across frameworks for no
one: the reference's own bfloat16 logits differ from its float32 logits
on the same weights by up to 0.36 on this model.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as jm
import repro.models.layers as jl
from repro.configs import get_config as jax_config
from repro.serve import prefix_dag as jax_dag
from repro_torch.configs import CONFIGS, get_config
from repro_torch.kernels import decode_attention as da
from repro_torch.launch import serve as launcher
from repro_torch.models import decode_step, forward, init_cache, layers, prefill
from repro_torch.models.attention import decode_lengths
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import prefix_dag

BF16_TOL = 0.15  # times the RMS of the reference's values (module docstring)


def _cfg(dtype):
    return get_config("smollm-135m").reduced(dtype=dtype)


_MODELS = {}
# the reference's entry points, jitted once per config (eager dispatch is slow)
_init = jax.jit(jm.init_params, static_argnums=1)
_forward = jax.jit(lambda p, cfg, t: jm.forward(p, cfg, tokens=t)[0], static_argnums=1)
_prefill = jax.jit(jm.prefill, static_argnums=1)
_decode = jax.jit(jm.decode_step, static_argnums=1)


def _models(dtype):
    """(jax cfg, jax params, port model) of reduced SmolLM, built once."""
    if dtype not in _MODELS:
        cfg = jax_config("smollm-135m").reduced(dtype=dtype)
        params = _init(jax.random.key(0), cfg)
        tree = jax.tree.map(np.array, params)
        _MODELS[dtype] = (cfg, params, params_from_numpy(tree, _cfg(dtype), device="cpu"))
    return _MODELS[dtype]


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _close_to_scale(got, want, tol=BF16_TOL):
    """Every element within ``tol`` times the RMS of ``want``."""
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= tol * np.sqrt(np.mean(want**2)), (err, np.sqrt(np.mean(want**2)))


def _check(dtype, got, want):
    if dtype == "float32":
        _close(got, want, 1e-4)
    else:
        _close_to_scale(got, want)


def _tokens(b, s, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s)).astype(np.int32)


# --------------------------------------------------------------------------- #
# Configs and layers
# --------------------------------------------------------------------------- #


def test_configs_are_the_reference_data():
    from repro.configs import CONFIGS as JAX_CONFIGS

    assert sorted(CONFIGS) == sorted(JAX_CONFIGS)
    for name, cfg in CONFIGS.items():
        assert repr(cfg) == repr(JAX_CONFIGS[name]), name
        assert repr(cfg.reduced()) == repr(JAX_CONFIGS[name].reduced()), name


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_param_count_matches_the_reference(arch, reduced):
    """Every registry arch builds in the port (at full size on the meta
    device), with the reference's ``count_params_analytic``."""
    cfg = get_config(arch)
    jcfg = jax_config(arch)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    assert cfg.param_count() == jcfg.param_count()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match_the_reference(dtype):
    rng = np.random.default_rng(0)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    tol = 1e-5 if dtype == "float32" else 1e-2
    x = rng.standard_normal((2, 7, 3, 32), dtype=np.float32)
    scale = rng.standard_normal(32, dtype=np.float32)
    pos = rng.integers(0, 300, size=(2, 7)).astype(np.int32)
    w = [rng.standard_normal(s, dtype=np.float32) / 6 for s in ((32, 48), (32, 48), (48, 32))]
    j = lambda a: jnp.asarray(a, jdt)  # noqa: E731
    t = lambda a: torch.from_numpy(a).to(tdt)  # noqa: E731
    _close(layers.rmsnorm(t(x), t(scale)), jl.rmsnorm({"scale": j(scale)}, j(x)), tol)
    _close(layers.apply_rope(t(x), torch.from_numpy(pos), 10000.0),
           jl.apply_rope(j(x), jnp.asarray(pos), 10000.0), tol)
    _close(layers.swiglu(t(x), *map(t, w)),
           jl.swiglu(dict(zip(("w_gate", "w_up", "w_down"), map(j, w))), j(x)), tol)
    _close(layers.relu2(t(x), *map(t, w[1:])),
           jl.relu2({"w_up": j(w[1]), "w_down": j(w[2])}, j(x)), tol)
    _close(layers.gelu_mlp(t(x), *map(t, w[1:])),
           jl.gelu_mlp({"w_up": j(w[1]), "w_down": j(w[2])}, j(x)), tol)


# --------------------------------------------------------------------------- #
# Forward, prefill, decode
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_the_reference(dtype):
    jcfg, params, model = _models(dtype)
    toks = _tokens(2, 24, jcfg.vocab)
    want = _forward(params, jcfg, jnp.asarray(toks))
    got, _ = forward(model, model.cfg, tokens=torch.from_numpy(toks))
    assert got.dtype == model.embed.table.dtype
    _check(dtype, got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_the_reference(dtype):
    jcfg, params, model = _models(dtype)
    cfg = model.cfg
    b, s, steps = 3, 17, 3
    toks = _tokens(b, s, jcfg.vocab, seed=2)
    jcache = jm.init_cache(jcfg, b, s + steps)
    jlast, jcache = _prefill(params, jcfg, jnp.asarray(toks), jcache)
    cache = init_cache(cfg, b, s + steps, device="cpu")
    last, cache = prefill(model, cfg, torch.from_numpy(toks), cache)
    _check(dtype, last, jlast)
    jtok = jnp.argmax(jlast, axis=-1)[:, None].astype(jnp.int32)
    tok = last.argmax(dim=-1)[:, None].to(torch.int32)
    launches = da.LAUNCHES
    for i in range(steps):
        if dtype == "float32":
            np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        else:  # feed both the reference's token, so the steps stay comparable
            tok = torch.from_numpy(np.array(jtok))
        jlast, jcache = _decode(params, jcfg, jtok, jcache, jnp.int32(s + i))
        last, cache = decode_step(model, cfg, tok, cache, s + i)
        _check(dtype, last, jlast)
        jtok = jnp.argmax(jlast, axis=-1)[:, None].astype(jnp.int32)
        tok = last.argmax(dim=-1)[:, None].to(torch.int32)
    assert all(c["len"] == s + steps for c in cache)
    assert da.LAUNCHES == launches  # CPU tensors take the plain version
    # the cache holds what the reference's does
    _check(dtype, cache[0]["k"], jcache[0]["mixer"]["k"][0])
    _check(dtype, cache[-1]["v"], jcache[0]["mixer"]["v"][-1])


def test_decode_step_goes_through_the_kernel_wrapper_once_per_layer(monkeypatch):
    _, _, model = _models("float32")
    cfg = model.cfg
    calls = []
    plain = da.decode_attention

    def counting(q, k, v, cache_len):
        calls.append(cache_len.clone())
        return plain(q, k, v, cache_len)

    monkeypatch.setattr(da, "decode_attention", counting)
    cache = init_cache(cfg, 2, 12, device="cpu")
    last, cache = prefill(model, cfg, torch.from_numpy(_tokens(2, 8, cfg.vocab)), cache)
    assert not calls  # prefill attends in plain _sdpa
    tok = last.argmax(dim=-1)[:, None].to(torch.int32)
    for i in range(3):
        last, cache = decode_step(model, cfg, tok, cache, 8 + i)
        assert len(calls) == cfg.n_layers * (i + 1)
    assert all(torch.equal(c, torch.tensor([9, 9], dtype=torch.int32))
               for c in calls[:cfg.n_layers])


def test_decode_lengths_follow_the_reference_mask():
    pos = torch.tensor([[5], [2], [9], [-3]], dtype=torch.int32)
    # keys t < start + 1 and t <= position: t < min(position, start) + 1
    assert decode_lengths(pos, 5).tolist() == [6, 3, 6, 0]
    assert decode_lengths(pos, 5, causal=False).tolist() == [6, 6, 6, 6]


# --------------------------------------------------------------------------- #
# Prefix DAG
# --------------------------------------------------------------------------- #


def _prompts(vocab):
    rng = np.random.default_rng(3)
    shared = rng.integers(0, vocab, size=32, dtype=np.int32)
    # requests 0 and 1 share their whole chain (two full blocks) and differ in
    # the tail; request 2 has no full block
    return [
        np.concatenate([shared, [7]]).astype(np.int32),
        np.concatenate([shared, [9]]).astype(np.int32),
        rng.integers(0, vocab, size=10).astype(np.int32),
    ]


def test_plan_batch_matches_the_reference():
    prompts = _prompts(512) + [np.arange(40, dtype=np.int32), np.arange(37, dtype=np.int32)]
    dag, plan = prefix_dag.plan_batch(prompts, block=16)
    jdag, jplan = jax_dag.plan_batch(prompts, block=16)
    assert dag.nodes == jdag.nodes and (dag.hits, dag.misses) == (jdag.hits, jdag.misses)
    assert plan.unique_chains == jplan.unique_chains and plan.groups == jplan.groups
    assert all(np.array_equal(a, b) for a, b in zip(plan.tails, jplan.tails, strict=True))
    assert (plan.total_tokens, plan.unique_tokens, plan.savings) == (
        jplan.total_tokens, jplan.unique_tokens, jplan.savings)


def test_run_with_prefix_dag_matches_the_reference_and_copies_the_chain_cache(monkeypatch):
    jcfg, params, model = _models("float32")
    prompts = _prompts(jcfg.vocab)
    max_len = 48
    chain_caches = []

    def init_cache_kept(*args, **kwargs):
        chain_caches.append(init_cache(*args, **kwargs))
        return chain_caches[-1]

    monkeypatch.setattr(prefix_dag, "init_cache", init_cache_kept)
    want, _, jplan = jax_dag.run_with_prefix_dag(params, jcfg, prompts, max_len)
    got, caches, plan = prefix_dag.run_with_prefix_dag(model, model.cfg, prompts, max_len)
    # the members' tails went into copies: each chain's own cache holds its
    # chain and nothing past it
    dag, _ = prefix_dag.plan_batch(prompts)
    chain_lens = [len(dag.chain_tokens(blk)) for blk in plan.unique_chains]
    assert len(chain_caches) == len(chain_lens)
    for cache, n in zip(chain_caches, chain_lens, strict=True):
        assert all(not c["k"][:, n:].any() and not c["v"][:, n:].any() for c in cache)
    assert plan.groups == jplan.groups and len(plan.groups[plan.unique_chains[-1]]) >= 1
    assert any(len(members) == 2 for members in plan.groups.values())
    _close(got, want, 1e-4)
    # each request's cache holds its own tail, as a prefill of it alone does
    for prompt, cache in zip(prompts, caches, strict=True):
        alone = init_cache(model.cfg, 1, max_len, device="cpu")
        _, alone = prefill(model, model.cfg, torch.from_numpy(prompt[None]), alone)
        assert cache[0]["len"] == len(prompt)
        for c, a in zip(cache, alone, strict=True):
            _close(c["k"], a["k"].numpy(), 1e-5)
            _close(c["v"], a["v"].numpy(), 1e-5)


# --------------------------------------------------------------------------- #
# Launcher
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("prefix_dag_flag", [False, True])
def test_launcher_runs_on_the_cpu_when_asked(capsys, prefix_dag_flag):
    argv = ["--reduced", "--device", "cpu", "--requests", "3", "--prompt-len", "40",
            "--gen", "4"] + (["--prefix-dag"] if prefix_dag_flag else [])
    assert launcher.main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3 + prefix_dag_flag
    assert lines[-3].startswith("prefill: 3×40 tokens in ")
    assert lines[-2].startswith("decode: 3 steps × 3 seqs -> ") and lines[-2].endswith("tok/s")
    assert lines[-1].startswith("sample continuation: [")


def test_serve_is_prefill_then_greedy_decode_steps():
    """serve() generates what the port's own prefill + decode_step loop
    does (each of which matches the reference above)."""
    _, _, model = _models("float32")
    cfg = model.cfg
    prompts = launcher.make_prompts(cfg.vocab, 3, 24, 16, seed=4)
    out = launcher.serve(model, cfg, prompts, gen=5)
    logits, cache = prefill(model, cfg, torch.from_numpy(np.stack(prompts)),
                            init_cache(cfg, 3, 29, device="cpu"))
    toks = [logits.argmax(dim=-1)[:, None].to(torch.int32)]
    for i in range(4):
        logits, cache = decode_step(model, cfg, toks[-1], cache, 24 + i)
        toks.append(logits.argmax(dim=-1)[:, None].to(torch.int32))
    assert torch.equal(out["tokens"], torch.cat(toks, dim=1))
    assert torch.equal(out["logits"], logits)
    assert out["savings"] is None and out["t_prefill"] > 0 and out["t_decode"] > 0
