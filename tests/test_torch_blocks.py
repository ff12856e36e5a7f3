"""The port's MoE, MLA, Mamba and RWKV-6 blocks == the reference's, module by module.

Each block's parameters come from the reference's init (``moe_init``,
``mla_init``, ``mamba_init``, ``rwkv6_tm_init``, ``rwkv6_cm_init``) and are
copied into the port's module by name; inputs are made with numpy from a
seed and handed to both packages.  The configs are reduced ones that keep
each kind (``reduced(layer_pattern=...)``: ``reduced()`` alone resets the
pattern).

Tolerances: float32 1e-4 absolute and relative (``test_torch_lm.py``'s
``_close``); bfloat16 0.15 times the RMS of the reference's output
(``BF16_TOL``: the two packages round at other places).  The router's
``_route`` indices are equal with no tolerance and its gates within 1e-6,
on inputs whose top-k choice has no near-tie (each token's k-th and
(k+1)-th probabilities at least 1e-4 apart, asserted); a flipped expert is
reported with its token, never absorbed by a tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as jatt
import repro.models.moe as jmoe
import repro.models.ssm as jssm
from repro.configs import get_config as jax_config
from repro_torch.configs import get_config
from repro_torch.models import attention, moe, ssm
from repro_torch.tree import flatten_with_names

from test_torch_archs_cuda import PATTERNS
from test_torch_lm import BF16_TOL, _close

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# the reference's functions jitted, the config static (eager dispatch of its
# scans costs seconds a call)
J_ROUTE = jax.jit(jmoe._route, static_argnums=(2, 3))
J_MOE = jax.jit(jmoe.moe_apply, static_argnums=2)
J_MLA = jax.jit(jatt.mla_apply, static_argnums=2)
J_MAMBA = jax.jit(jssm.mamba_apply, static_argnums=2)
J_TM = jax.jit(jssm.rwkv6_tm_apply, static_argnums=2)
J_CM = jax.jit(jssm.rwkv6_cm_apply, static_argnums=2)


def configs(arch, dtype="float32", **overrides):
    """(reference cfg, port cfg) of ``arch`` reduced with its kinds kept."""
    kw = {**PATTERNS[arch], "dtype": dtype, **overrides}
    return jax_config(arch).reduced(**kw), get_config(arch).reduced(**kw)


def no_drops(cfg):
    """``cfg`` with capacity_factor E/k: every expert's capacity C >= Tg."""
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k))


def load(module, jparams):
    """The port ``module`` with the reference's leaves copied in by name."""
    flat = dict(flatten_with_names(jax.tree.map(lambda a: np.asarray(a, np.float32), jparams)))
    names = dict(module.named_parameters())
    assert sorted(n.replace(".", "/") for n in names) == sorted(flat)
    with torch.no_grad():
        for name, p in names.items():
            p.copy_(torch.from_numpy(np.array(flat[name.replace(".", "/")])))
    return module


def check(dtype, got, want):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if dtype == "float32":
        _close(got, want, 1e-4)
    else:
        err = np.abs(got.float().numpy() - want).max()
        rms = np.sqrt(np.mean(want ** 2))
        assert err <= BF16_TOL * rms, (err, rms)


def inputs(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def skewed(rng, shape):
    """Tokens that share one offset, so the router sends many of them to the
    same experts and some overflow their capacity."""
    return (rng.standard_normal(shape) + 1.5 * rng.standard_normal(shape[-1])).astype(np.float32)


# --------------------------------------------------------------------------- #
# MoE
# --------------------------------------------------------------------------- #


def _moe_pair(dtype, capacity_factor=None):
    jcfg, cfg = configs("deepseek-v2-lite-16b", dtype)
    if capacity_factor == "none":
        jcfg, cfg = no_drops(jcfg), no_drops(cfg)
    jp = jmoe.moe_init(jax.random.key(3), jcfg, DTYPES[dtype][0])
    return jcfg, cfg, jp, load(moe.MoE(cfg, DTYPES[dtype][1], "cpu"), jp)


def _tie_free(x, router, k):
    """Each token's k-th and (k+1)-th router probabilities differ by 1e-4
    or more (float64), so float32 noise cannot flip the choice."""
    logits = x.reshape(-1, x.shape[-1]).astype(np.float64) @ router.astype(np.float64)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = np.sort(p / p.sum(-1, keepdims=True), axis=-1)[:, ::-1]
    return float((p[:, k - 1] - p[:, k]).min())


@pytest.mark.parametrize("groups", [1, 2])
def test_route_indices_equal_the_reference(groups):
    jcfg, cfg, jp, mod = _moe_pair("float32")
    m = cfg.moe
    rng = np.random.default_rng(4)
    x = skewed(rng, (groups, 24, cfg.d_model))
    assert _tie_free(x, np.asarray(jp["router"]), m.top_k) > 1e-4
    capacity = moe.capacity_of(24, m)
    assert capacity == int(np.ceil(24 * m.top_k / m.num_experts * m.capacity_factor))
    want = J_ROUTE(jp, jnp.asarray(x), jcfg.moe, capacity)
    got = moe._route(mod, torch.from_numpy(x), m, capacity)
    names = ("take", "in_use", "slot", "inv", "sgate", "stok")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, name
        if name == "sgate":
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6)
        else:
            flips = np.argwhere(g.numpy() != w)
            assert not len(flips), f"{name} differs at {flips[:8].tolist()}"
    # drops happen at this capacity: some sorted entries carry no gate
    assert (got[4] == 0).any()


@pytest.mark.parametrize("drops", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_apply_equals_the_reference(dtype, drops):
    jcfg, cfg, jp, mod = _moe_pair(dtype, None if drops else "none")
    xs = skewed(np.random.default_rng(5), (2, 12, cfg.d_model))
    jx, x = jnp.asarray(xs, DTYPES[dtype][0]), torch.from_numpy(xs).to(DTYPES[dtype][1])
    assert _tie_free(np.asarray(jx, np.float32), np.asarray(jp["router"]), cfg.moe.top_k) > 1e-4
    want = J_MOE(jp, jx, jcfg)
    got = moe.moe_apply(mod, x, cfg)
    assert got.dtype == x.dtype and tuple(got.shape) == want.shape
    check(dtype, got, want)
    capacity = moe.capacity_of(24, cfg.moe)
    sgate = moe._route(mod, x.reshape(1, 24, -1), cfg.moe, capacity)[4]
    assert bool((sgate == 0).any()) == drops  # with drops some entries lose their gate
    assert (capacity >= 24) == (not drops)  # without, C >= Tg


# --------------------------------------------------------------------------- #
# MLA
# --------------------------------------------------------------------------- #


def _positions(b, s, start=0):
    return np.broadcast_to(np.arange(start, start + s, dtype=np.int32), (b, s)).copy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_apply_equals_the_reference(dtype):
    """No cache; a prefill of 6 tokens against a cache; two decode steps."""
    jcfg, cfg = configs("deepseek-v2-lite-16b", dtype)
    jdt, tdt = DTYPES[dtype]
    jp = jatt.mla_init(jax.random.key(6), jcfg, jdt)
    mod = load(attention.MLA(cfg, tdt, "cpu"), jp)
    rng = np.random.default_rng(6)
    b = 2
    jx, x = inputs(rng, (b, 9, cfg.d_model), dtype)
    pos = _positions(b, 9)
    want, _ = J_MLA(jp, jx, jcfg, jnp.asarray(pos))
    got, none = attention.mla_apply(mod, x, cfg, torch.from_numpy(pos))
    assert none is None
    check(dtype, got, want)

    jcache = jatt.mla_cache_init(jcfg, b, 10, jdt)
    cache = attention.mla_cache_init(cfg, b, 10, tdt, "cpu")
    steps = [(0, 6), (6, 7), (7, 8)]
    for lo, hi in steps:
        p = pos[:, lo:hi]
        want, jcache = J_MLA(jp, jx[:, lo:hi], jcfg, jnp.asarray(p), cache=jcache)
        got, cache = attention.mla_apply(mod, x[:, lo:hi], cfg, torch.from_numpy(p), cache=cache)
        check(dtype, got, want)
        assert cache["len"] == int(jcache["len"]) == hi
    check(dtype, cache["latent"], jcache["latent"])
    check(dtype, cache["krope"], jcache["krope"])


# --------------------------------------------------------------------------- #
# Mamba and RWKV-6
# --------------------------------------------------------------------------- #


def _mamba_pair(dtype, time_chunk=0):
    jcfg, cfg = configs("jamba-1.5-large-398b", dtype)
    if time_chunk:
        jcfg = dataclasses.replace(jcfg, ssm=dataclasses.replace(jcfg.ssm, time_chunk=time_chunk))
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, time_chunk=time_chunk))
    jdt, tdt = DTYPES[dtype]
    jp = jssm.mamba_init(jax.random.key(7), jcfg, jdt)
    return jcfg, cfg, jp, load(ssm.Mamba(cfg, tdt, "cpu"), jp)


def test_mamba_deterministic_leaves_equal_the_reference():
    jcfg, cfg = configs("jamba-1.5-large-398b")
    jp = jssm.mamba_init(jax.random.key(0), jcfg, jnp.float32)
    mod = ssm.Mamba(cfg, torch.float32, "cpu")
    mod.reset_parameters(torch.Generator().manual_seed(0))
    for name in ("conv_b", "dt_bias", "a_log", "d_skip"):
        np.testing.assert_array_equal(getattr(mod, name).detach().numpy(), np.asarray(jp[name]))
    assert mod.a_log.dtype == mod.d_skip.dtype == mod.dt_bias.dtype == torch.float32
    bf = ssm.Mamba(cfg, torch.bfloat16, "cpu")
    assert bf.a_log.dtype == torch.float32 and bf.w_in.dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_apply_equals_the_reference(dtype):
    """No cache over 10 steps; then a prefill of 7 and three decode steps
    against a cache, each output and the final state."""
    jcfg, cfg, jp, mod = _mamba_pair(dtype)
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(8)
    jx, x = inputs(rng, (2, 10, cfg.d_model), dtype)
    want, _ = J_MAMBA(jp, jx, jcfg)
    got, none = ssm.mamba_apply(mod, x, cfg)
    assert none is None
    check(dtype, got, want)
    jcache = jssm.mamba_cache_init(jcfg, 2, jdt)
    cache = ssm.mamba_cache_init(cfg, 2, tdt, "cpu")
    for lo, hi in [(0, 7), (7, 8), (8, 9), (9, 10)]:
        want, jcache = J_MAMBA(jp, jx[:, lo:hi], jcfg, cache=jcache)
        got, cache = ssm.mamba_apply(mod, x[:, lo:hi], cfg, cache=cache)
        check(dtype, got, want)
    assert cache["h"].dtype == torch.float32
    check(dtype, cache["h"], jcache["h"])
    check(dtype, cache["conv"], jcache["conv"])


def test_mamba_time_chunk_values_and_grads_equal_the_reference():
    """``time_chunk`` 4 over 12 steps: the chunked recurrence (checkpointed
    while gradients are recorded) gives the reference's output and the
    reference's gradients of a seeded projection of it."""
    jcfg, cfg, jp, mod = _mamba_pair("float32", time_chunk=4)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    proj = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jssm.mamba_apply(p, xx, jcfg)[0] * proj)

    want_loss, (want_gp, want_gx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    mod.requires_grad_(True)
    out, _ = ssm.mamba_apply(mod, xt, cfg)
    loss = (out * torch.from_numpy(proj)).sum()
    loss.backward()
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    _close(xt.grad, want_gx, 1e-4)
    for name, p in mod.named_parameters():
        _close(p.grad, want_gp[name], 1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_blocks_equal_the_reference(dtype):
    """Time mix and channel mix: no cache over 9 steps; then a prefill of 5
    and decode steps against a cache, each output and the states."""
    jcfg, cfg = configs("rwkv6-1.6b", dtype)
    jdt, tdt = DTYPES[dtype]
    jtm = jssm.rwkv6_tm_init(jax.random.key(10), jcfg, jdt)
    # the reference's w0 and u_bonus are constants; seeded values reach every
    # term of the recurrence (float32 leaves, as the reference's)
    rng = np.random.default_rng(10)
    jtm["w0"] = jnp.asarray(rng.uniform(-3, 0, jtm["w0"].shape), jnp.float32)
    jtm["u_bonus"] = jnp.asarray(rng.standard_normal(jtm["u_bonus"].shape), jnp.float32)
    jcm = jssm.rwkv6_cm_init(jax.random.key(11), jcfg, jdt)
    tm = load(ssm.RWKV6TimeMix(cfg, tdt, "cpu"), jtm)
    cm = load(ssm.RWKV6ChannelMix(cfg, tdt, "cpu"), jcm)
    assert tm.w0.dtype == tm.u_bonus.dtype == torch.float32
    jx, x = inputs(rng, (2, 9, cfg.d_model), dtype)

    want, _ = J_TM(jtm, jx, jcfg)
    got, _ = ssm.rwkv6_tm_apply(tm, x, cfg)
    check(dtype, got, want)
    want, _ = J_CM(jcm, jx, jcfg)
    got, _ = ssm.rwkv6_cm_apply(cm, x, cfg)
    check(dtype, got, want)

    jtc, jcc = jssm.rwkv6_tm_cache_init(jcfg, 2, jdt), jssm.rwkv6_cm_cache_init(jcfg, 2, jdt)
    tc, cc = ssm.rwkv6_tm_cache_init(cfg, 2, tdt, "cpu"), ssm.rwkv6_cm_cache_init(cfg, 2, tdt, "cpu")
    for lo, hi in [(0, 5), (5, 6), (6, 7)]:
        want, jtc = J_TM(jtm, jx[:, lo:hi], jcfg, cache=jtc)
        got, tc = ssm.rwkv6_tm_apply(tm, x[:, lo:hi], cfg, cache=tc)
        check(dtype, got, want)
        want, jcc = J_CM(jcm, jx[:, lo:hi], jcfg, cache=jcc)
        got, cc = ssm.rwkv6_cm_apply(cm, x[:, lo:hi], cfg, cache=cc)
        check(dtype, got, want)
    assert tc["s"].dtype == torch.float32
    check(dtype, tc["s"], jtc["s"])
    check(dtype, tc["last"], jtc["last"])
    check(dtype, cc["last"], jcc["last"])


def test_rwkv6_deterministic_leaves_equal_the_reference():
    jcfg, cfg = configs("rwkv6-1.6b")
    jtm = jssm.rwkv6_tm_init(jax.random.key(0), jcfg, jnp.bfloat16)
    tm = ssm.RWKV6TimeMix(cfg, torch.bfloat16, "cpu")
    for mod in tm.modules():
        mod.reset_parameters(torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(tm.w0.numpy(), np.asarray(jtm["w0"]))
    np.testing.assert_array_equal(tm.u_bonus.numpy(), np.asarray(jtm["u_bonus"]))
    np.testing.assert_array_equal(tm.ln_out.scale.float().numpy(),
                                  np.asarray(jtm["ln_out"]["scale"], np.float32))
