"""The port's train step == the reference's jitted step, 3 steps from one state.

Each case starts both packages from the reference's ``init_state`` of a
reduced registry config (carried over with ``models.convert``) and feeds
both the same seeded numpy batches of the reference's per-arch kinds
(tokens; embeddings + labels for the encoder; embeddings + tokens for the
vision frontend).  Every GQA arch runs with AdamW on one batch and with
Adafactor on two microbatches (SmolLM also with the other two pairs);
deepseek-v2-lite, whose reduced config is 54 layers (a scan unit of 27
stacked twice, the heaviest reference compile of the registry), runs the
Adafactor case only.  rwkv6's reduced config keeps its RWKV-6 mixer; it and
the MoE, MLA and Mamba archs with their kinds kept are in
``test_torch_arch_steps.py``.

Tolerances:
  * float32: loss, grad_norm and lr within 1e-5 relative, every parameter
    and optimizer tensor within 1e-5.  Matrix products accumulate in
    another order in XLA and in PyTorch (relative 1e-7 to 1e-6), and Adam
    divides each gradient by its own RMS: on an element whose gradient is
    near 1e-9 (the tied table's row of a token far from the batch, summed
    from canceling terms) a few percent of that gradient differ, and so
    does its step.  The learning rate is 1e-4, so such a step's error
    (seen: 2.4e-5 at 1e-3) stays inside 1e-5; the other elements differ by
    about 1e-7.
  * bfloat16: the two packages round activations at other places (see
    test_torch_lm.py), so the gradients differ near 1e-3 relative and
    rounding each new parameter to bfloat16 turns that into a one-ulp flip
    on a few percent of the elements.  Loss and grad_norm are held to 2e-3
    relative (half a bfloat16 ulp, 2^-8), each parameter leaf's mean
    absolute difference to 5% of the mean absolute update the reference
    made (seen: at most 1.9% at 1e-3), and a leaf the reference left as it
    was must be left as it was.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import init_params as jax_init
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.configs import CONFIGS, get_config
from repro_torch.models.convert import state_from_numpy, state_to_numpy
from repro_torch.train.train_step import make_train_step

from test_torch_train import F32_TOL, _np, _smoke_batch, _to_jax, _to_torch, _tree_close

BF16_METRIC_TOL = 2e-3
BF16_UPDATE_SHARE = 0.05
F32_LR = 1e-4  # module docstring
BF16_LR = 1e-3  # an update of 1e-4 rounds away on most bfloat16 weights


GQA_ARCHS = sorted(a for a in CONFIGS if CONFIGS[a].reduced().mixer == "gqa")
HEAVY = "deepseek-v2-lite-16b"  # Adafactor only (module docstring)
STEP_CASES = ([(a, "adamw", 1) for a in GQA_ARCHS if a != HEAVY]
              + [(a, "adafactor", 2) for a in GQA_ARCHS]
              + [("smollm-135m", "adamw", 2), ("smollm-135m", "adafactor", 1)])
_JAX_STEPS = {}


def _run_both(arch, opt, mb, dtype, base_lr, steps=3):
    """``steps`` train steps of each package from the reference's init state;
    returns (reference metrics, port metrics, reference state, port state,
    initial reference params)."""
    jcfg = jax_config(arch).reduced(dtype=dtype)
    cfg = get_config(arch).reduced(dtype=dtype)
    j_init_state, j_step = jax_make_train_step(jcfg, opt, mb, base_lr, warmup=1, total_steps=10)
    key = (arch, opt, mb, dtype, base_lr)
    if key not in _JAX_STEPS:
        _JAX_STEPS[key] = jax.jit(j_step)
    jstate = j_init_state(jax_init(jax.random.key(0), jcfg))
    p0 = jax.tree.map(_np, jstate["params"])
    init_state, step = make_train_step(cfg, opt, mb, base_lr, warmup=1, total_steps=10)
    state = state_from_numpy(jax.tree.map(np.asarray, jstate), cfg, "cpu")
    rng = np.random.default_rng(11)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    jms, ms = [], []
    for _ in range(steps):
        batch = _smoke_batch(cfg, rng)
        jstate, jm = _JAX_STEPS[key](jstate, _to_jax(batch, jdt))
        state, m = step(state, _to_torch(batch, tdt))
        jms.append({k: float(v) for k, v in jm.items()})
        ms.append({k: float(v) for k, v in m.items()})
    return jms, ms, jax.tree.map(np.asarray, jstate), state, p0


@pytest.mark.parametrize("arch,opt,mb", STEP_CASES)
def test_train_step_equals_reference_float32(arch, opt, mb):
    jms, ms, jstate, state, _ = _run_both(arch, opt, mb, "float32", F32_LR)
    for jm, m in zip(jms, ms):
        for k in ("loss", "grad_norm", "lr"):
            assert m[k] == pytest.approx(jm[k], rel=F32_TOL, abs=1e-12), (k, jms, ms)
    got = state_to_numpy(state)
    assert int(got["step"]) == int(jstate["step"]) == 3
    _tree_close(got["params"], jstate["params"])
    _tree_close(got["opt"], jstate["opt"])


@pytest.mark.parametrize("opt,mb", [("adamw", 1), ("adafactor", 2)])
def test_train_step_bfloat16_close_to_reference(opt, mb):
    jms, ms, jstate, state, p0 = _run_both("smollm-135m", opt, mb, "bfloat16", BF16_LR)
    for jm, m in zip(jms, ms):
        for k in ("loss", "grad_norm", "lr"):
            assert m[k] == pytest.approx(jm[k], rel=BF16_METRIC_TOL), (k, jms, ms)
    got = state_to_numpy(state)["params"]
    for g, w, p in zip(jax.tree.leaves(got), jax.tree.leaves(jstate["params"]), jax.tree.leaves(p0)):
        moved = np.abs(_np(w) - p).mean()
        if moved == 0:
            np.testing.assert_array_equal(_np(g), p)
        else:
            assert np.abs(_np(g) - _np(w)).mean() <= BF16_UPDATE_SHARE * moved
