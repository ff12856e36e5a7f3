"""The MoE, MLA, Mamba and RWKV-6 archs on the card, against the CPU.

* Each of deepseek-v2-lite-16b, llama4-maverick-400b-a17b,
  jamba-1.5-large-398b and rwkv6-1.6b at a reduced size that keeps its
  kinds (``PATTERNS``), float32, from one seeded model: a forward, a
  prefill and three decode steps (the GQA layers' through the
  ``decode_attention`` kernel) on ``cuda`` within 1e-4 of the CPU's; the
  gradients of one batch, each leaf within 1e-4 of its largest value; and
  two AdamW steps' loss, grad_norm and lr within 1e-4 relative.  (The
  AdamW state after the steps is held leaf by leaf in ``chip_smoke.py``'s
  blocks phase (e).  Adam divides each element's gradient by its own RMS,
  so where a gradient element is near zero its float32 noise becomes a
  step: RWKV-6's zero-initialised ``u_bonus`` moved by up to 1.7e-4 of its
  largest value card against CPU on this batch, and its layer-0 gradients
  are ill-conditioned at init: summing one dot product of its recurrence in
  another order moves them by 3e-5 of a leaf's largest value on the CPU,
  PERF.md §6.)  A top-1 router (llama4's) gets no gradient in exact
  arithmetic, so its gradient is float noise on both devices and is held
  to be noise (below 1e-8), not equal (``test_torch_arch_steps.py``).
* One MLA layer and one MoE layer at DeepSeek-V2-Lite's published widths,
  float32, 256 tokens: the router's expert choice equal to the CPU's (a
  flip is reported with its token) and the outputs within 1e-4 of their
  largest value.
* ``decode_attention`` at llama4's shape (40 query heads over 8 KV heads:
  rep 5, head dim 128) against its plain version.
* ``python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b
  --reduced`` on the card (``reduced()`` turns it into GQA blocks).

Runs only where a CUDA device is present; on a host without one every test
here skips.  Imports nothing of the JAX package (``PATTERNS`` and
``kinds_kept`` serve the CPU parity tests too):

    PYTHONPATH=src python -m pytest -q tests/test_torch_archs_cuda.py
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import decode_step, forward, init_cache, init_params, prefill
from repro_torch.models.convert import state_from_numpy, state_to_numpy

# each arch's reduced config with its block kinds kept: reduced() alone
# resets layer_pattern (ROADMAP §3), so MoE and MLA archs would be GQA
PATTERNS = {
    "deepseek-v2-lite-16b": dict(n_layers=2, scan_period=2,
                                 layer_pattern=(("mla", "swiglu"), ("mla", "moe"))),
    "llama4-maverick-400b-a17b": dict(n_layers=2, scan_period=2,
                                      layer_pattern=(("gqa", "swiglu"), ("gqa", "moe"))),
    "jamba-1.5-large-398b": dict(n_layers=8, scan_period=8,
                                 layer_pattern=get_config("jamba-1.5-large-398b").layer_pattern[:8]),
    "rwkv6-1.6b": {},
}
TOL = 1e-4
NOISE = 1e-8


def kinds_kept(arch: str, **overrides):
    """The port's reduced config of ``arch`` with its kinds kept."""
    return get_config(arch).reduced(**{**PATTERNS[arch], **overrides})


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: these blocks run on the card here")


def _close(got, want, what):
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    err = float((got - want).abs().max())
    assert err <= TOL * max(float(want.abs().max()), 1.0), (what, err)


def _top1_routers(cfg) -> set[str]:
    """The port's names of the routers of a top-1 MoE (module docstring)."""
    if cfg.moe is None or cfg.moe.top_k != 1:
        return set()
    return {f"blocks.{i}.ffn.router" for i, (_m, f) in enumerate(cfg.layer_pattern) if f == "moe"}


@pytest.mark.parametrize("arch", list(PATTERNS))
def test_serving_on_the_card_equals_the_cpu(card, arch):
    cfg = kinds_kept(arch, dtype="float32")
    cpu_model = init_params(0, cfg, "cpu")
    models = {"cuda": copy.deepcopy(cpu_model).to("cuda"), "cpu": cpu_model}
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (3, 14)))
    out = {}
    for dev, model in models.items():
        t = toks.to(dev)
        logits, _ = forward(model, cfg, tokens=t)
        cache = init_cache(cfg, 3, 14, dev)
        steps = [prefill(model, cfg, t[:, :11], cache)[0]]
        for i in range(11, 14):
            last, cache = decode_step(model, cfg, t[:, i:i + 1], cache, i)
            steps.append(last)
        out[dev] = (logits, steps)
    _close(out["cuda"][0], out["cpu"][0], "forward")
    for i, (a, b) in enumerate(zip(out["cuda"][1], out["cpu"][1])):
        _close(a, b, f"step {i}")


@pytest.mark.parametrize("arch", list(PATTERNS))
def test_gradients_and_train_steps_on_the_card_equal_the_cpu(card, arch):
    from repro_torch.models import lm_loss
    from repro_torch.train.train_step import make_train_step

    cfg = kinds_kept(arch, dtype="float32")
    cpu_model = init_params(0, cfg, "cpu")
    rng = np.random.default_rng(2)
    batches = [rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32) for _ in range(2)]
    grads = {}
    for dev, model in (("cuda", copy.deepcopy(cpu_model).to("cuda")), ("cpu", cpu_model)):
        model.requires_grad_(True)
        loss = lm_loss(model, cfg, {"tokens": torch.as_tensor(batches[0], device=dev)})
        names, params = zip(*model.named_parameters())
        grads[dev] = dict(zip(names, (g.cpu() for g in torch.autograd.grad(loss, params))))
        model.requires_grad_(False)
    for name, want in grads["cpu"].items():
        got = grads["cuda"][name]
        if name in _top1_routers(cfg):
            assert max(float(got.abs().max()), float(want.abs().max())) < NOISE, name
            continue
        err = float((got - want).abs().max())
        assert err <= TOL * float(want.abs().max()), (name, err, float(want.abs().max()))

    init_state, step = make_train_step(cfg, "adamw", base_lr=1e-4, warmup=1, total_steps=10)
    tree = state_to_numpy(init_state(cpu_model))
    metrics = {}
    for dev in ("cuda", "cpu"):
        state = state_from_numpy(tree, cfg, dev)
        for b in batches:
            state, m = step(state, {"tokens": torch.as_tensor(b, device=dev)})
        metrics[dev] = {k: float(v) for k, v in m.items()}
    for k, v in metrics["cuda"].items():
        assert v == pytest.approx(metrics["cpu"][k], rel=TOL), k


def test_full_width_mla_and_moe_layers_on_the_card_equal_the_cpu(card):
    from repro_torch.models import attention, moe

    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b"), dtype="float32")
    gen = torch.Generator().manual_seed(0)
    mla = attention.MLA(cfg, torch.float32, "cpu")
    mla.reset_parameters(gen)
    ffn = moe.moe_init(gen, cfg, torch.float32, "cpu")
    x = torch.randn((2, 128, cfg.d_model), generator=gen)
    pos = torch.arange(128, dtype=torch.int32).expand(2, 128)
    want_mla, _ = attention.mla_apply(mla, x, cfg, pos)
    got_mla, _ = attention.mla_apply(mla.to("cuda"), x.cuda(), cfg, pos.cuda())
    _close(got_mla, want_mla, "mla")
    xg = x.reshape(1, 256, -1)
    cap = moe.capacity_of(256, cfg.moe)
    want_route = moe._route(ffn, xg, cfg.moe, cap)
    ffn_card = copy.deepcopy(ffn).to("cuda")
    got_route = moe._route(ffn_card, xg.cuda(), cfg.moe, cap)
    for i, name in ((0, "take"), (1, "in_use"), (2, "slot"), (3, "inv"), (5, "stok")):
        flips = torch.nonzero(got_route[i].cpu() != want_route[i]).tolist()
        assert not flips, f"routing ({name}) differs at {flips[:8]}"
    _close(moe.moe_apply(ffn_card, x.cuda(), cfg), moe.moe_apply(ffn, x, cfg), "moe")


def test_decode_attention_at_llama4s_heads_equals_plain(card):
    from repro_torch.kernels import decode_attention as da

    cfg = get_config("llama4-maverick-400b-a17b")
    gen = torch.Generator("cuda").manual_seed(3)
    b, t = 4, 1088
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        q = torch.randn((b, cfg.n_heads, cfg.head_dim), generator=gen, device="cuda", dtype=dtype)
        k, v = (torch.randn((b, t, cfg.n_kv_heads, cfg.head_dim), generator=gen, device="cuda",
                            dtype=dtype) for _ in range(2))
        lens = torch.tensor([1, 300, 1024, t], dtype=torch.int32, device="cuda")
        got, want = da.decode_attention(q, k, v, lens), da.decode_attention_plain(q, k, v, lens)
        assert float((got.float() - want.float()).abs().max()) <= tol


def test_serve_launcher_runs_deepseek_reduced_on_the_card(card, capsys):
    from repro_torch.launch import serve

    assert serve.main(["--arch", "deepseek-v2-lite-16b", "--reduced", "--requests", "2",
                       "--prompt-len", "40", "--gen", "4", "--prefix-dag"]) == 0
    assert "tok/s" in capsys.readouterr().out
