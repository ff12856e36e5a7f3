"""The Mamba scan and RWKV-6 WKV CUDA kernels == their plain PyTorch versions, on the card.

Runs only where a CUDA device is present (the kernels have no CPU mode); on
a host without one every test here skips.  Imports nothing of the JAX
package, so it runs on a card host that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_ssm_scan_cuda.py

Tolerances: float32 outputs and gradients within 1e-4 of each one's
largest value (the kernels sum over N and hd in another order than the
plain versions, and take their exps with CUDA's expf); a gradient in
bfloat16 within 1e-2 (two float32 values that close may round to
neighbouring bfloat16 values, 2^-8 apart).  Two backward calls on the same
inputs must give the same bits: the kernels add their cross-block sums in a
fixed order.  The cases sit at the kernels' edges: S one below and above
the forward tiles (RWKV-6 16 steps, Mamba 8) and the backward chunks (8),
E off the blocks (forward 128 channels, backward 64), B x H below and
above the card's 132 SMs, every built size at both stream types, and the
padded sizes.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, ssm_scan

DTYPES = (torch.float32, torch.bfloat16)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the scan kernels have no CPU mode")
    return torch.device("cuda")


def _mamba_inputs(dev, b, s, e, n, dtype, seed=0, carried=True):
    rng = np.random.default_rng(seed)

    def t(shape, scale=1.0, lo=None):
        x = rng.uniform(lo, scale, shape) if lo is not None else rng.standard_normal(shape) * scale
        return torch.from_numpy(x.astype(np.float32)).to(dev)

    h0 = t((b, e, n)) if carried else torch.zeros((b, e, n), device=dev)
    dt = t((b, s, e), 0.3, 0.001).to(dtype)
    bm, cm, x = t((b, s, n)).to(dtype), t((b, s, n)).to(dtype), t((b, s, e)).to(dtype)
    a = -t((e, n), 2.0, 0.1)
    return h0, dt, bm, cm, x, a


def _rwkv_inputs(dev, b, s, h, hd, dtype, seed=0, carried=True):
    rng = np.random.default_rng(seed)

    def t(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    s0 = t((b, h, hd, hd)) if carried else torch.zeros((b, h, hd, hd), device=dev)
    r, k, v = (t((b, s, h, hd), 0.5).to(dtype) for _ in range(3))
    w = torch.exp(-torch.exp(t((b, s, h, hd), 0.5) - 2.0))
    u = t((h, hd), 0.5)
    return s0, r, k, v, w, u


def _close(got, want, what):
    torch.cuda.synchronize()
    tol = 1e-4 if want.dtype == torch.float32 else 1e-2
    assert got.dtype == want.dtype and got.shape == want.shape, what
    err = float((got.float() - want.float()).abs().max())
    scale = max(float(want.float().abs().max()), 1e-30)
    assert err <= tol * scale, f"{what}: max abs err {err} over {tol} x {scale}"


def _grads(inputs, out_shapes, seed=1):
    gen = torch.Generator(inputs[0].device).manual_seed(seed)
    return [torch.randn(s, generator=gen, device=inputs[0].device) for s in out_shapes]


MAMBA_CASES = [  # b, s, e, n
    (2, 1, 64, 16),     # one step: a decode
    (2, 100, 200, 16),  # S not a multiple of the tiles, E not of the block
    (1, 257, 128, 8),
    (3, 33, 300, 8),
    (2, 40, 96, 4),     # N not built: padded to 8
    (1, 70, 160, 12),   # padded to 16
    (1, 7, 100, 16),    # S one below a tile and a chunk; E off both blocks
    (2, 9, 130, 8),     # S one above; E one block and a bit
    (1, 15, 64, 16),    # S one below two chunks; E one backward block
    (1, 17, 65, 8),     # one above; E one past a backward block
]


@pytest.mark.parametrize("b,s,e,n", MAMBA_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_kernel_equals_plain(cuda, b, s, e, n, dtype):
    args = _mamba_inputs(cuda, b, s, e, n, dtype, seed=b * s + e)
    before = ssm_scan.LAUNCHES["mamba_scan"]
    y, h = ssm_scan.mamba_scan(*args)
    assert ssm_scan.LAUNCHES["mamba_scan"] == before + 1
    wy, wh = ssm_scan.mamba_scan_plain(*args)
    _close(y, wy, "y")
    _close(h, wh, "h_last")
    gy, gh = _grads(args, (y.shape, h.shape))
    got = ssm_scan.MAMBA_BWD_OP(gy, gh, *args)
    want = ssm_scan.mamba_scan_backward_plain(gy, gh, *args)
    for name, g, w in zip(("dh0", "ddt", "dB", "dC", "dx", "da"), got, want):
        _close(g, w, name)
    again = ssm_scan.MAMBA_BWD_OP(gy, gh, *args)
    for g, g2 in zip(got, again):
        assert torch.equal(g, g2), "two backward calls differ"


RWKV_CASES = [  # b, s, h, hd
    (2, 1, 4, 64),    # one step: a decode
    (2, 100, 3, 64),  # S not a multiple of the tile or the chunk
    (1, 50, 4, 32),
    (3, 17, 2, 32),
    (2, 40, 2, 16),   # hd not built: padded to 32
    (1, 21, 3, 48),   # padded to 64
    (1, 7, 2, 64),    # S one below a backward chunk
    (1, 9, 3, 32),    # one above
    (1, 15, 2, 64),   # one below a forward tile
    (2, 17, 1, 32),   # one above
    (3, 33, 2, 64),   # past the backward's ring of 4 chunks
    (4, 20, 40, 64),  # B x H 160: above the card's 132 SMs
]


@pytest.mark.parametrize("b,s,h,hd", RWKV_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_rwkv6_kernel_equals_plain(cuda, b, s, h, hd, dtype):
    args = _rwkv_inputs(cuda, b, s, h, hd, dtype, seed=b * s + h)
    before = ssm_scan.LAUNCHES["rwkv6_wkv"]
    y, st = ssm_scan.rwkv6_wkv(*args)
    assert ssm_scan.LAUNCHES["rwkv6_wkv"] == before + 1
    wy, wst = ssm_scan.rwkv6_wkv_plain(*args)
    _close(y, wy, "y")
    _close(st, wst, "s_last")
    gy, gs = _grads(args, (y.shape, st.shape))
    got = ssm_scan.RWKV_BWD_OP(gy, gs, *args)
    want = ssm_scan.rwkv6_wkv_backward_plain(gy, gs, *args)
    for name, g, w in zip(("ds0", "dr", "dk", "dv", "dw", "du"), got, want):
        _close(g, w, name)
    again = ssm_scan.RWKV_BWD_OP(gy, gs, *args)
    for g, g2 in zip(got, again):
        assert torch.equal(g, g2), "two backward calls differ"


def test_autograd_runs_the_backward_kernels(cuda):
    margs = [t.requires_grad_() for t in _mamba_inputs(cuda, 2, 40, 96, 16, torch.float32)]
    rargs = [t.requires_grad_() for t in _rwkv_inputs(cuda, 2, 40, 2, 64, torch.float32)]
    before = dict(ssm_scan.LAUNCHES)
    y, h = ssm_scan.mamba_scan(*margs)
    (y.square().sum() + h.sum()).backward()
    y, s = ssm_scan.rwkv6_wkv(*rargs)
    y.square().sum().backward()  # the state's gradient is None: zeros
    for name in ssm_scan.LAUNCHES:
        assert ssm_scan.LAUNCHES[name] == before[name] + 1, name
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in margs + rargs)


def test_the_kernels_refuse_what_they_do_not_take(cuda):
    h0, dt, bm, cm, x, a = _mamba_inputs(cuda, 1, 4, 32, 16, torch.float32)
    with pytest.raises(ValueError, match="state size: the kernel takes at most 16"):
        ssm_scan.MAMBA_OP(*_mamba_inputs(cuda, 1, 4, 32, 20, torch.float32))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ssm_scan.MAMBA_OP(h0, dt.half(), bm.half(), cm.half(), x.half(), a)
    with pytest.raises(ValueError, match="on cpu"):
        ssm_scan.MAMBA_OP(h0, dt, bm, cm, x, a.cpu())
    s0, r, k, v, w, u = _rwkv_inputs(cuda, 1, 4, 2, 64, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        ssm_scan.RWKV_OP(s0, r.transpose(1, 2).contiguous().transpose(1, 2), k, v, w, u)
    with pytest.raises(ValueError, match="head_dim: the kernel takes at most 64"):
        ssm_scan.RWKV_OP(*_rwkv_inputs(cuda, 1, 4, 1, 128, torch.float32))


@pytest.mark.parametrize("kind,sizes", [("mamba", ssm_scan.MAMBA_STATES),
                                        ("rwkv6", ssm_scan.RWKV_HEAD_DIMS)])
def test_launch_plan_matches_the_sources(cuda, kind, sizes):
    """launch_plan's shared memory is what each source computes for its
    blocks, at every built size and stream type."""
    mod = _build.load(ssm_scan._MAMBA_SOURCE if kind == "mamba" else ssm_scan._RWKV_SOURCE)
    smem = mod.mamba_scan_smem if kind == "mamba" else mod.rwkv6_wkv_smem
    for size in sizes:
        for itemsize in (4, 2):
            plan = ssm_scan.launch_plan(kind, 2, 33, 96, size, itemsize)
            assert (smem(size, itemsize, 0), smem(size, itemsize, 1)) == (
                plan.fwd_smem, plan.bwd_smem), (kind, size, itemsize)
