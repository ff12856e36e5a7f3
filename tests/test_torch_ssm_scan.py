"""The port's scan ops (``kernels/ssm_scan.py``) == the reference's ``lax.scan``, values and gradients.

On the CPU the ops run their plain versions, forward and backward.  They
are held against:

  * ``jax.lax.scan`` of the reference's step bodies (copied from
    ``repro.models.ssm._mamba_scan`` and ``rwkv6_tm_apply``) on numpy
    inputs made from a seed, with a carried state, S = 1 and S past a
    backward chunk, and ``jax.grad`` of it for every input's gradient;
  * ``jax.grad`` of the reference's ``_mamba_scan`` (with ``time_chunk``)
    and ``rwkv6_tm_apply`` themselves, for the port's model functions that
    call the ops.

Then the fake implementations' shapes and the FLOP formulas, the DTensor
sharding rules on a 4-rank gloo CPU mesh (2, 2) against one device, and
depth-1 clones of rwkv6-1.6b and jamba-1.5-large-398b x ``prefill_32k``
and ``train_4k`` traced by the dry-run on one device (``lower_step``, the
one-device trace ``lower_cell`` makes beside its mesh trace): one scan op
a layer, one backward op a layer in training, op counts only.

Tolerances: float32 values and gradients within 1e-4 of each one's largest
value (``chip_smoke.BLOCKS_TOL``: the two packages sum over N and hd in
other orders); a gradient in bfloat16 within 1e-2 of its largest (two
float32 values that close may round to neighbouring bfloat16 values, 2^-8
apart); the model functions in bfloat16 within 0.15 x the RMS of the
reference's values (``test_torch_lm.BF16_TOL``: their projections round in
bfloat16 at other places).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

import repro.models.ssm as jssm
from repro_torch.kernels import ssm_scan
from repro_torch.models import ssm

from test_torch_blocks import DTYPES, configs, load
from test_torch_dist import run_ranks
from test_torch_lm import BF16_TOL

TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def close(got, want, what=""):
    """Within TOL (by the port's dtype) of the reference's largest value."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got_np = got.detach().float().numpy()
    assert got_np.shape == want.shape, (what, got_np.shape, want.shape)
    err = float(np.abs(got_np - want).max())
    scale = max(float(np.abs(want).max()), 1e-30)
    assert err <= TOL[got.dtype] * scale, f"{what}: {err} over {TOL[got.dtype]} x {scale}"


def close_to_rms(got, want, what=""):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    err = float(np.abs(got.detach().float().numpy() - want).max())
    rms = float(np.sqrt(np.mean(want ** 2)))
    assert err <= BF16_TOL * rms, f"{what}: {err} over {BF16_TOL} x RMS {rms}"


# --------------------------------------------------------------------------- #
# The reference's step bodies under lax.scan
# --------------------------------------------------------------------------- #


def jax_mamba(h0, dt, bm, cm, x, a):
    """``repro.models.ssm._mamba_scan``'s step, scanned over time."""

    def step(h, inputs):
        dt_t, b_t, c_t, xe_t = inputs
        dt32 = dt_t.astype(jnp.float32)
        da_t = jnp.exp(dt32[..., None] * a)
        h = da_t * h + (dt32 * xe_t.astype(jnp.float32))[..., None] * b_t.astype(
            jnp.float32)[:, None, :]
        return h, jnp.einsum("ben,bn->be", h, c_t.astype(jnp.float32))

    h, ys = jax.lax.scan(step, h0, tuple(jnp.moveaxis(t, 1, 0) for t in (dt, bm, cm, x)))
    return jnp.moveaxis(ys, 0, 1), h


def jax_rwkv6(s0, r, k, v, w, u):
    """``repro.models.ssm.rwkv6_tm_apply``'s step, scanned over time."""
    u = u[None]

    def step(state, inputs):
        r_t, k_t, v_t, w_t = inputs
        kv = k_t[..., :, None] * v_t[..., None, :]
        y = jnp.einsum("bhk,bhkv->bhv", r_t, state + u[..., None] * kv)
        return w_t[..., None] * state + kv, y

    xs = tuple(jnp.moveaxis(t, 1, 0) for t in (r.astype(jnp.float32), k.astype(jnp.float32),
                                                  v.astype(jnp.float32), w))
    s, ys = jax.lax.scan(step, s0, xs)
    return jnp.moveaxis(ys, 0, 1), s


def mamba_inputs(b, s, e, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, e, n)).astype(np.float32),
            rng.uniform(0.001, 0.3, (b, s, e)).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32),
            rng.standard_normal((b, s, e)).astype(np.float32),
            -rng.uniform(0.1, 2.0, (e, n)).astype(np.float32)]


def rwkv_inputs(b, s, h, hd, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((b, s, h, hd)).astype(np.float32) for _ in range(3))
    w = np.exp(-np.exp(0.5 * rng.standard_normal((b, s, h, hd)) - 2.0)).astype(np.float32)
    return [rng.standard_normal((b, h, hd, hd)).astype(np.float32), r, k, v, w,
            0.5 * rng.standard_normal((h, hd)).astype(np.float32)]


STREAMED = {"mamba": (1, 2, 3, 4), "rwkv6": (1, 2, 3)}  # inputs in the stream dtype


def _both(kind, arrays, dtype):
    """(jax arrays, torch leaves that record gradients) of the inputs, the
    streamed ones in ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    j, t = [], []
    for i, a in enumerate(arrays):
        streamed = i in STREAMED[kind]
        j.append(jnp.asarray(a, jdt if streamed else jnp.float32))
        t.append(torch.from_numpy(a).to(tdt if streamed else torch.float32).requires_grad_())
    return j, t


def _op_vs_lax_scan(kind, arrays, dtype, seed):
    jfn, op = (jax_mamba, ssm_scan.mamba_scan) if kind == "mamba" else (
        jax_rwkv6, ssm_scan.rwkv6_wkv)
    jargs, targs = _both(kind, arrays, dtype)
    rng = np.random.default_rng(seed)
    y_np, s_np = (np.asarray(o, np.float32) for o in jax.jit(jfn)(*jargs))
    py = rng.standard_normal(y_np.shape).astype(np.float32)
    ps = rng.standard_normal(s_np.shape).astype(np.float32)

    def loss(*args):
        y, s = jfn(*args)
        return jnp.sum(y * py) + jnp.sum(s * ps)

    want_grads = jax.jit(jax.grad(loss, argnums=tuple(range(6))))(*jargs)
    y, s = op(*targs)
    close(y, y_np, "y")
    close(s, s_np, "state")
    ((y * torch.from_numpy(py)).sum() + (s * torch.from_numpy(ps)).sum()).backward()
    for i, (t, g) in enumerate(zip(targs, want_grads)):
        assert t.grad.dtype == t.dtype
        close(t.grad, g, f"gradient of input {i}")


@pytest.mark.parametrize("b,s,e,n", [(2, 1, 24, 8), (2, 37, 24, 16), (2, 37, 24, 4),
                                     (2, 9, 24, 12)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_op_equals_lax_scan(b, s, e, n, dtype):
    """A carried state; S = 1 (a decode step) and S over one backward chunk
    of the kernel; the gradients through the op's CPU backward.  N 4 and 12
    are sizes the kernel is not built for (padded on the card)."""
    _op_vs_lax_scan("mamba", mamba_inputs(b, s, e, n, s + n), dtype, seed=s)


@pytest.mark.parametrize("b,s,h,hd", [(2, 1, 3, 32), (2, 37, 2, 64), (2, 37, 2, 16),
                                     (2, 9, 1, 48)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_op_equals_lax_scan(b, s, h, hd, dtype):
    """As the Mamba op's; hd 16 and 48 are not built (padded on the card)."""
    _op_vs_lax_scan("rwkv6", rwkv_inputs(b, s, h, hd, s + hd), dtype, seed=s)


# --------------------------------------------------------------------------- #
# The model functions that call the ops, against jax.grad of the reference's
# --------------------------------------------------------------------------- #


def _check_model(dtype, got, want, what):
    (close if dtype == "float32" else close_to_rms)(got, want, what)


@pytest.mark.parametrize("s,time_chunk", [(1, 0), (12, 0), (12, 4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_scan_grads_equal_the_reference(s, time_chunk, dtype):
    """``_mamba_scan`` from a carried state: its output, last state and the
    gradients of xe, h0 and its parameters (``time_chunk`` 4: one op call a
    chunk under checkpoint, the reference's jax.checkpoint per chunk)."""
    jcfg, cfg = configs("jamba-1.5-large-398b", dtype)
    jcfg = dataclasses.replace(jcfg, ssm=dataclasses.replace(jcfg.ssm, time_chunk=time_chunk))
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, time_chunk=time_chunk))
    jdt, tdt = DTYPES[dtype]
    jp = jssm.mamba_init(jax.random.key(5), jcfg, jdt)
    mod = load(ssm.Mamba(cfg, tdt, "cpu"), jp).requires_grad_(True)
    e, n = cfg.ssm.expand * cfg.d_model, cfg.ssm.d_state
    rng = np.random.default_rng(s + time_chunk)
    xe = rng.standard_normal((2, s, e)).astype(np.float32)
    h0 = rng.standard_normal((2, e, n)).astype(np.float32)
    py = rng.standard_normal((2, s, e)).astype(np.float32)
    ph = rng.standard_normal((2, e, n)).astype(np.float32)

    def jloss(p, x, h):
        y, hl = jssm._mamba_scan(p, x, jcfg, h)
        return jnp.sum(y.astype(jnp.float32) * py) + jnp.sum(hl * ph), (y, hl)

    (_, (jy, jh)), (gp, gx, gh) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                                             has_aux=True))(
        jp, jnp.asarray(xe, jdt), jnp.asarray(h0))
    x_t = torch.from_numpy(xe).to(tdt).requires_grad_()
    h_t = torch.from_numpy(h0).requires_grad_()
    y, hl = ssm._mamba_scan(mod, x_t, cfg, h_t)
    ((y.float() * torch.from_numpy(py)).sum() + (hl * torch.from_numpy(ph)).sum()).backward()
    _check_model(dtype, y, jy, "y")
    _check_model(dtype, hl, jh, "last state")
    _check_model(dtype, x_t.grad, gx, "xe's gradient")
    _check_model(dtype, h_t.grad, gh, "h0's gradient")
    used = 0
    for name, p in mod.named_parameters():
        if p.grad is None:  # outside _mamba_scan: the reference's is zero
            assert not np.asarray(jnp.asarray(gp[name], jnp.float32)).any(), name
            continue
        used += 1
        _check_model(dtype, p.grad, gp[name], f"{name}'s gradient")
    assert used == 5  # w_x, w_dt, dt_bias, a_log, d_skip


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_time_mix_grads_equal_the_reference(dtype):
    """``rwkv6_tm_apply`` over 9 steps: its output and the gradients of x
    and every parameter."""
    jcfg, cfg = configs("rwkv6-1.6b", dtype)
    jdt, tdt = DTYPES[dtype]
    jtm = jssm.rwkv6_tm_init(jax.random.key(12), jcfg, jdt)
    rng = np.random.default_rng(12)
    jtm["w0"] = jnp.asarray(rng.uniform(-3, 0, jtm["w0"].shape), jnp.float32)
    jtm["u_bonus"] = jnp.asarray(rng.standard_normal(jtm["u_bonus"].shape), jnp.float32)
    tm = load(ssm.RWKV6TimeMix(cfg, tdt, "cpu"), jtm).requires_grad_(True)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    proj = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)

    def jloss(p, xx):
        out = jssm.rwkv6_tm_apply(p, xx, jcfg)[0]
        return jnp.sum(out.astype(jnp.float32) * proj), out

    (_, jout), (gp, gx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        jtm, jnp.asarray(x, jdt))
    x_t = torch.from_numpy(x).to(tdt).requires_grad_()
    out, _ = ssm.rwkv6_tm_apply(tm, x_t, cfg)
    (out.float() * torch.from_numpy(proj)).sum().backward()
    _check_model(dtype, out, jout, "out")
    _check_model(dtype, x_t.grad, gx, "x's gradient")
    flat = {"ln_out.scale": gp["ln_out"]["scale"]}
    for name, p in tm.named_parameters():
        _check_model(dtype, p.grad, flat.get(name, gp.get(name)), f"{name}'s gradient")


# --------------------------------------------------------------------------- #
# Fake implementations, FLOP formulas, sharding rules
# --------------------------------------------------------------------------- #


def test_fake_shapes_and_flop_formulas():
    """Forward and backward under FakeTensorMode: each output's shape and
    dtype, and FlopCounterMode's count equal to the formula."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    b, s, e, n, h, hd = 2, 5, 24, 16, 3, 32
    bf = torch.bfloat16
    with FakeTensorMode():
        m = [torch.empty((b, e, n)), torch.empty((b, s, e), dtype=bf),
             torch.empty((b, s, n), dtype=bf), torch.empty((b, s, n), dtype=bf),
             torch.empty((b, s, e), dtype=bf), torch.empty((e, n))]
        r = [torch.empty((b, h, hd, hd)), *(torch.empty((b, s, h, hd), dtype=bf)
                                            for _ in range(3)),
             torch.empty((b, s, h, hd)), torch.empty((h, hd))]
        with FlopCounterMode(display=False) as fc:
            y, hl = ssm_scan.MAMBA_OP(*m)
        assert (y.shape, y.dtype, hl.shape, hl.dtype) == (
            (b, s, e), torch.float32, (b, e, n), torch.float32)
        assert fc.get_total_flops() == ssm_scan.mamba_flops(b, s, e, n) == b * s * e * (7 * n + 1)
        with FlopCounterMode(display=False) as fc:
            grads = ssm_scan.MAMBA_BWD_OP(y, hl, *m)
        assert [(g.shape, g.dtype) for g in grads] == [(t.shape, t.dtype) for t in m]
        assert fc.get_total_flops() == ssm_scan.mamba_flops(b, s, e, n, backward=True)
        with FlopCounterMode(display=False) as fc:
            y, st = ssm_scan.RWKV_OP(*r)
        assert (y.shape, y.dtype, st.shape, st.dtype) == (
            (b, s, h, hd), torch.float32, (b, h, hd, hd), torch.float32)
        assert fc.get_total_flops() == ssm_scan.rwkv6_flops(b, s, h, hd) == 7 * b * s * h * hd ** 2
        with FlopCounterMode(display=False) as fc:
            grads = ssm_scan.RWKV_BWD_OP(y, st, *r)
        assert [(g.shape, g.dtype) for g in grads] == [(t.shape, t.dtype) for t in r]
        assert fc.get_total_flops() == ssm_scan.rwkv6_flops(b, s, h, hd, backward=True)


def test_ops_refuse_what_the_kernels_do_not_take():
    """Shapes, dtypes and layouts the ops refuse; a state size and a head
    size that no kernel is built for (6, 24) are taken, as the reference
    takes them, and equal its ``lax.scan``."""
    m = [torch.from_numpy(a) for a in mamba_inputs(1, 3, 8, 8, 0)]
    six = [m[0][..., :6], m[1], m[2][..., :6], m[3][..., :6], m[4], m[5][:, :6]]
    y, h = ssm_scan.MAMBA_OP(*(t.contiguous() for t in six))
    want_y, want_h = jax_mamba(*(jnp.asarray(t.numpy()) for t in six))
    close(y, want_y, "y at N = 6")
    close(h, want_h, "state at N = 6")
    with pytest.raises(ValueError, match="C must be"):
        ssm_scan.MAMBA_OP(*m[:3], m[3][:, :2].contiguous(), *m[4:])
    with pytest.raises(ValueError, match="float32"):
        ssm_scan.MAMBA_OP(m[0].to(torch.bfloat16), *m[1:])
    r = [torch.from_numpy(a) for a in rwkv_inputs(1, 3, 2, 32, 0)]
    r24 = rwkv_inputs(1, 3, 2, 24, 0)
    y, st = ssm_scan.RWKV_OP(*(torch.from_numpy(a) for a in r24))
    want_y, want_s = jax_rwkv6(*(jnp.asarray(a) for a in r24))
    close(y, want_y, "y at hd = 24")
    close(st, want_s, "state at hd = 24")
    with pytest.raises(ValueError, match="contiguous"):
        ssm_scan.RWKV_OP(r[0], r[1].transpose(1, 2).contiguous().transpose(1, 2), *r[2:])
    with pytest.raises(ValueError, match="the stream"):
        ssm_scan.RWKV_OP(r[0], *(t.half() for t in r[1:4]), *r[4:])


PLAN_EDGES = {  # (B, S, E or H, N or hd) at the kernels' edges, sizes before padding
    "mamba": [(1, 1, 1, 16), (2, 7, 64, 16), (2, 9, 65, 8), (1, 8, 127, 4), (3, 17, 129, 12),
              (8, 1024, 16384, 16), (1, 15, 1, 8)],
    "rwkv6": [(1, 1, 1, 64), (2, 7, 3, 32), (1, 9, 2, 16), (1, 15, 1, 48), (4, 17, 32, 64),
              (8, 1024, 32, 64), (1, 16, 1, 24)],
}


@pytest.mark.parametrize("kind", sorted(PLAN_EDGES))
def test_launch_plan_covers_every_index(kind):
    """``launch_plan`` at the edges: the grids and chunks cover every
    channel, head and step and no more than one block or chunk beyond, each
    block's shared memory fits an H100 block, and the backward launch
    allocates exactly the plan's workspace."""
    built = ssm_scan.MAMBA_STATES if kind == "mamba" else ssm_scan.RWKV_HEAD_DIMS
    for b, s, width, size in PLAN_EDGES[kind]:
        nk = next(k for k in built if size <= k)
        for itemsize in (4, 2):
            p = ssm_scan.launch_plan(kind, b, s, width, nk, itemsize)
            assert max(p.fwd_smem, p.bwd_smem) <= ssm_scan.SMEM_LIMIT, (kind, size, p)
            ws = p.workspace
            if kind == "mamba":
                fwd, bwd = ssm_scan.MAMBA_FWD_BLOCK, ssm_scan.MAMBA_BLOCK
                chunk = ssm_scan.MAMBA_CHUNK
                assert p.fwd_grid[1] == p.bwd_grid[1] == b
                assert (p.fwd_grid[0] - 1) * fwd < width <= p.fwd_grid[0] * fwd
                assert (p.bwd_grid[0] - 1) * bwd < width <= p.bwd_grid[0] * bwd
                assert p.bwd_threads == 4 * bwd  # 4 threads a channel
                nchunk = ws["ckpt"][1]
                assert ws == {"part_bc": (b, s, p.bwd_grid[0], 2 * nk), "part_a": (b, width, nk),
                              "ckpt": (b, nchunk, width, nk)}
            else:
                chunk = ssm_scan.RWKV_CHUNK
                assert p.fwd_grid == p.bwd_grid == (b * width, 1)
                assert p.fwd_threads * 32 == nk * nk and p.bwd_threads == 4 * nk
                nchunk = ws["ckpt"][2]
                assert ws == {"part_u": (b, width, nk), "ckpt": (b, width, nchunk, nk, nk)}
            assert (nchunk - 1) * chunk < s <= nchunk * chunk


@pytest.mark.parametrize("kind", sorted(PLAN_EDGES))
def test_backward_launch_allocates_the_plans_workspace(kind, monkeypatch):
    """The backward launches (their CUDA path, run here on CPU tensors with
    the kernel entry replaced) allocate the plan's workspace at the padded
    size, and hand the kernel the built size."""
    seen, calls = [], []
    real = ssm_scan._empty
    monkeypatch.setattr(ssm_scan, "_empty", lambda shape, dt, like: seen.append(tuple(shape))
                        or real(shape, dt, like))
    entries = ssm_scan._MAMBA_BWD if kind == "mamba" else ssm_scan._RWKV_BWD
    for dt in list(entries):
        monkeypatch.setitem(entries, dt, lambda index, *args: calls.append(args))
    b, s, width, size = 2, 9, 65, 12
    if kind == "mamba":
        args = [torch.from_numpy(a) for a in mamba_inputs(b, s, width, size, 0)]
        y = torch.zeros((b, s, width)), torch.zeros((b, width, size))
        ssm_scan._mamba_bwd_launch(*y, *args)
        nk, scalars = 16, calls[0][8:12]
    else:
        width = 3
        args = [torch.from_numpy(a) for a in rwkv_inputs(b, s, width, size, 0)]
        y = torch.zeros((b, s, width, size)), torch.zeros((b, width, size, size))
        ssm_scan._rwkv_bwd_launch(*y, *args)
        nk, scalars = 32, calls[0][8:12]
    assert scalars == (b, s, width, nk)
    plan = ssm_scan.launch_plan(kind, b, s, width, nk, 4)
    assert seen[-len(plan.workspace):] == list(plan.workspace.values())


MESH_CASES = {  # placements on mesh ("data", "model") of each op's inputs
    "mamba rows and channels": ("mamba", [
        [Shard(0), Shard(1)], [Shard(0), Shard(2)], [Shard(0), Replicate()],
        [Shard(0), Replicate()], [Shard(0), Shard(2)], [Replicate(), Shard(0)]]),
    "mamba time split (redistributed)": ("mamba", [
        [Replicate(), Replicate()], [Shard(1), Replicate()], [Replicate(), Shard(1)],
        [Replicate(), Replicate()], [Replicate(), Shard(2)], [Replicate(), Replicate()]]),
    "rwkv6 rows and heads": ("rwkv6", [
        [Shard(0), Shard(1)], *([[Shard(0), Shard(2)]] * 4), [Replicate(), Shard(0)]]),
    "rwkv6 heads on data, rows on model": ("rwkv6", [
        [Shard(1), Shard(0)], *([[Shard(2), Shard(0)]] * 4), [Shard(0), Replicate()]]),
}


def sharding_job(cases):
    """On this rank of mesh (2, 2): each case's forward and backward op on
    DTensors, gathered whole, beside the same op on whole tensors."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out = {}
    for label, (kind, placements) in cases.items():
        if kind == "mamba":
            whole = [torch.from_numpy(a) for a in mamba_inputs(4, 6, 16, 8, 3)]
            fwd, bwd = ssm_scan.MAMBA_OP, ssm_scan.MAMBA_BWD_OP
        else:
            whole = [torch.from_numpy(a) for a in rwkv_inputs(4, 6, 4, 32, 3)]
            fwd, bwd = ssm_scan.RWKV_OP, ssm_scan.RWKV_BWD_OP
        gen = torch.Generator().manual_seed(4)
        want = fwd(*whole)
        grads = [torch.randn(t.shape, generator=gen) for t in want]
        want_b = bwd(*grads, *whole)
        dts = [distribute_tensor(t, mesh, p) for t, p in zip(whole, placements)]
        got = fwd(*dts)
        gdts = [distribute_tensor(g, mesh, o.placements) for g, o in zip(grads, got)]
        got_b = bwd(*gdts, *dts)
        out[label] = [float((g.full_tensor() - w).abs().max() / w.abs().max())
                      for g, w in zip([*got, *got_b], [*want, *want_b])]
    return out


def test_sharding_rules_on_a_gloo_mesh(tmp_path):
    """Every output, forward and backward, gathered from 4 gloo ranks on
    mesh (2, 2) equals one device's within 1e-5 of its largest value
    (rows, channels and heads split; a split the rules do not take is
    redistributed; split sums come back Partial and are added)."""
    results = run_ranks(4, "gloo", sharding_job, (MESH_CASES,), tmp_path)
    for rank, res in enumerate(results):
        for label, errs in res.items():
            assert max(errs) <= 1e-5, (rank, label, errs)


# --------------------------------------------------------------------------- #
# The dry-run: one scan op a layer
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch,op", [("rwkv6-1.6b", "rwkv6_wkv"),
                                     ("jamba-1.5-large-398b", "mamba_scan")])
@pytest.mark.parametrize("shape", ["prefill_32k", "train_4k"])
def test_depth_one_clone_traces_one_scan_op_a_layer(arch, op, shape):
    """A depth-1 clone at the published widths (rwkv6: one layer; jamba:
    its 8-layer period, 7 Mamba layers), traced on fake tensors on one
    device at one microbatch (the op counts scale with the cell's, and
    jamba's 16 in ``train_4k`` take ~40 s here): the op table holds one
    forward op a scan layer, and in training one backward op each (and the
    forward again: the remat policy recomputes the block)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import _depth_clone, lower_step

    cfg = _depth_clone(get_config(arch), 1)
    trace = lower_step(cfg, shape, None, 1, device="cpu")
    layers = sum(m in ("mamba", "rwkv6") for m, _f in cfg.layer_pattern)
    table = trace.counter.table
    calls = {name: row["calls"] for name, row in table.items() if "repro_torch" in name}
    train = shape == "train_4k"
    recompute = 2 if train and cfg.remat_policy != "none" else 1
    assert calls.get(f"repro_torch.{op}") == layers * recompute, calls
    want_bwd = layers if train else None
    assert calls.get(f"repro_torch.{op}_backward") == want_bwd, calls
    assert trace.costs["flops"] > 0
