"""The two time recurrences of the SSM mixers: Mamba's selective scan and RWKV-6's WKV.

``mamba_scan(h0, dt, B, C, x, a)`` runs, for h0 [B, E, N] float32, dt and x
[B, S, E] and B, C [B, S, N] in the stream dtype (float32 or bfloat16,
upcast each step) and a [E, N] float32 (``-exp(a_log)``)::

    h_t = exp(dt_t a) * h_{t-1} + (dt_t x_t) B_t ;   y_t = sum_n C_t h_t

and returns (y [B, S, E], h_S [B, E, N]), both float32.

``rwkv6_wkv(s0, r, k, v, w, u)`` runs, for s0 [B, H, hd, hd] float32, r, k,
v [B, S, H, hd] in the stream dtype, w [B, S, H, hd] float32 (the decay)
and u [H, hd] float32 (the bonus)::

    y_t = r_t (S_{t-1} + diag(u) k_tᵀ v_t) ;   S_t = diag(w_t) S_{t-1} + k_tᵀ v_t

and returns (y [B, S, H, hd], S_S [B, H, hd, hd]), both float32.

The reference runs both as ``jax.lax.scan`` (``repro.models.ssm``:
``_mamba_scan``'s step and ``rwkv6_tm_apply``'s), one loop on the device.
Here each is the registered op ``repro_torch::mamba_scan`` /
``repro_torch::rwkv6_wkv``: the CUDA implementation launches the
hand-written kernel (``csrc/mamba_scan.cu``, ``csrc/rwkv6_wkv.cu``), which
loops over time inside one launch with the state on chip; the CPU
implementation is the plain version, the step loop the models ran before
(:func:`mamba_scan_plain`, :func:`rwkv6_wkv_plain`).  There is no fallback
between the two: a CUDA tensor reaches the kernel or raises.

Each op has a backward op of its own (``mamba_scan_backward``,
``rwkv6_wkv_backward``), bound with ``torch.library.register_autograd``, that
gives the gradients of every input.  On the card it is a kernel that walks
time backwards from states kept every few steps and recomputed in between,
so it never holds a state per step ([B, S, E, N] at Jamba's widths would be
tens of TB); its sums across blocks (Mamba's dB and dC over E and da over
rows, RWKV-6's du over rows) are added in a fixed order by a second pass, so
two calls on the same inputs give the same bits.  On the CPU it is the VJP of
the plain forward (:func:`mamba_scan_backward_plain`,
:func:`rwkv6_wkv_backward_plain`), which shares nothing of the kernel's
scheme.

Every op (forward and backward) has a fake implementation (shapes only; the
dry-run traces it), a FLOP formula counting the work of every step, and a
DTensor sharding rule: rows split for both, E split for Mamba, heads split
for RWKV-6 (a sum over what is split comes out ``Partial``).  Each
implementation checks the tensors it is given (``_check_*``): under DTensor
those are a rank's local pieces.

The ops take any state size N and head size hd, as the reference's
``lax.scan`` does.  The kernels keep the state in registers, so each is
compiled for a few sizes (``MAMBA_STATES``, ``RWKV_HEAD_DIMS``); on the card
a size between them is zero-padded to the next one built, which is exact:
Mamba's padded states start at 0 and get no input (B = 0), so they stay 0
and add nothing to y (C = 0); RWKV-6's padded rows have r = k = u = 0 and
its padded columns v = 0, so the padded state stays 0, and the padded
columns of y are cut.  The gradients of the padded entries are dropped.
Above the largest size built the CUDA launch raises, naming it.

``LAUNCHES`` counts op calls that launched a kernel, by op (one per call;
the backward's second pass is part of its call).  :func:`launch_plan` is
the launches' arithmetic in one place: each kernel's grid, threads and
shared memory (as the sources compute them) and the workspace each
backward launch allocates.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding
from torch.utils.flop_counter import register_flop_formula

from ._build import CSRC, Entry

_MAMBA_SOURCE = CSRC / "mamba_scan.cu"
_RWKV_SOURCE = CSRC / "rwkv6_wkv.cu"
_SOURCES = (_MAMBA_SOURCE, _RWKV_SOURCE)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_MAMBA = {dt: Entry(_MAMBA_SOURCE, f"mamba_scan_{s}") for dt, s in _SUFFIX.items()}
_MAMBA_BWD = {dt: Entry(_MAMBA_SOURCE, f"mamba_scan_bwd_{s}") for dt, s in _SUFFIX.items()}
_RWKV = {dt: Entry(_RWKV_SOURCE, f"rwkv6_wkv_{s}") for dt, s in _SUFFIX.items()}
_RWKV_BWD = {dt: Entry(_RWKV_SOURCE, f"rwkv6_wkv_bwd_{s}") for dt, s in _SUFFIX.items()}

MAMBA_STATES = (8, 16)  # the state sizes N the Mamba kernel is built for (others padded)
RWKV_HEAD_DIMS = (32, 64)  # the head sizes the RWKV-6 kernel is built for (others padded)
# the sources' constants (csrc/mamba_scan.cu, csrc/rwkv6_wkv.cu), mirrored by launch_plan
MAMBA_FWD_BLOCK = 128  # channels a Mamba forward block (kFwdThreads)
MAMBA_FWD_TILE = 16  # steps a Mamba forward block stages at once (kFwdTile)
MAMBA_FWD_STAGES = 3  # tiles in its ring (kFwdStages)
MAMBA_BLOCK = 64  # channels a Mamba backward block, 4 threads each (kBwdChannels)
MAMBA_CHUNK = 8  # steps between the Mamba backward's kept states (kChunk)
RWKV_TILE = 32  # steps the RWKV-6 forward stages at once (kFwdTile)
RWKV_CHUNK = 8  # steps between the RWKV-6 backward's kept states (kChunk)
STAGES = 4  # the backward kernels' ring of staged chunks (kStages)
SMEM_LIMIT = 232_448  # the dynamic shared memory an H100 block may have

LAUNCHES = dict.fromkeys(
    ("mamba_scan", "mamba_scan_backward", "rwkv6_wkv", "rwkv6_wkv_backward"), 0)

_F32 = torch.float32


def _empty(shape, dtype, like):
    return torch.empty(shape, dtype=dtype, device=like.device)


# --------------------------------------------------------------------------- #
# The plain versions
# --------------------------------------------------------------------------- #


def mamba_scan_plain(h0, dt, bm, cm, x, a):
    """The Mamba kernel's function in plain PyTorch: a loop over time."""
    h, ys = h0, []
    for dt_t, b_t, c_t, x_t in zip(*(t.unbind(1) for t in (dt, bm, cm, x))):
        dt32 = dt_t.float()  # per-step upcast; the state and its math stay float32
        da = torch.exp(dt32[..., None] * a)  # [B,E,N]
        h = da * h + (dt32 * x_t.float())[..., None] * b_t.float()[:, None, :]
        ys.append(torch.einsum("ben,bn->be", h, c_t.float()))
    return torch.stack(ys, dim=1), h


def rwkv6_wkv_plain(s0, r, k, v, w, u):
    """The RWKV-6 kernel's function in plain PyTorch: a loop over time."""
    state, ys, u = s0, [], u[None]
    for r_t, k_t, v_t, w_t in zip(*(t.float().unbind(1) for t in (r, k, v, w))):
        kv = k_t[..., None] * v_t[..., None, :]  # [B,H,hd,hd]
        ys.append(torch.einsum("bhk,bhkv->bhv", r_t, state + u[..., None] * kv))
        state = w_t[..., None] * state + kv
    return torch.stack(ys, dim=1), state


# autograd's dispatch keys: an op's implementation may run with them excluded
# (DTensor calls it below autograd), where no graph would be recorded
_AUTOGRAD_KEYS = torch._C.DispatchKeySet(torch._C.DispatchKey.ADInplaceOrView)
for _key in ("AutogradFunctionality", "AutogradOther", "AutogradNestedTensor"):
    _AUTOGRAD_KEYS = _AUTOGRAD_KEYS | torch._C.DispatchKeySet(getattr(torch._C.DispatchKey, _key))


def _vjp(plain, grads, inputs):
    """The gradients of every input of ``plain`` against ``grads`` of its
    outputs: autograd through the plain loop, which holds every step's state
    (affordable at the sizes the CPU runs), with autograd's dispatch keys
    let through wherever it is called from."""
    tls = torch._C
    with tls._ForceDispatchKeyGuard(tls._dispatch_tls_local_include_set(),
                                    tls._dispatch_tls_local_exclude_set() - _AUTOGRAD_KEYS), \
            torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in inputs]
        return torch.autograd.grad(plain(*leaves), leaves, grads)


def mamba_scan_backward_plain(gy, gh, h0, dt, bm, cm, x, a):
    """The Mamba backward kernel's function in plain PyTorch: (dh0, ddt, dB,
    dC, dx, da), the VJP of :func:`mamba_scan_plain`."""
    return _vjp(mamba_scan_plain, (gy, gh), (h0, dt, bm, cm, x, a))


def rwkv6_wkv_backward_plain(gy, gs, s0, r, k, v, w, u):
    """The RWKV-6 backward kernel's function in plain PyTorch: (ds0, dr, dk,
    dv, dw, du), the VJP of :func:`rwkv6_wkv_plain`."""
    return _vjp(rwkv6_wkv_plain, (gy, gs), (s0, r, k, v, w, u))


# --------------------------------------------------------------------------- #
# Checks
# --------------------------------------------------------------------------- #


def _same(what: str, tensors: dict, dtype=None) -> None:
    """Every tensor contiguous, on the first one's device, of ``dtype``."""
    dev = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if dtype is not None and t.dtype != dtype:
            raise ValueError(f"{what}: {name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.device != dev:
            raise ValueError(f"{what}: {name} is on {t.device}, not {dev}")


def _fits(dtype, streamed, floats) -> bool:
    """Every tensor contiguous and on the first one's device, the streamed
    ones of ``dtype`` and the others float32: the calls that pass, tested
    with plain attribute compares (a decode step is host-bound)."""
    dev = streamed[0].device
    return (all(t.dtype is dtype and t.is_contiguous() and t.device == dev for t in streamed)
            and all(t.dtype is _F32 and t.is_contiguous() and t.device == dev for t in floats))


def _check_mamba(h0, dt, bm, cm, x, a) -> tuple[int, int, int, int]:
    """What the Mamba kernel takes; returns (B, S, E, N)."""
    if x.dim() != 3 or h0.dim() != 3:
        raise ValueError(f"mamba_scan: want x [B, S, E] and h0 [B, E, N], got "
                         f"{tuple(x.shape)} and {tuple(h0.shape)}")
    b, s, e = x.shape
    n = h0.shape[2]
    if not (dt.shape == x.shape and bm.shape == (b, s, n) and cm.shape == (b, s, n)
            and h0.shape == (b, e, n) and a.shape == (e, n)):
        want = {"h0": (b, e, n), "dt": (b, s, e), "B": (b, s, n), "C": (b, s, n), "a": (e, n)}
        for name, t in (("h0", h0), ("dt", dt), ("B", bm), ("C", cm), ("a", a)):
            if tuple(t.shape) != want[name]:
                raise ValueError(f"mamba_scan: {name} must be {want[name]}, got {tuple(t.shape)}")
    if n < 1:
        raise ValueError("mamba_scan: needs a state size of at least 1")
    if s < 1:
        raise ValueError("mamba_scan: needs at least one step")
    if x.dtype not in _SUFFIX:
        raise ValueError(f"mamba_scan: the stream must be float32 or bfloat16, got {x.dtype}")
    if not _fits(x.dtype, (x, dt, bm, cm), (h0, a)):
        _same("mamba_scan", {"x": x, "dt": dt, "B": bm, "C": cm}, x.dtype)
        _same("mamba_scan", {"x": x, "h0": h0, "a": a}, None)
        _same("mamba_scan", {"h0": h0, "a": a}, _F32)
    return b, s, e, n


def _check_rwkv(s0, r, k, v, w, u) -> tuple[int, int, int, int]:
    """What the RWKV-6 kernel takes; returns (B, S, H, hd)."""
    if r.dim() != 4:
        raise ValueError(f"rwkv6_wkv: want r [B, S, H, hd], got {tuple(r.shape)}")
    b, s, h, hd = shape = r.shape
    if not (k.shape == shape and v.shape == shape and w.shape == shape
            and s0.shape == (b, h, hd, hd) and u.shape == (h, hd)):
        want = {"s0": (b, h, hd, hd), "k": (b, s, h, hd), "v": (b, s, h, hd),
                "w": (b, s, h, hd), "u": (h, hd)}
        for name, t in (("s0", s0), ("k", k), ("v", v), ("w", w), ("u", u)):
            if tuple(t.shape) != want[name]:
                raise ValueError(f"rwkv6_wkv: {name} must be {want[name]}, got {tuple(t.shape)}")
    if hd < 1:
        raise ValueError("rwkv6_wkv: needs a head_dim of at least 1")
    if s < 1:
        raise ValueError("rwkv6_wkv: needs at least one step")
    if r.dtype not in _SUFFIX:
        raise ValueError(f"rwkv6_wkv: the stream must be float32 or bfloat16, got {r.dtype}")
    if not _fits(r.dtype, (r, k, v), (s0, w, u)):
        _same("rwkv6_wkv", {"r": r, "k": k, "v": v}, r.dtype)
        _same("rwkv6_wkv", {"r": r, "s0": s0, "w": w, "u": u}, None)
        _same("rwkv6_wkv", {"s0": s0, "w": w, "u": u}, _F32)
    return b, s, h, hd


def _check_grads(what: str, grads: dict) -> None:
    for name, (t, shape) in grads.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} must be {tuple(shape)}, got {tuple(t.shape)}")
    _same(what, {n: t for n, (t, _s) in grads.items()}, _F32)


# --------------------------------------------------------------------------- #
# The ops' implementations
# --------------------------------------------------------------------------- #


def _built(what: str, size: int, built: tuple[int, ...]) -> int:
    """The smallest size the kernel is built for that holds ``size``."""
    for k in built:
        if size <= k:
            return k
    raise ValueError(f"{what}: the kernel takes at most {built[-1]}, got {size}")


def _pad(t, to: int, dims=(-1,)):
    """``t`` with each axis of ``dims`` zero-padded at its end to ``to``."""
    widths = [0] * (2 * t.dim())
    for d in dims:
        widths[2 * (-d - 1) + 1] = to - t.shape[d]
    return torch.nn.functional.pad(t, widths) if any(widths) else t


def _cut(t, n: int, dims=(-1,)):
    """``t`` cut to its first ``n`` entries on each axis of ``dims``."""
    if all(t.shape[d] == n for d in dims):
        return t
    index = [slice(None)] * t.dim()
    for d in dims:
        index[d] = slice(0, n)
    return t[tuple(index)].contiguous()


def _aligned(t):
    """``t``, or a copy of it where it does not start on 16 bytes (the
    kernels read the states as float4s)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


class Plan(NamedTuple):
    """One call's launches, as the sources compute them: each kernel's grid
    (x, y), threads a block and shared memory a block in bytes, and the
    workspace the backward launch allocates (name -> shape)."""

    fwd_grid: tuple[int, int]
    fwd_threads: int
    fwd_smem: int
    bwd_grid: tuple[int, int]
    bwd_threads: int
    bwd_smem: int
    workspace: dict


def _up16(n: int) -> int:
    return -(-n // 16) * 16


@functools.lru_cache(maxsize=512)
def launch_plan(kind: str, b: int, s: int, width: int, size: int, itemsize: int) -> Plan:
    """The launches of one call at a built size: ``kind`` ``"mamba"`` (width
    E, size N) or ``"rwkv6"`` (width H, size hd), for B rows of S steps in a
    stream of ``itemsize``-byte values (4 float32, 2 bfloat16)."""
    if kind == "mamba":
        e, n = width, size
        nblk, nchunk = -(-e // MAMBA_BLOCK), -(-s // MAMBA_CHUNK)
        chunk = MAMBA_CHUNK * MAMBA_BLOCK  # a chunk's values of one array
        slot = _up16((2 * chunk + 2 * MAMBA_CHUNK * n) * itemsize + chunk * 4)
        warps = MAMBA_BLOCK * 4 // 32
        tile = MAMBA_FWD_TILE * MAMBA_FWD_BLOCK
        return Plan((-(-e // MAMBA_FWD_BLOCK), b), MAMBA_FWD_BLOCK,
                    MAMBA_FWD_STAGES * (2 * tile + 2 * MAMBA_FWD_TILE * n) * itemsize
                    + MAMBA_FWD_TILE * 2 * n * 4,
                    (nblk, b), MAMBA_BLOCK * 4,
                    STAGES * slot
                    + (10 * chunk + MAMBA_CHUNK * 2 * n * (1 + warps)) * 4,
                    {"part_bc": (b, s, nblk, 2 * n), "part_a": (b, e, n),
                     "ckpt": (b, nchunk, e, n)})
    if kind != "rwkv6":
        raise ValueError(f"launch_plan: no kernel {kind!r}")
    h, hd = width, size
    nchunk = -(-s // RWKV_CHUNK)
    tile, chunk, row = RWKV_TILE * hd, RWKV_CHUNK * hd, hd + (hd // 32) * 4
    warps = hd // 8
    return Plan((b * h, 1), hd * hd // 32,
                2 * tile * (3 * itemsize + 4) + (4 * RWKV_TILE * row + RWKV_TILE) * 4,
                (b * h, 1), 32 * warps,
                STAGES * (chunk * (3 * itemsize + 8) + hd * hd * 4)
                + (RWKV_CHUNK * warps * hd + RWKV_CHUNK * warps + 3 * chunk) * 4,
                {"part_u": (b, h, hd), "ckpt": (b, h, nchunk, hd, hd)})


def _mamba_launch(h0, dt, bm, cm, x, a):
    b, s, e, n = _check_mamba(h0, dt, bm, cm, x, a)
    nk = _built("mamba_scan: the state size", n, MAMBA_STATES)
    if nk != n:
        h0, bm, cm, a = (_pad(t, nk) for t in (h0, bm, cm, a))
    h0, a = _aligned(h0), _aligned(a)
    dev = x.device
    y = torch.empty((b, s, e), dtype=_F32, device=dev)
    h_last = torch.empty((b, e, nk), dtype=_F32, device=dev)
    _MAMBA[x.dtype](dev.index, h0.data_ptr(), dt.data_ptr(), bm.data_ptr(), cm.data_ptr(),
                    x.data_ptr(), a.data_ptr(), b, s, e, nk, y.data_ptr(), h_last.data_ptr())
    LAUNCHES["mamba_scan"] += 1
    return y, (h_last if nk == n else _cut(h_last, n))


def _mamba_cpu(h0, dt, bm, cm, x, a):
    _check_mamba(h0, dt, bm, cm, x, a)
    return mamba_scan_plain(h0, dt, bm, cm, x, a)


def _mamba_bwd_check(gy, gh, h0, dt, bm, cm, x, a):
    b, s, e, n = _check_mamba(h0, dt, bm, cm, x, a)
    _check_grads("mamba_scan_backward", {"gy": (gy, (b, s, e)), "gh": (gh, (b, e, n))})
    if gy.device != x.device:
        raise ValueError(f"mamba_scan_backward: gy is on {gy.device}, not {x.device}")
    return b, s, e, n


def _mamba_bwd_launch(gy, gh, h0, dt, bm, cm, x, a):
    b, s, e, n = _mamba_bwd_check(gy, gh, h0, dt, bm, cm, x, a)
    nk = _built("mamba_scan_backward: the state size", n, MAMBA_STATES)
    if nk != n:
        gh, h0, bm, cm, a = (_pad(t, nk) for t in (gh, h0, bm, cm, a))
    ws = launch_plan("mamba", b, s, e, nk, x.element_size()).workspace
    dh0 = _empty((b, e, nk), _F32, x)
    ddt, dx = torch.empty_like(dt), torch.empty_like(x)
    dbc, da = _empty((b, s, 2 * nk), _F32, x), _empty((e, nk), _F32, x)
    part_bc, part_a, ckpt = (_empty(ws[k], _F32, x) for k in ("part_bc", "part_a", "ckpt"))
    _MAMBA_BWD[x.dtype](x.device.index, gy.data_ptr(), gh.data_ptr(), h0.data_ptr(),
                        dt.data_ptr(), bm.data_ptr(), cm.data_ptr(), x.data_ptr(),
                        a.data_ptr(), b, s, e, nk, dh0.data_ptr(), ddt.data_ptr(),
                        dx.data_ptr(), dbc.data_ptr(), da.data_ptr(), part_bc.data_ptr(),
                        part_a.data_ptr(), ckpt.data_ptr())
    LAUNCHES["mamba_scan_backward"] += 1
    db = dbc[..., :n].contiguous().to(bm.dtype)
    dc = dbc[..., nk:nk + n].contiguous().to(cm.dtype)
    return _cut(dh0, n), ddt, db, dc, dx, _cut(da, n)


def _mamba_bwd_cpu(gy, gh, h0, dt, bm, cm, x, a):
    _mamba_bwd_check(gy, gh, h0, dt, bm, cm, x, a)
    return mamba_scan_backward_plain(gy, gh, h0, dt, bm, cm, x, a)


def _rwkv_launch(s0, r, k, v, w, u):
    b, s, h, hd = _check_rwkv(s0, r, k, v, w, u)
    hk = _built("rwkv6_wkv: head_dim", hd, RWKV_HEAD_DIMS)
    if hk != hd:
        s0 = _pad(s0, hk, (-1, -2))
        r, k, v, w, u = (_pad(t, hk) for t in (r, k, v, w, u))
    s0 = _aligned(s0)
    dev = r.device
    y = torch.empty((b, s, h, hk), dtype=_F32, device=dev)
    s_last = torch.empty((b, h, hk, hk), dtype=_F32, device=dev)
    _RWKV[r.dtype](dev.index, s0.data_ptr(), r.data_ptr(), k.data_ptr(), v.data_ptr(),
                   w.data_ptr(), u.data_ptr(), b, s, h, hk, y.data_ptr(), s_last.data_ptr())
    LAUNCHES["rwkv6_wkv"] += 1
    if hk == hd:
        return y, s_last
    return _cut(y, hd), _cut(s_last, hd, (-1, -2))


def _rwkv_cpu(s0, r, k, v, w, u):
    _check_rwkv(s0, r, k, v, w, u)
    return rwkv6_wkv_plain(s0, r, k, v, w, u)


def _rwkv_bwd_check(gy, gs, s0, r, k, v, w, u):
    b, s, h, hd = _check_rwkv(s0, r, k, v, w, u)
    _check_grads("rwkv6_wkv_backward", {"gy": (gy, (b, s, h, hd)), "gs": (gs, (b, h, hd, hd))})
    if gy.device != r.device:
        raise ValueError(f"rwkv6_wkv_backward: gy is on {gy.device}, not {r.device}")
    return b, s, h, hd


def _rwkv_bwd_launch(gy, gs, s0, r, k, v, w, u):
    b, s, h, hd = _rwkv_bwd_check(gy, gs, s0, r, k, v, w, u)
    hk = _built("rwkv6_wkv_backward: head_dim", hd, RWKV_HEAD_DIMS)
    if hk != hd:
        gs, s0 = (_pad(t, hk, (-1, -2)) for t in (gs, s0))
        gy, r, k, v, w, u = (_pad(t, hk) for t in (gy, r, k, v, w, u))
    gs, s0 = _aligned(gs), _aligned(s0)
    ws = launch_plan("rwkv6", b, s, h, hk, r.element_size()).workspace
    ds0 = _empty((b, h, hk, hk), _F32, r)
    dr, dk, dv = torch.empty_like(r), torch.empty_like(k), torch.empty_like(v)
    dw, du = _empty((b, s, h, hk), _F32, r), _empty((h, hk), _F32, r)
    part_u, ckpt = _empty(ws["part_u"], _F32, r), _empty(ws["ckpt"], _F32, r)
    _RWKV_BWD[r.dtype](r.device.index, gy.data_ptr(), gs.data_ptr(), s0.data_ptr(),
                       r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
                       b, s, h, hk, ds0.data_ptr(), dr.data_ptr(), dk.data_ptr(),
                       dv.data_ptr(), dw.data_ptr(), du.data_ptr(), part_u.data_ptr(),
                       ckpt.data_ptr())
    LAUNCHES["rwkv6_wkv_backward"] += 1
    return (_cut(ds0, hd, (-1, -2)), *(_cut(t, hd) for t in (dr, dk, dv, dw, du)))


def _rwkv_bwd_cpu(gy, gs, s0, r, k, v, w, u):
    _rwkv_bwd_check(gy, gs, s0, r, k, v, w, u)
    return rwkv6_wkv_backward_plain(gy, gs, s0, r, k, v, w, u)


_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("mamba_scan(Tensor h0, Tensor dt, Tensor B, Tensor C, Tensor x, Tensor a) "
            "-> (Tensor, Tensor)")
_LIB.define("mamba_scan_backward(Tensor gy, Tensor gh, Tensor h0, Tensor dt, Tensor B, "
            "Tensor C, Tensor x, Tensor a) -> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)")
_LIB.define("rwkv6_wkv(Tensor s0, Tensor r, Tensor k, Tensor v, Tensor w, Tensor u) "
            "-> (Tensor, Tensor)")
_LIB.define("rwkv6_wkv_backward(Tensor gy, Tensor gs, Tensor s0, Tensor r, Tensor k, "
            "Tensor v, Tensor w, Tensor u) -> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)")
for _name, _cuda, _cpu in (("mamba_scan", _mamba_launch, _mamba_cpu),
                           ("mamba_scan_backward", _mamba_bwd_launch, _mamba_bwd_cpu),
                           ("rwkv6_wkv", _rwkv_launch, _rwkv_cpu),
                           ("rwkv6_wkv_backward", _rwkv_bwd_launch, _rwkv_bwd_cpu)):
    _LIB.impl(_name, _cuda, "CUDA")
    _LIB.impl(_name, _cpu, "CPU")


@torch.library.register_fake("repro_torch::mamba_scan", lib=_LIB)
def _mamba_fake(h0, dt, bm, cm, x, a):
    b, s, e, n = _check_mamba(h0, dt, bm, cm, x, a)
    return x.new_empty((b, s, e), dtype=_F32), h0.new_empty((b, e, n))


@torch.library.register_fake("repro_torch::mamba_scan_backward", lib=_LIB)
def _mamba_bwd_fake(gy, gh, h0, dt, bm, cm, x, a):
    _mamba_bwd_check(gy, gh, h0, dt, bm, cm, x, a)
    return (torch.empty_like(h0), torch.empty_like(dt), torch.empty_like(bm),
            torch.empty_like(cm), torch.empty_like(x), torch.empty_like(a))


@torch.library.register_fake("repro_torch::rwkv6_wkv", lib=_LIB)
def _rwkv_fake(s0, r, k, v, w, u):
    _check_rwkv(s0, r, k, v, w, u)
    return r.new_empty(r.shape, dtype=_F32), torch.empty_like(s0)


@torch.library.register_fake("repro_torch::rwkv6_wkv_backward", lib=_LIB)
def _rwkv_bwd_fake(gy, gs, s0, r, k, v, w, u):
    _rwkv_bwd_check(gy, gs, s0, r, k, v, w, u)
    return (torch.empty_like(s0), torch.empty_like(r), torch.empty_like(k),
            torch.empty_like(v), torch.empty_like(w), torch.empty_like(u))


MAMBA_OP = torch.ops.repro_torch.mamba_scan.default
MAMBA_BWD_OP = torch.ops.repro_torch.mamba_scan_backward.default
RWKV_OP = torch.ops.repro_torch.rwkv6_wkv.default
RWKV_BWD_OP = torch.ops.repro_torch.rwkv6_wkv_backward.default


# --------------------------------------------------------------------------- #
# FLOP formulas: the work of every step, as the kernels do it
# --------------------------------------------------------------------------- #


def mamba_flops(b: int, s: int, e: int, n: int, backward: bool = False) -> int:
    """Forward, per (row, step, channel): dt x, then per state value dt a,
    its exp, the decay's product, the input term's product and sum and C h's
    product and sum (7).  Backward: the forward's 5 a state value twice
    (kept states, then the chunk's states again), the gradient's 15 (g's
    update, the terms of dB, dC, ddt, dx and da, the decay back) and the
    block sums of dB and dC (2), plus 2 a channel."""
    if backward:
        return b * s * e * (27 * n + 2)
    return b * s * e * (7 * n + 1)


def rwkv6_flops(b: int, s: int, h: int, hd: int, backward: bool = False) -> int:
    """Forward, per (row, step, head, i, j): k v, its bonus, the sum with
    the state, r's product and sum, the decay and the new term (7).
    Backward: the recurrence twice (3 each: kept states, then the chunk's
    states again), the sums of dr, dk, dw and dv (2 each), dv's term (3),
    the state gradient's update (3) and gy·v (2): 22."""
    return b * s * h * hd * hd * (22 if backward else 7)


@register_flop_formula(torch.ops.repro_torch.mamba_scan)
def _mamba_flop_formula(h0_shape, dt_shape, *args, **kwargs) -> int:
    b, s, e = dt_shape
    return mamba_flops(b, s, e, h0_shape[2])


@register_flop_formula(torch.ops.repro_torch.mamba_scan_backward)
def _mamba_bwd_flop_formula(gy_shape, gh_shape, *args, **kwargs) -> int:
    b, s, e = gy_shape
    return mamba_flops(b, s, e, gh_shape[2], backward=True)


@register_flop_formula(torch.ops.repro_torch.rwkv6_wkv)
def _rwkv_flop_formula(s0_shape, r_shape, *args, **kwargs) -> int:
    return rwkv6_flops(*r_shape)


@register_flop_formula(torch.ops.repro_torch.rwkv6_wkv_backward)
def _rwkv_bwd_flop_formula(gy_shape, *args, **kwargs) -> int:
    return rwkv6_flops(*gy_shape, backward=True)


# --------------------------------------------------------------------------- #
# DTensor sharding rules: placements per mesh dim, (outputs, inputs)
# --------------------------------------------------------------------------- #

_R, _P = Replicate(), Partial()


@register_sharding(MAMBA_OP)
def _mamba_sharding(h0, dt, bm, cm, x, a):
    """Whole; rows split (a whole); channels E split (B, C whole)."""
    return [([_R] * 2, [_R] * 6),
            ([Shard(0)] * 2, [Shard(0)] * 5 + [_R]),
            ([Shard(2), Shard(1)], [Shard(1), Shard(2), _R, _R, Shard(2), Shard(0)])]


@register_sharding(MAMBA_BWD_OP)
def _mamba_bwd_sharding(gy, gh, h0, dt, bm, cm, x, a):
    """As the forward; da is a sum over rows and dB, dC sums over E, so a
    split there leaves each piece's part (Partial)."""
    return [([_R] * 6, [_R] * 8),
            ([Shard(0)] * 5 + [_P], [Shard(0)] * 7 + [_R]),
            ([Shard(1), Shard(2), _P, _P, Shard(2), Shard(0)],
             [Shard(2), Shard(1), Shard(1), Shard(2), _R, _R, Shard(2), Shard(0)])]


@register_sharding(RWKV_OP)
def _rwkv_sharding(s0, r, k, v, w, u):
    """Whole; rows split (u whole); heads split."""
    return [([_R] * 2, [_R] * 6),
            ([Shard(0)] * 2, [Shard(0)] * 5 + [_R]),
            ([Shard(2), Shard(1)], [Shard(1)] + [Shard(2)] * 4 + [Shard(0)])]


@register_sharding(RWKV_BWD_OP)
def _rwkv_bwd_sharding(gy, gs, s0, r, k, v, w, u):
    """As the forward; du is a sum over rows, so a row split leaves each
    piece's part (Partial)."""
    return [([_R] * 6, [_R] * 8),
            ([Shard(0)] * 5 + [_P], [Shard(0)] * 7 + [_R]),
            ([Shard(1)] + [Shard(2)] * 4 + [Shard(0)],
             [Shard(2), Shard(1), Shard(1)] + [Shard(2)] * 4 + [Shard(0)])]


# --------------------------------------------------------------------------- #
# Autograd
# --------------------------------------------------------------------------- #


def _save_inputs(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _mamba_backward(ctx, gy, gh):
    h0, dt, bm, cm, x, a = ctx.saved_tensors
    gy = torch.zeros_like(x, dtype=_F32) if gy is None else gy.contiguous()
    gh = torch.zeros_like(h0) if gh is None else gh.contiguous()
    return MAMBA_BWD_OP(gy, gh, h0, dt, bm, cm, x, a)


def _rwkv_backward(ctx, gy, gs):
    s0, r, k, v, w, u = ctx.saved_tensors
    gy = torch.zeros_like(r, dtype=_F32) if gy is None else gy.contiguous()
    gs = torch.zeros_like(s0) if gs is None else gs.contiguous()
    return RWKV_BWD_OP(gy, gs, s0, r, k, v, w, u)


torch.library.register_autograd("repro_torch::mamba_scan", _mamba_backward,
                                setup_context=_save_inputs, lib=_LIB)
torch.library.register_autograd("repro_torch::rwkv6_wkv", _rwkv_backward,
                                setup_context=_save_inputs, lib=_LIB)


# --------------------------------------------------------------------------- #
# The wrappers
# --------------------------------------------------------------------------- #


def mamba_scan(h0, dt, bm, cm, x, a):
    """(y [B, S, E] float32, h_S [B, E, N] float32) of the selective scan
    (module docstring); the inputs are made contiguous first.  CPU tensors
    take the plain version; CUDA tensors launch the kernel on the current
    stream, without synchronising."""
    return MAMBA_OP(h0.contiguous(), dt.contiguous(), bm.contiguous(), cm.contiguous(),
                    x.contiguous(), a.contiguous())


def rwkv6_wkv(s0, r, k, v, w, u):
    """(y [B, S, H, hd] float32, S_S [B, H, hd, hd] float32) of the WKV
    recurrence (module docstring); the inputs are made contiguous first.
    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream, without synchronising."""
    return RWKV_OP(s0.contiguous(), r.contiguous(), k.contiguous(), v.contiguous(),
                   w.contiguous(), u.contiguous())
