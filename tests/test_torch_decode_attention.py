"""The port's decode attention == the reference's Pallas kernel and its oracle.

The same numpy inputs go to ``repro.kernels.decode_attention`` (the Pallas
kernel in interpret mode, as ``tests/test_decode_attention_kernel.py`` runs
it), ``repro.kernels.ref.decode_attention_ref`` and the port's
``decode_attention`` on CPU tensors, which is its plain version.
Tolerances are the reference test's own: 2e-5 in float32, 2e-2 in bfloat16.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention_pallas_call
from repro.kernels.ref import decode_attention_ref as jax_ref
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels.ref import decode_attention_ref

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(b, t, h, hk, hd, seed=0, lens=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, hd), dtype=np.float32)
    k = rng.standard_normal((b, t, hk, hd), dtype=np.float32)
    v = rng.standard_normal((b, t, hk, hd), dtype=np.float32)
    if lens is None:
        lens = rng.integers(1, t + 1, size=b)
    return q, k, v, np.asarray(lens, np.int32)


def _both(q, k, v, lens, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    j = [jnp.asarray(x, jdt) for x in (q, k, v)] + [jnp.asarray(lens)]
    t = [torch.from_numpy(x).to(tdt) for x in (q, k, v)] + [torch.from_numpy(lens)]
    return j, t


def _close(got, want, tol):
    if isinstance(want, torch.Tensor):
        want = want.float().numpy()
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol
    )


@pytest.mark.parametrize("b,t,h,hk,hd,bt,lens", [
    (2, 256, 4, 2, 32, 128, None),
    (1, 512, 8, 8, 64, 128, None),   # MHA
    (2, 256, 8, 1, 32, 64, None),    # MQA
    (1, 128, 6, 2, 16, 128, None),   # single block
    (3, 192, 9, 3, 64, 64, None),    # rep = 3, SmolLM-135M's 9 / 3 heads
    (3, 320, 9, 3, 64, 64, [1, 320, 77]),  # T not a multiple of 256; len 1 and T
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_and_oracle(b, t, h, hk, hd, bt, lens, dtype):
    q, k, v, lens = _inputs(b, t, h, hk, hd, seed=b * t + h, lens=lens)
    j, tt = _both(q, k, v, lens, dtype)
    tol = DTYPES[dtype][2]
    launches = da.LAUNCHES
    got = da.decode_attention(*tt)
    assert da.LAUNCHES == launches  # the plain version counts nothing
    assert got.dtype == tt[0].dtype and got.shape == (b, h, hd)
    _close(got, decode_attention_pallas_call(*j, bt=bt), tol)
    _close(got, jax_ref(*j), tol)
    _close(got, decode_attention_ref(*tt), tol)


def test_ragged_t_matches_oracle():
    """A T that no block size divides: the port takes it, the oracle agrees."""
    q, k, v, lens = _inputs(2, 301, 6, 2, 40, seed=5, lens=[301, 150])
    j, tt = _both(q, k, v, lens, "float32")
    _close(da.decode_attention(*tt), jax_ref(*j), 2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_empty_row_is_zero_as_in_the_pallas_kernel(dtype):
    q, k, v, lens = _inputs(3, 128, 4, 2, 32, seed=3, lens=[0, 5, 128])
    j, tt = _both(q, k, v, lens, dtype)
    got = da.decode_attention(*tt)
    assert torch.count_nonzero(got[0]) == 0
    _close(got, decode_attention_pallas_call(*j, bt=64), DTYPES[dtype][2])


def test_entries_past_len_do_not_matter():
    q, k, v, _ = _inputs(1, 256, 4, 2, 32, seed=9)
    lens = np.array([100], np.int32)
    _, tt = _both(q, k, v, lens, "float32")
    k[:, 100:] = 999.0
    v[:, 100:] = -999.0
    _, tt2 = _both(q, k, v, lens, "float32")
    torch.testing.assert_close(da.decode_attention(*tt), da.decode_attention(*tt2),
                               rtol=0, atol=1e-6)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q, k, v, lens = _both(*_inputs(2, 64, 4, 2, 32), "float32")[1]
    with pytest.raises(ValueError, match="contiguous"):
        da.decode_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2), v, lens)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        da.decode_attention(q.half(), k.half(), v.half(), lens)
    with pytest.raises(ValueError, match="share"):
        da.decode_attention(q, k.to(torch.bfloat16), v, lens)
    with pytest.raises(ValueError, match="int32"):
        da.decode_attention(q, k, v, lens.long())
    with pytest.raises(ValueError, match="multiple of 8"):
        da.decode_attention(q[..., :20].contiguous(), k[..., :20].contiguous(),
                            v[..., :20].contiguous(), lens)
    with pytest.raises(ValueError, match="does not fit"):
        da.decode_attention(q[:, :3].contiguous(), k, v, lens)


def test_cpu_views_at_any_offset_take_the_plain_version():
    """The 16-byte start the kernel needs binds only on the card."""
    q, k, v, lens = _both(*_inputs(2, 64, 4, 2, 32, seed=5), "float32")[1]
    flat = torch.zeros(k.numel() + 1)
    flat[1:] = k.reshape(-1)
    shifted = flat[1:].view(k.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    assert torch.equal(da.decode_attention(q, shifted, v, lens),
                       da.decode_attention(q, k, v, lens))


# --------------------------------------------------------------------------- #
# The kernel's split of T across blocks (split_plan), checked without a card
# --------------------------------------------------------------------------- #

MAIN = (8, 3, 3)  # SmolLM-135M serving: B 8, Hk 3, rep 3
CHUNK = da.split_plan(*MAIN, 1088)[0]


@pytest.mark.parametrize("t", [0, 1, CHUNK - 1, CHUNK, CHUNK + 1, 1088, 32_768])
@pytest.mark.parametrize("b,hk,rep", [MAIN, (128, 3, 3), (1, 3, 3), (2, 8, 3), (1, 1, 12)])
def test_split_plan_covers_t_once(b, hk, rep, t):
    chunk, splits = da.split_plan(b, hk, rep, t)
    assert chunk % da.CHUNK_MIN == 0 and da.CHUNK_MIN <= chunk <= da.CHUNK_MAX
    covered = np.concatenate(
        [np.arange(s * chunk, min((s + 1) * chunk, t)) for s in range(splits)])
    np.testing.assert_array_equal(covered, np.arange(t))
    assert splits == 1 or (splits - 1) * chunk < t  # no split is empty of positions


@pytest.mark.parametrize("t", [0, 1, 17, CHUNK - 1, CHUNK])
def test_split_plan_short_t_is_one_split(t):
    assert da.split_plan(*MAIN, t)[1] == 1


def test_split_plan_fills_the_card_at_the_main_path_shape():
    """At B 8, Hk 3, rep 3, T 1,088 and the serving run's lengths
    (1,025-1,087), at least 2 x 132 blocks hold valid positions."""
    b, hk, rep = MAIN
    chunk, splits = da.split_plan(b, hk, rep, 1088)
    groups = -(-rep // da.rows_per_block(rep))
    for lens in (np.full(b, 1025), np.linspace(1025, 1087, b).astype(int)):
        busy = sum(min(splits, -(-int(n) // chunk)) for n in lens) * hk * groups
        assert busy >= 2 * da.SMS


def test_split_plan_partials_are_small_at_decode_32k():
    """decode_32k (B 128, T 32,768, SmolLM-135M's 9 / 3 heads of 64, bf16):
    the partials written and read back stay within 5% of the K/V bytes of a
    cache half full (the cell's lengths are uniform in [1, T])."""
    b, t, h, hk, hd = 128, 32_768, 9, 3, 64
    chunk, splits = da.split_plan(b, hk, h // hk, t)
    partial_bytes = 2 * splits * b * h * (hd + 2) * 4  # written, then read
    kv_bytes = 2 * b * (t // 2) * hk * hd * 2
    assert splits > 1 and partial_bytes <= 0.05 * kv_bytes


def _split_and_combine(q, k, v, lens, chunk, splits):
    """The kernel's algorithm in plain PyTorch: each split's partial (m, l,
    acc) over its chunk of the valid prefix, in log2 units, an empty chunk
    giving m = -inf and l = 0; then the merge in split order."""
    b, h, hd = q.shape
    t, hk = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, hk, h // hk, hd) * (math.log2(math.e) / math.sqrt(hd))
    scores = torch.einsum("bgrd,btgd->bgrt", qg, k.float())
    pos = torch.arange(t)
    parts = []
    for s in range(splits):
        valid = ((pos >= s * chunk) & (pos < (s + 1) * chunk)
                 & (pos[None] < lens[:, None].long()))[:, None, None]
        sc = scores.masked_fill(~valid, -math.inf)
        m = sc.amax(dim=-1)  # -inf on an empty chunk
        p = torch.where(valid, torch.exp2(sc - m.clamp(min=-1e30)[..., None]), 0.0)
        parts.append((m, p.sum(dim=-1), torch.einsum("bgrt,btgd->bgrd", p, v.float())))
    top = torch.stack([torch.where(l > 0, m, -math.inf) for m, l, _ in parts]).amax(dim=0)
    num = torch.zeros(b, hk, h // hk, hd)
    den = torch.zeros(b, hk, h // hk)
    for m, l, acc in parts:
        w = torch.where(l > 0, torch.exp2(m - top), 0.0)
        num += w[..., None] * acc
        den += w * l
    return (num / den.clamp(min=1e-30)[..., None]).reshape(b, h, hd).to(q.dtype)


@pytest.mark.parametrize("b,t,h,hk,hd,lens", [
    (5, 1000, 9, 3, 64, [0, CHUNK - 1, CHUNK, CHUNK + 1, 1000]),  # T no multiple of C
    (2, 1088, 9, 3, 64, [1025, 1087]),  # the serving run's lengths
    (1, 700, 12, 1, 80, [650]),  # rep 12, hd 80, many splits
    (3, 64, 10, 2, 32, [0, 1, 64]),  # one split
])
def test_split_and_combine_equal_plain(b, t, h, hk, hd, lens):
    q, k, v, lens = _inputs(b, t, h, hk, hd, seed=t + h, lens=lens)
    _, tt = _both(q, k, v, lens, "float32")
    chunk, splits = da.split_plan(b, hk, h // hk, t)
    got = _split_and_combine(*tt, chunk, splits)
    want = da.decode_attention_plain(*tt)
    torch.testing.assert_close(got, want, rtol=2e-6, atol=2e-6)
    assert torch.count_nonzero(got[lens == 0]) == 0


# --------------------------------------------------------------------------- #
# The registered op repro_torch::decode_attention
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_registered_op_passes_opcheck_and_equals_plain(dtype):
    """Schema, fake implementation, autograd registration and dynamic
    shapes (``torch.library.opcheck``); on CPU tensors the op is the plain
    version bit for bit."""
    _, tt = _both(*_inputs(3, 320, 9, 3, 64, seed=4, lens=[1, 320, 77]), dtype)
    torch.library.opcheck(da.OP, tuple(tt))
    assert torch.equal(da.OP(*tt), da.decode_attention_plain(*tt))
    assert torch.equal(da.decode_attention(*tt), da.decode_attention_plain(*tt))


def test_fake_implementation_gives_shape_and_dtype():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        q = torch.empty(4, 12, 64, dtype=torch.bfloat16)
        k = torch.empty(4, 2048, 3, 64, dtype=torch.bfloat16)
        out = da.decode_attention(q, k, k, torch.empty(4, dtype=torch.int32))
    assert (out.shape, out.dtype, out.device) == (q.shape, q.dtype, q.device)


def test_flop_formula_counts_both_products_over_the_allocated_cache():
    """4 * B * H * T * hd, T the cache's allocated length (whatever the
    lengths), as ``FlopCounterMode`` reads it."""
    from torch.utils.flop_counter import FlopCounterMode

    b, t, h, hk, hd = 2, 256, 8, 2, 32
    _, tt = _both(*_inputs(b, t, h, hk, hd, lens=[1, 17]), "float32")
    with FlopCounterMode(display=False) as fc:
        da.decode_attention(*tt)
    assert fc.get_total_flops() == 4 * b * h * t * hd
