"""The port's decode attention == the reference's Pallas kernel and its oracle.

The same numpy inputs go to ``repro.kernels.decode_attention`` (the Pallas
kernel in interpret mode, as ``tests/test_decode_attention_kernel.py`` runs
it), ``repro.kernels.ref.decode_attention_ref`` and the port's
``decode_attention`` on CPU tensors, which is its plain version.
Tolerances are the reference test's own: 2e-5 in float32, 2e-2 in bfloat16.
"""
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
