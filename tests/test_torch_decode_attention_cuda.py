"""The decode-attention CUDA kernel == its plain PyTorch version, on the card.

Runs only where a CUDA device is present (the kernel has no CPU mode); on a
host without one every test here skips.  Imports nothing of the JAX
package, so it runs on a card host that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_decode_attention_cuda.py

Tolerances: 2e-5 in float32 and 2e-2 in bfloat16, the reference kernel
test's own; the kernel and the plain version both accumulate in float32,
in other orders.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as da

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the decode-attention kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(dev, b, t, h, hk, hd, dtype, lens=None, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(dev, dtype)
               for s in ((b, h, hd), (b, t, hk, hd), (b, t, hk, hd)))
    if lens is None:
        lens = rng.integers(0, t + 1, size=b)
    return q, k, v, torch.tensor(lens, dtype=torch.int32, device=dev)


def _check(got, want, dtype):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128, 160, 192])
@pytest.mark.parametrize("rep", [1, 3, 4, 8])
def test_kernel_matches_plain(cuda, dtype, hd, rep):
    hk = 2
    b, t = 5, 301  # ragged T, no block multiple
    q, k, v, lens = _inputs(cuda, b, t, rep * hk, hk, hd, dtype, lens=[0, 1, t, 150, 77],
                            seed=hd * rep)
    launches = da.LAUNCHES
    got = da.decode_attention(q, k, v, lens)
    assert da.LAUNCHES == launches + 1
    want = da.decode_attention_plain(q, k, v, lens)
    _check(got, want, dtype)
    assert torch.count_nonzero(got[0]) == 0  # an empty row gives zeros


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,hk,hd", [
    (8, 1088, 9, 3, 64),     # SmolLM-135M serving
    (2, 4096, 24, 8, 128),   # Phi-4-mini
    (3, 513, 12, 1, 32),     # rep 12 > 8 rows: two row blocks
    (1, 1, 4, 4, 8),
    (4, 0, 4, 2, 16),        # an empty cache
])
def test_kernel_matches_plain_at_serving_shapes(cuda, dtype, b, t, h, hk, hd):
    q, k, v, lens = _inputs(cuda, b, t, h, hk, hd, dtype, seed=b + t + h)
    _check(da.decode_attention(q, k, v, lens), da.decode_attention_plain(q, k, v, lens),
           dtype)


def test_entries_past_len_do_not_matter(cuda):
    q, k, v, _ = _inputs(cuda, 2, 700, 6, 2, 64, torch.bfloat16)
    lens = torch.tensor([100, 650], dtype=torch.int32, device=cuda)
    out = da.decode_attention(q, k, v, lens)
    k[0, 100:] = 999.0
    v[0, 100:] = -999.0
    k[1, 650:] = float("nan")
    assert torch.equal(out, da.decode_attention(q, k, v, lens))


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q, k, v, lens = _inputs(cuda, 2, 64, 4, 2, 32, torch.float32)
    launches = da.LAUNCHES
    with pytest.raises(ValueError, match="contiguous"):
        da.decode_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2), v, lens)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        da.decode_attention(q.half(), k.half(), v.half(), lens)
    with pytest.raises(ValueError, match="on cpu"):
        da.decode_attention(q, k, v, lens.cpu())
    with pytest.raises(ValueError, match="multiple of 8"):
        da.decode_attention(*(x[..., :20].contiguous() for x in (q, k, v)), lens)
    assert da.LAUNCHES == launches


def test_cuda_tensor_without_a_kernel_raises(cuda, monkeypatch, tmp_path):
    """A kernel that cannot be built raises; it never falls back to plain."""
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    q, k, v, lens = _inputs(cuda, 2, 64, 4, 2, 32, torch.float32)
    launches = da.LAUNCHES
    with pytest.raises(RuntimeError, match="nvcc not found"):
        da.decode_attention(q, k, v, lens)
    assert da.LAUNCHES == launches
    da.decode_attention(q.cpu(), k.cpu(), v.cpu(), lens.cpu())  # the CPU takes the plain version
