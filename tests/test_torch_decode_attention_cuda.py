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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kv_must_start_on_16_bytes(cuda, dtype):
    """K and V are copied in 16-byte pieces: a contiguous view at another
    offset is refused before launch; one at a 16-byte offset runs."""
    q, k, v, lens = _inputs(cuda, 2, 64, 4, 2, 32, dtype)
    per16 = 16 // k.element_size()

    def view_at(x, offset):
        flat = torch.zeros(x.numel() + per16, dtype=dtype, device=cuda)
        flat[offset:offset + x.numel()] = x.reshape(-1)
        return flat[offset:offset + x.numel()].view(x.shape)

    launches = da.LAUNCHES
    for name, bad in (("k", (view_at(k, 1), v)), ("v", (k, view_at(v, 1)))):
        assert bad[0].is_contiguous() and bad[1].is_contiguous(), name
        with pytest.raises(ValueError, match="16-byte"):
            da.decode_attention(q, *bad, lens)
    assert da.LAUNCHES == launches
    _check(da.decode_attention(q, view_at(k, per16), view_at(v, per16), lens),
           da.decode_attention_plain(q, k, v, lens), dtype)


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


# ---- the split-T design: chunk edges, many splits, more reps, streams -------- #

CHUNK = da.split_plan(8, 3, 3, 1088)[0]  # the serving shape's chunk


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lengths_at_the_chunk_edges(cuda, dtype):
    """Lengths C - 1, C, C + 1 and T, with T no multiple of C."""
    t = 1000
    assert t % CHUNK and da.split_plan(5, 3, 3, t)[0] == CHUNK
    q, k, v, lens = _inputs(cuda, 5, t, 9, 3, 64, dtype, seed=11,
                            lens=[CHUNK - 1, CHUNK, CHUNK + 1, t, 0])
    _check(da.decode_attention(q, k, v, lens), da.decode_attention_plain(q, k, v, lens),
           dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_row_at_32k_takes_many_splits(cuda, dtype):
    t = 32_768
    assert da.split_plan(1, 3, 3, t)[1] > 100
    for lens in ([t], [20_001], [1]):
        q, k, v, n = _inputs(cuda, 1, t, 9, 3, 64, dtype, seed=12, lens=lens)
        _check(da.decode_attention(q, k, v, n), da.decode_attention_plain(q, k, v, n), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 80])
@pytest.mark.parametrize("rep", [5, 7, 12])
def test_config_reps_and_head_dims(cuda, dtype, hd, rep):
    """The reps and head dims the model configs use beyond the tests above."""
    q, k, v, lens = _inputs(cuda, 3, 777, rep * 2, 2, hd, dtype, seed=rep * hd,
                            lens=[0, 300, 777])
    _check(da.decode_attention(q, k, v, lens), da.decode_attention_plain(q, k, v, lens),
           dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_repeat_calls_are_bit_identical(cuda, dtype):
    q, k, v, lens = _inputs(cuda, 8, 1088, 9, 3, 64, dtype, seed=13,
                            lens=[1025, 1030, 1040, 1050, 1060, 1070, 1080, 1087])
    first = da.decode_attention(q, k, v, lens)
    for _ in range(3):
        assert torch.equal(da.decode_attention(q, k, v, lens), first)


def test_launch_on_a_side_stream(cuda):
    q, k, v, lens = _inputs(cuda, 8, 1088, 9, 3, 64, torch.bfloat16, seed=14)
    want = da.decode_attention_plain(q, k, v, lens)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = da.decode_attention(q, k, v, lens)
    side.synchronize()
    _check(got, want, torch.bfloat16)
