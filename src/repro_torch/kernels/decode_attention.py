"""GQA decode attention: one new token per row against a length-masked cache.

``o[b, h] = softmax_t<len[b](q[b, h] . k[b, t, h // rep] / sqrt(hd)) @ v[b, :, h // rep]``
for ``q`` [B, H, hd], ``k``/``v`` [B, T, Hk, hd] and ``cache_len`` [B]
int32, with ``rep = H // Hk``, float32 accumulation and the output in q's
dtype.  A row with ``cache_len == 0`` gives zeros, as the reference's Pallas
kernel does (its oracle ``ref.decode_attention_ref`` gives the mean of v).

The decode branch of ``models.attention.gqa_apply`` calls
:func:`decode_attention` once per layer and step.  For CUDA tensors it
launches the hand-written kernel in ``csrc/decode_attention.cu``: T is split
into :func:`split_plan`'s chunks across blocks (flash-decoding), K and V are
staged through shared memory, and a second launch merges the chunks'
partial results when there is more than one.  The kernel copies K and V
in 16-byte pieces, so on the card ``k`` and ``v`` must start on a 16-byte
boundary (any whole allocation does; a view at an odd offset is refused
with ``ValueError``).  For CPU tensors it runs
:func:`decode_attention_plain`, the same function in plain PyTorch.  There
is no fallback between the two: a CUDA tensor reaches the kernel or raises.

``LAUNCHES`` counts wrapper calls that launched the kernel (one per call,
whether it made one launch or two; plain-version calls do not count).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ._build import CSRC, Entry

_SOURCE = CSRC / "decode_attention.cu"
_ARGS = (
    [ctypes.c_void_p] * 4  # q k v cache_len
    + [ctypes.c_int] * 5  # B T H Hk hd
    + [ctypes.c_float]  # scale
    + [ctypes.c_int] * 2  # chunk splits
    + [ctypes.c_void_p] * 2  # out partials
)
_LAUNCH = {
    torch.float32: Entry(_SOURCE, "decode_attention_f32", _ARGS),
    torch.bfloat16: Entry(_SOURCE, "decode_attention_bf16", _ARGS),
}
MAX_HEAD_DIM = 256
MAX_ROWS = 16  # query rows a block serves (kMaxRows in the source)
SMS = 132  # the H100's streaming multiprocessors
FILL_BLOCKS = 4 * SMS  # blocks split_plan aims for: a few per SM
CHUNK_MIN = 64  # one tile of the kernel's smallest-row kind
CHUNK_MAX = 1024  # longest chunk: keeps a ragged batch's blocks even

LAUNCHES = 0  # wrapper calls that launched the kernel (see module docstring)


def rows_per_block(rep: int) -> int:
    """Query rows one block serves: rep rounded up to a power of two, at most
    ``MAX_ROWS`` (the source's dispatch)."""
    return 1 << (max(rep, 1) - 1).bit_length() if rep <= 8 else MAX_ROWS


@functools.lru_cache(maxsize=256)
def split_plan(b: int, hk: int, rep: int, t: int) -> tuple[int, int]:
    """(chunk, splits): the kernel's split of T across blocks.

    Split ``s`` covers positions ``[s * chunk, min((s + 1) * chunk, T))``,
    so the splits cover ``[0, T)`` once.  From the shapes alone (host
    ints; the lengths stay on the device): enough splits that the
    ``b * hk * ceil(rep / rows_per_block(rep))`` row groups make about
    ``FILL_BLOCKS`` blocks, with chunks a multiple of ``CHUNK_MIN`` and at
    most ``CHUNK_MAX`` positions long.  ``splits`` is 1 when T fits one
    chunk; then the kernel writes the output itself.
    """
    groups = max(1, b * hk * -(-rep // rows_per_block(rep)))
    want = -(-FILL_BLOCKS // groups)
    chunk = -(-t // want)
    chunk = min(max(-(-chunk // CHUNK_MIN) * CHUNK_MIN, CHUNK_MIN), CHUNK_MAX)
    return chunk, max(1, -(-t // chunk))


def decode_attention_plain(q, k, v, cache_len) -> torch.Tensor:
    """The kernel's function in plain PyTorch.

    Groups q as [B, Hk, rep, hd] instead of repeating K/V, so the cache is
    read as it lies; float32 throughout, empty rows give zeros.
    """
    b, h, hd = q.shape
    t, hk = k.shape[1], k.shape[2]
    if t == 0:
        return torch.zeros_like(q)
    qg = q.float().reshape(b, hk, h // hk, hd)
    scores = torch.einsum("bgrd,btgd->bgrt", qg, k.float()) * (1.0 / math.sqrt(hd))
    valid = (torch.arange(t, device=k.device)[None, :] < cache_len[:, None])[:, None, None]
    scores = scores.masked_fill(~valid, -1e30)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True)) * valid
    acc = torch.einsum("bgrt,btgd->bgrd", p, v.float())
    out = acc / p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    return out.reshape(b, h, hd).to(q.dtype)


def _check(q, k, v, cache_len) -> torch.device:
    """What the kernel takes, as plain attribute compares; returns the device."""
    qs, ks = q.shape, k.shape
    if len(qs) != 3 or len(ks) != 4 or v.shape != ks:
        raise ValueError(
            f"want q [B, H, hd] and k, v [B, T, Hk, hd], got {tuple(qs)}, "
            f"{tuple(ks)}, {tuple(v.shape)}"
        )
    b, h, hd = qs
    if ks[0] != b or ks[3] != hd or h % ks[2]:
        raise ValueError(f"q {tuple(qs)} does not fit k, v {tuple(ks)}")
    if hd % 8 or not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim must be a multiple of 8 up to {MAX_HEAD_DIM}, got {hd}")
    if q.dtype not in _LAUNCH or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"q, k, v must share float32 or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if cache_len.dtype != torch.int32 or cache_len.shape != (b,):
        raise ValueError(f"cache_len must be int32 [{b}], got {cache_len.dtype} "
                         f"{tuple(cache_len.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
            and cache_len.is_contiguous()):
        raise ValueError("q, k, v and cache_len must be contiguous")
    dev = q.device
    if k.device != dev or v.device != dev or cache_len.device != dev:
        name, x = next((n, x) for n, x in (("k", k), ("v", v), ("cache_len", cache_len))
                       if x.device != dev)
        raise ValueError(f"{name} is on {x.device}, q on {dev}")
    if dev.type != "cuda" and dev.type != "cpu":
        raise ValueError(f"the kernels run on cpu or cuda, not {dev}")
    if dev.type == "cuda" and (k.data_ptr() % 16 or v.data_ptr() % 16):
        raise ValueError("k and v must start on a 16-byte boundary (the kernel copies "
                         "them in 16-byte pieces)")
    return dev


def decode_attention(q, k, v, cache_len) -> torch.Tensor:
    """[B, H, hd] attention of one token per row over the first
    ``cache_len[b]`` positions of ``k``/``v`` (see the module docstring).

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream, without synchronising.
    """
    global LAUNCHES
    dev = _check(q, k, v, cache_len)
    if dev.type == "cpu":
        return decode_attention_plain(q, k, v, cache_len)
    b, h, hd = q.shape
    t, hk = k.shape[1], k.shape[2]
    chunk, splits = split_plan(b, hk, h // hk, t)
    out = torch.empty_like(q)
    # float32 partials: acc [S, B*H, hd], then (m, l) [S, B*H, 2]
    part = (torch.empty(splits * b * h * (hd + 2), dtype=torch.float32, device=dev)
            if splits > 1 else None)
    _LAUNCH[q.dtype](dev.index, q.data_ptr(), k.data_ptr(), v.data_ptr(), cache_len.data_ptr(),
                     b, t, h, hk, hd, 1.0 / math.sqrt(hd), chunk, splits,
                     out.data_ptr(), None if part is None else part.data_ptr())
    LAUNCHES += 1
    return out
