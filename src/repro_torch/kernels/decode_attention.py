"""GQA decode attention: one new token per row against a length-masked cache.

``o[b, h] = softmax_t<len[b](q[b, h] . k[b, t, h // rep] / sqrt(hd)) @ v[b, :, h // rep]``
for ``q`` [B, H, hd], ``k``/``v`` [B, T, Hk, hd] and ``cache_len`` [B]
int32, with ``rep = H // Hk``, float32 accumulation and the output in q's
dtype.  A row with ``cache_len == 0`` gives zeros, as the reference's Pallas
kernel does (its oracle ``ref.decode_attention_ref`` gives the mean of v).

The decode branch of ``models.attention.gqa_apply`` calls
:func:`decode_attention` once per layer and step.  For CUDA tensors it
launches the hand-written kernel in ``csrc/decode_attention.cu`` (one block
per batch row and kv-head, online softmax over the valid prefix); for CPU
tensors it runs :func:`decode_attention_plain`, the same function in plain
PyTorch.  There is no fallback between the two: a CUDA tensor reaches the
kernel or raises.

``LAUNCHES`` counts kernel launches (plain-version calls do not count).
"""
from __future__ import annotations

import ctypes
import math

import torch

from ._build import CSRC, launch

_SOURCE = CSRC / "decode_attention.cu"
_ARGS = (
    [ctypes.c_void_p] * 4  # q k v cache_len
    + [ctypes.c_int] * 5  # B T H Hk hd
    + [ctypes.c_float]  # scale
    + [ctypes.c_void_p] * 2  # out stream
)
_ENTRY = {torch.float32: "decode_attention_f32", torch.bfloat16: "decode_attention_bf16"}
_FUNCTIONS = {name: _ARGS for name in _ENTRY.values()}
MAX_HEAD_DIM = 256

LAUNCHES = 0  # kernel launches in this process (see module docstring)


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
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"want q [B, H, hd] and k, v [B, T, Hk, hd], got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or h % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not fit k, v {tuple(k.shape)}")
    if hd % 8 or not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim must be a multiple of 8 up to {MAX_HEAD_DIM}, got {hd}")
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"q, k, v must share float32 or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if cache_len.dtype != torch.int32 or cache_len.shape != (b,):
        raise ValueError(f"cache_len must be int32 [{b}], got {cache_len.dtype} "
                         f"{tuple(cache_len.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v), ("cache_len", cache_len)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the kernels run on cpu or cuda, not {q.device}")
    return q.device


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
    out = torch.empty_like(q)
    launch(_SOURCE, _FUNCTIONS, _ENTRY[q.dtype], dev, q, k, v, cache_len,
           b, k.shape[1], h, k.shape[2], hd, 1.0 / math.sqrt(hd), out)
    LAUNCHES += 1
    return out
