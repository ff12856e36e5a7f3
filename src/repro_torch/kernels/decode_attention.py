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

The function is the registered op ``repro_torch::decode_attention``
(``torch.ops.repro_torch.decode_attention``): its CUDA implementation is
the launch (:func:`_launch`), its CPU implementation the plain version, and
its fake implementation gives the output's shape and dtype and touches no
pointer, so the dry-run (``launch/dryrun.py``) traces it on fake tensors
as the card would run it.  Its FLOP formula (for
``torch.utils.flop_counter``) is ``4 * B * H * T * hd``, T the cache's
allocated length; on DTensors it runs where the batch is sharded (each
piece on its own rows) or the heads (q's heads with their KV heads).
Each implementation checks the tensors it is given (:func:`_check`):
under DTensor those are a rank's local pieces.

``LAUNCHES`` counts op calls that launched the kernel (one per call,
whether it made one launch or two; plain-version calls do not count).
"""
from __future__ import annotations

import functools
import math

import torch
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding
from torch.utils.flop_counter import register_flop_formula

from ._build import CSRC, Entry

_SOURCE = CSRC / "decode_attention.cu"
_SOURCES = (_SOURCE,)
# q k v cache_len, B T H Hk hd, scale, chunk splits, out partials
_LAUNCH = {
    torch.float32: Entry(_SOURCE, "decode_attention_f32"),
    torch.bfloat16: Entry(_SOURCE, "decode_attention_bf16"),
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


def _check(q, k, v, cache_len) -> None:
    """What the kernel takes, as plain attribute compares."""
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


def _launch(q, k, v, cache_len) -> torch.Tensor:
    """The op's CUDA implementation: the kernel on the current stream,
    without synchronising."""
    global LAUNCHES
    _check(q, k, v, cache_len)
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("k and v must start on a 16-byte boundary (the kernel copies "
                         "them in 16-byte pieces)")
    b, h, hd = q.shape
    t, hk = k.shape[1], k.shape[2]
    chunk, splits = split_plan(b, hk, h // hk, t)
    out = torch.empty_like(q)
    # float32 partials: acc [S, B*H, hd], then (m, l) [S, B*H, 2]
    part = (torch.empty(splits * b * h * (hd + 2), dtype=torch.float32, device=q.device)
            if splits > 1 else None)
    _LAUNCH[q.dtype](q.device.index, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     cache_len.data_ptr(), b, t, h, hk, hd, 1.0 / math.sqrt(hd), chunk,
                     splits, out.data_ptr(), 0 if part is None else part.data_ptr())
    LAUNCHES += 1
    return out


def _plain(q, k, v, cache_len) -> torch.Tensor:
    """The op's CPU implementation."""
    _check(q, k, v, cache_len)
    return decode_attention_plain(q, k, v, cache_len)


_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("decode_attention(Tensor q, Tensor k, Tensor v, Tensor cache_len) -> Tensor")
_LIB.impl("decode_attention", _launch, "CUDA")
_LIB.impl("decode_attention", _plain, "CPU")


@torch.library.register_fake("repro_torch::decode_attention", lib=_LIB)
def _fake(q, k, v, cache_len):
    _check(q, k, v, cache_len)
    return torch.empty_like(q)


OP = torch.ops.repro_torch.decode_attention.default


@register_flop_formula(torch.ops.repro_torch.decode_attention)
def _flops(q_shape, k_shape, *args, **kwargs) -> int:
    """Two products of hd per (row, head, position): q.k and p.v."""
    b, h, hd = q_shape
    return 4 * b * h * k_shape[1] * hd


@register_sharding(OP)
def _sharding(q, k, v, cache_len):
    """Placements per mesh dim, (out, (q, k, v, cache_len)): whole, rows
    split, or heads split where every mesh dim divides the KV heads (so
    each piece of q's heads meets its own KV heads)."""
    out = [([Replicate()], [Replicate()] * 4), ([Shard(0)], [Shard(0)] * 4)]
    if all(k.shape[2] % n == 0 for n in k.mesh.shape):
        out.append(([Shard(1)], [Shard(1), Shard(2), Shard(2), Replicate()]))
    return out


def decode_attention(q, k, v, cache_len) -> torch.Tensor:
    """[B, H, hd] attention of one token per row over the first
    ``cache_len[b]`` positions of ``k``/``v`` (see the module docstring).

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream, without synchronising.
    """
    return OP(q, k, v, cache_len)
