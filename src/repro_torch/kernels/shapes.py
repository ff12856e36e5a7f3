"""Shared padding / power-of-two bucketing helpers.

One home for the shape policy every device path depends on: the
:class:`~repro_torch.core.plan_cache.PlanCache` buckets list lengths and the
leading work-item axis, and ``pad_to`` pads posting lists to block multiples.

numpy-only on purpose: importable from host-side packing code without
pulling in torch.
"""
from __future__ import annotations

import numpy as np

INT_PAD = np.int32(np.iinfo(np.int32).max)


def bucket_pow2(n: int, lo: int = 1) -> int:
    """Smallest power-of-two multiple of ``lo`` that is >= ``n``.

    ``lo`` must itself be a power of two; ``n <= 0`` clamps to ``lo`` (an
    empty input still needs one block).  Monotone: more data never maps to
    a smaller bucket, so the set of distinct buckets (= compiled kernel
    variants) grows logarithmically with the largest input ever seen.
    """
    if lo < 1 or (lo & (lo - 1)):
        raise ValueError(f"lo must be a positive power of two, got {lo}")
    b = lo
    while b < n:
        b <<= 1
    return b


def bucket(n: int, minimum: int = 16) -> int:
    """PlanCache's list-length bucket (power of two, floor ``minimum``)."""
    return bucket_pow2(n, lo=minimum)


def pad_to(arr: np.ndarray, mult: int, fill) -> np.ndarray:
    """Pad the last axis of a 1-D/2-D int array up to a multiple of ``mult``.

    The result always has at least one full block (an empty array pads to
    ``mult``), and is a fresh int32 array — callers mutate pads freely.
    """
    n = arr.shape[-1]
    m = ((n + mult - 1) // mult) * mult
    m = max(m, mult)
    if arr.ndim == 1:
        out = np.full((m,), fill, dtype=np.int32)
        out[:n] = arr
    else:
        out = np.full((arr.shape[0], m), fill, dtype=np.int32)
        out[:, :n] = arr
    return out
