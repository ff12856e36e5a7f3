"""Prefix-DAG KV cache: the paper's insight applied to LM serving.

IDCluster hash-conses repeated XML subtrees so each is indexed/searched once.
Serving batches have the same shape of redundancy: shared system prompts,
templated few-shot prefixes, common retrieval headers.  We hash-cons token
*blocks* (fixed size) into a prefix DAG — a block's identity is
(parent_block, tokens) — so every distinct prefix chain is prefilled exactly
once, however many requests share it (the RCPM analogue is the per-request
pointer to its deepest shared block).

``plan_batch`` is the scheduler-facing artifact: given a batch of prompts it
returns the unique chains to prefill and per-request (chain, tail) splits,
plus the compute-savings accounting that benchmarks/bench_prefix_dag.py
reports.  ``run_with_prefix_dag`` executes the plan against a model: prefill
each unique chain once, broadcast the cache to the requests that share it,
then prefill only each request's tail.

A copy of the reference's ``repro.serve.prefix_dag``; only
``run_with_prefix_dag`` differs, because the port's cache is written in
place (see there).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.models import init_cache, prefill
from repro_torch.tree import tree_map


@dataclass
class PrefixDAG:
    block: int = 16
    # block id -> (parent_id, tokens-bytes); id 0 is the empty root
    nodes: dict[int, tuple[int, bytes]] = field(default_factory=dict)
    _index: dict[tuple[int, bytes], int] = field(default_factory=dict)
    hits: int = 0
    misses: int = 0

    def insert(self, tokens: np.ndarray) -> list[int]:
        """Insert a prompt; returns its chain of block ids (hash-consed)."""
        chain = [0]
        cur = 0
        # keep >=1 token outside the dag so every request has a non-empty tail
        n_full = max(0, (len(tokens) - 1)) // self.block
        for i in range(n_full):
            blk = tokens[i * self.block : (i + 1) * self.block]
            key = (cur, blk.astype(np.int32).tobytes())
            got = self._index.get(key)
            if got is None:
                got = len(self.nodes) + 1
                self._index[key] = got
                self.nodes[got] = key
                self.misses += 1
            else:
                self.hits += 1
            chain.append(got)
            cur = got
        return chain

    def chain_tokens(self, block_id: int) -> np.ndarray:
        """Materialize the token prefix for a block chain."""
        parts = []
        cur = block_id
        while cur != 0:
            parent, blk = self.nodes[cur]
            parts.append(np.frombuffer(blk, dtype=np.int32))
            cur = parent
        return np.concatenate(parts[::-1]) if parts else np.zeros(0, np.int32)


@dataclass
class BatchPlan:
    unique_chains: list[int]  # deepest shared block per group
    groups: dict[int, list[int]]  # chain block -> request indices
    tails: list[np.ndarray]  # per-request remainder tokens
    total_tokens: int
    unique_tokens: int

    @property
    def savings(self) -> float:
        """Fraction of prefill tokens removed by prefix dedup."""
        tail = sum(len(t) for t in self.tails)
        return 1.0 - (self.unique_tokens + tail) / max(self.total_tokens, 1)


def plan_batch(prompts: list[np.ndarray], block: int = 16) -> tuple[PrefixDAG, BatchPlan]:
    dag = PrefixDAG(block=block)
    chains = [dag.insert(p) for p in prompts]
    groups: dict[int, list[int]] = {}
    tails = []
    for i, (p, chain) in enumerate(zip(prompts, chains)):
        deepest = chain[-1]
        groups.setdefault(deepest, []).append(i)
        tails.append(p[(len(chain) - 1) * block :])
    unique_blocks = set()
    for chain in chains:
        unique_blocks.update(chain[1:])
    plan = BatchPlan(
        unique_chains=sorted(groups),
        groups=groups,
        tails=tails,
        total_tokens=sum(len(p) for p in prompts),
        unique_tokens=len(unique_blocks) * block,
    )
    return dag, plan


def _clone(leaf):
    return leaf.clone() if isinstance(leaf, torch.Tensor) else leaf


def run_with_prefix_dag(params, cfg, prompts: list[np.ndarray], max_len: int,
                        block: int = 16):
    """Execute a batch with shared-prefix dedup (reference implementation).

    Each unique chain is prefilled once (batch of 1), on the model's device.
    The reference then shares the chain's immutable cache with every
    request of its group; here a prefill writes the tail into its cache in
    place, so each request gets its own copy of the chain's cache (every
    tensor leaf: KV rows, latents, recurrent states), and the chain's own
    stays as it was; a recurrent state after the chain is the state the
    tail continues from.  Per-request tails are prefilled
    individually.  Returns (last_logits [N, V], per-request caches, plan).
    """
    dev = params.embed.table.device
    dag, plan = plan_batch(prompts, block=block)
    chain_cache: dict[int, list] = {}
    for blk in plan.unique_chains:
        toks = dag.chain_tokens(blk)
        cache = init_cache(cfg, 1, max_len, dev)
        if len(toks):
            _, cache = prefill(params, cfg, torch.as_tensor(toks[None], device=dev), cache)
        chain_cache[blk] = cache

    n = len(prompts)
    outs = [None] * n
    caches = [None] * n
    for blk, members in plan.groups.items():
        chain_len = len(dag.chain_tokens(blk))
        for i in members:
            cache = tree_map(_clone, chain_cache[blk])
            tail = plan.tails[i]
            logits, cache = prefill(
                params, cfg, torch.as_tensor(tail[None].astype(np.int32), device=dev),
                cache, start=chain_len,
            )
            outs[i] = logits[0]
            caches[i] = cache
    return torch.stack(outs), caches, plan
