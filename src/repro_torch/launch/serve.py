"""Serving driver: batched prefill + greedy decode, optional prefix-DAG dedup.

The port of ``repro.launch.serve``, with the same flags and prints.  It
runs on the CUDA card unless ``--device cpu`` is given (and raises without
CUDA otherwise); each decode step's attention goes through the hand-written
``decode_attention`` kernel there.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
      --requests 8 --prompt-len 64 --gen 16 --prefix-dag
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu

``make_prompts`` and ``serve`` are the functions behind ``main``, for
callers that drive the path themselves (``chip_smoke.py``).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.api import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import ModelConfig, decode_step, init_cache, init_params, prefill
from repro_torch.serve.prefix_dag import run_with_prefix_dag
from repro_torch.tree import tree_map


def make_prompts(vocab: int, requests: int, prompt_len: int, shared_prefix: int,
                 seed: int) -> list[np.ndarray]:
    """``requests`` prompts of ``prompt_len`` int32 tokens that share their
    first ``shared_prefix`` (the reference's prompts for the same seed)."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, size=shared_prefix, dtype=np.int32)
    return [
        np.concatenate([shared, rng.integers(0, vocab, size=prompt_len - shared_prefix,
                                             dtype=np.int32)])
        for _ in range(requests)
    ]


def _batched(first, *rest):
    return torch.cat([first, *rest]) if isinstance(first, torch.Tensor) else first


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(model, cfg: ModelConfig, prompts: list[np.ndarray], gen: int,
          prefix_dag: bool = False) -> dict:
    """Prefill the prompts (one batch, or per prefix-DAG chain and tail),
    then ``gen - 1`` greedy decode steps on the model's device.

    Returns ``tokens`` [N, gen] (the first from the prefill's logits),
    ``logits`` [N, V] of the last step, ``t_prefill`` and ``t_decode`` in
    seconds (host clock, after a device sync) and the plan's ``savings``
    (None without the prefix DAG).
    """
    dev = model.embed.table.device
    n, prompt_len = len(prompts), len(prompts[0])
    max_len = prompt_len + gen
    savings = None
    _sync(dev)
    t0 = time.perf_counter()
    if prefix_dag:
        logits, caches, plan = run_with_prefix_dag(model, cfg, prompts, max_len=max_len)
        savings = plan.savings
        # one batch of per-request caches: every tensor leaf concatenated on
        # the batch axis ("len" equal: the prompts share a length)
        cache = [tree_map(_batched, *(c[i] for c in caches)) for i in range(cfg.n_layers)]
    else:
        batch = torch.as_tensor(np.stack(prompts), device=dev)
        cache = init_cache(cfg, n, max_len, dev)
        logits, cache = prefill(model, cfg, batch, cache)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    tok = logits.argmax(dim=-1)[:, None].to(torch.int32)
    generated = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, cache = decode_step(model, cfg, tok, cache, prompt_len + i)
        tok = logits.argmax(dim=-1)[:, None].to(torch.int32)
        generated.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return {"tokens": torch.cat(generated, dim=1), "logits": logits,
            "t_prefill": t_prefill, "t_decode": t_decode, "savings": savings}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--shared-prefix", type=int, default=40)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--prefix-dag", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.encoder_only:
        raise SystemExit(f"{cfg.name} is encoder-only: nothing to decode")

    prompts = make_prompts(cfg.vocab, args.requests, args.prompt_len,
                           args.shared_prefix, args.seed)
    model = init_params(args.seed, cfg, dev)
    out = serve(model, cfg, prompts, args.gen, args.prefix_dag)
    if out["savings"] is not None:
        print(f"prefix-DAG savings: {100 * out['savings']:.0f}% of prefill tokens")
    print(f"prefill: {args.requests}×{args.prompt_len} tokens in {out['t_prefill']:.2f}s")
    print(
        f"decode: {args.gen - 1} steps × {args.requests} seqs "
        f"-> {(args.gen - 1) * args.requests / max(out['t_decode'], 1e-9):.1f} tok/s"
    )
    print("sample continuation:", out["tokens"][0][:12].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
