"""Model assembly: blocks, LM head, KV cache, prefill and decode steps.

An ``nn.Module`` model: ``Model.blocks`` is a ``ModuleList`` walked by a
Python loop where the reference runs ``lax.scan`` over stacked parameters,
so each layer keeps its own parameters and cache.  The functional entry
points keep the reference's names and arguments (``init_params``,
``forward``, ``prefill``, ``decode_step``, ``init_cache``), with the model
in place of the parameter tree.  The reference's sharding constraints
(``dist.ctx``) are dropped: multi-GPU is its own ROADMAP item.

Blocks: the GQA mixer with a SwiGLU, squared-ReLU or GELU FFN (or none).
The MLA, Mamba and RWKV-6 mixers and the MoE and RWKV-6 channel-mix FFNs
raise ``NotImplementedError``: they come with ROADMAP §1's LM items.

The cache is a list with one dict per layer, ``{"k", "v": [B, T, Hk, hd],
"len": int}``; ``len`` is a host int, as the reference keeps it a scalar.
The steps write into the cache tensors in place and return the list with
the new lengths.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.api import resolve_device

from .attention import GQA, decode_lengths, gqa_apply, gqa_cache_init
from .config import ModelConfig
from .layers import MLP, Embedding, Head, RMSNorm, embed, head, torch_dtype, unembed

_NOT_PORTED = {
    "mla": "ROADMAP §1: the MLA mixer",
    "mamba": "ROADMAP §1: the SSM mixers",
    "rwkv6": "ROADMAP §1: the SSM mixers",
    "moe": "ROADMAP §1: the MoE FFN",
    "rwkv6_cm": "ROADMAP §1: the SSM mixers",
}


def _check_kinds(kinds: tuple[str, str]) -> None:
    """A (mixer, ffn) pair the port has; raises for one it has not."""
    for kind in kinds:
        if kind in _NOT_PORTED:
            raise NotImplementedError(
                f"block kind {kind!r} is not ported yet ({_NOT_PORTED[kind]})")
    if kinds[0] != "gqa" or kinds[1] not in ("swiglu", "relu2", "gelu", "none"):
        raise ValueError(f"unknown block kinds {kinds}")


class Block(nn.Module):
    def __init__(self, kinds: tuple[str, str], cfg: ModelConfig, dtype, device):
        super().__init__()
        _check_kinds(kinds)
        self.ffn_kind = kinds[1]
        self.norm1 = RMSNorm(cfg.d_model, dtype, device)
        self.mixer = GQA(cfg, dtype, device)
        if self.ffn_kind != "none":
            self.norm2 = RMSNorm(cfg.d_model, dtype, device)
            self.ffn = MLP(self.ffn_kind, cfg.d_model, cfg.d_ff, dtype, device)


class Model(nn.Module):
    """Parameters named as the reference's tree: ``embed.table``,
    ``blocks.<layer>.{norm1,mixer,norm2,ffn}.*``, ``final_norm.scale`` and,
    without tied embeddings, ``head.w``."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        dtype = torch_dtype(cfg.dtype)
        self.embed = Embedding(cfg.vocab, cfg.d_model, dtype, device)
        self.blocks = nn.ModuleList(
            Block(kinds, cfg, dtype, device) for kinds in cfg.layer_pattern
        )
        self.final_norm = RMSNorm(cfg.d_model, dtype, device)
        if not cfg.tie_embeddings:
            self.head = Head(cfg.d_model, cfg.vocab, dtype, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for mod in self.modules():
            if mod is not self and hasattr(mod, "reset_parameters"):
                mod.reset_parameters(gen)


def init_params(seed: int, cfg: ModelConfig, device="cuda") -> Model:
    """A model with random weights from ``torch.Generator(device).manual_seed(seed)``."""
    dev = resolve_device(device)
    model = Model(cfg, dev)
    model.reset_parameters(torch.Generator(dev).manual_seed(seed))
    return model.eval()


def count_params(cfg: ModelConfig) -> int:
    """Exact parameter count, from the model built on the ``meta`` device."""
    return sum(p.numel() for p in Model(cfg, "meta").parameters())


# --------------------------------------------------------------------------- #
# Forward
# --------------------------------------------------------------------------- #


def _apply_block(block: Block, x, cfg, positions, cache, causal, decode_len):
    h = block.norm1(x, cfg.norm_eps)
    y, new_cache = gqa_apply(block.mixer, h, cfg, positions, cache, causal, decode_len)
    x = x + y
    if block.ffn_kind != "none":
        x = x + block.ffn(block.norm2(x, cfg.norm_eps))
    return x, new_cache


@torch.no_grad()
def forward(
    params: Model,
    cfg: ModelConfig,
    tokens=None,  # [B, S] int (None for pure-embedding frontends)
    embeddings=None,  # [B, S_e, D] precomputed frontend embeddings
    positions=None,
    cache=None,  # one dict per layer (init_cache)
):
    """Returns (logits [B, S_total, V], new_cache)."""
    causal = not cfg.encoder_only
    parts = []
    if embeddings is not None:
        parts.append(embeddings)
    if tokens is not None:
        parts.append(embed(params.embed.table, tokens))
    x = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    decode_len = None
    if cache is not None and s == 1 and cfg.attn_window == 0:
        # one [B] length tensor per decode step, shared by every layer
        decode_len = decode_lengths(positions, cache[0]["len"], causal)
    new_cache = []
    for i, block in enumerate(params.blocks):
        c = None if cache is None else cache[i]
        x, nc = _apply_block(block, x, cfg, positions, c, causal, decode_len)
        new_cache.append(nc)
    x = params.final_norm(x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = unembed(params.embed.table, x)
    else:
        logits = head(params.head.w, x)
    return logits, (None if cache is None else new_cache)


# --------------------------------------------------------------------------- #
# KV cache and serve steps
# --------------------------------------------------------------------------- #


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda") -> list[dict]:
    dev = resolve_device(device)
    for kinds in cfg.layer_pattern:
        _check_kinds(kinds)
    dtype = torch_dtype(cfg.dtype)
    return [gqa_cache_init(cfg, batch, max_len, dtype, dev) for _ in range(cfg.n_layers)]


def prefill(params: Model, cfg: ModelConfig, tokens, cache, embeddings=None, start=0):
    """Run the prompt (optional frontend prefix + tokens) through the model.

    ``start``: absolute position of the first token (continuation prefill
    against a cache that already holds ``start`` tokens, e.g. prefix-DAG
    tails).  Returns (last logits [B, V], cache)."""
    b = tokens.shape[0]
    s = tokens.shape[1] + (embeddings.shape[1] if embeddings is not None else 0)
    positions = start + torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
    logits, cache = forward(params, cfg, tokens=tokens, embeddings=embeddings,
                            positions=positions, cache=cache)
    return logits[:, -1, :], cache


def decode_step(params: Model, cfg: ModelConfig, token, cache, step_position):
    """One token per sequence against the cache. token: [B, 1]."""
    positions = torch.full(token.shape, int(step_position), dtype=torch.int32,
                           device=token.device)
    logits, cache = forward(params, cfg, tokens=token, positions=positions, cache=cache)
    return logits[:, -1, :], cache
