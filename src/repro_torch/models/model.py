"""Model assembly: blocks, LM head, loss, KV cache, prefill and decode steps.

An ``nn.Module`` model: ``Model.blocks`` is a ``ModuleList`` walked by a
Python loop where the reference runs ``lax.scan`` over stacked parameters,
so each layer keeps its own parameters and cache.  The functional entry
points keep the reference's names and arguments (``init_params``,
``forward``, ``lm_loss``, ``prefill``, ``decode_step``, ``init_cache``),
with the model in place of the parameter tree.

``forward`` records gradients for the parameters that require them (the
train state turns that on); ``prefill`` and ``decode_step`` run under
``torch.no_grad``.  ``cfg.remat_policy`` maps onto activation
checkpointing of each block while gradients are recorded: ``"full"``
recomputes the whole block in the backward pass, ``"dots"`` saves the
outputs of the matrix products without batch dimensions (the projections
and MLP products, as ``dots_with_no_batch_dims_saveable`` does) and
recomputes the rest, ``"none"`` saves everything.  Without a cache
(training, an encoder's forward) the forward runs on each rank's share
with its layout written out (``_forward_local``, ``dist/local.py``; with
no active mesh, on the whole).  Against a cache (prefill, decode) it runs
on DTensors, with the reference's sharding constraints (``dist.ctx``)
where the reference puts them: the batch after the embedding and after
each block, the vocabulary on the logits, the heads on q; with no active
mesh they are the identity.

Blocks: every (mixer, FFN) pair of ``models/config.py``: the GQA, MLA,
Mamba and RWKV-6 time-mix mixers; the SwiGLU, squared-ReLU, GELU, MoE and
RWKV-6 channel-mix FFNs, or none.

The cache is a list with one dict per layer, the mixer's own: GQA
``{"k", "v": [B, T, Hk, hd], "len"}``, MLA ``{"latent", "krope", "len"}``,
Mamba ``{"h", "conv"}``, RWKV-6 ``{"s", "last"}``; a layer whose FFN
carries a cache (the RWKV-6 channel mix) holds it under ``"ffn"``.
``len`` is a host int, as the reference keeps it a scalar.  The steps
write into the cache tensors in place and return the list with the new
lengths.
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.api import resolve_device
from repro_torch.dist import ctx as shard_ctx

from . import ssm
from .attention import (
    GQA,
    MLA,
    decode_lengths,
    gqa_apply,
    gqa_cache_init,
    gqa_local,
    mla_apply,
    mla_cache_init,
    mla_local,
)
from .config import ModelConfig
from .layers import (
    MLP,
    Embedding,
    Head,
    RMSNorm,
    embed,
    head,
    mlp_local,
    rmsnorm,
    torch_dtype,
    unembed,
)
from .moe import MoE, moe_apply, moe_local

# mixer kind -> (module, apply, cache init); the cache inits of the
# attention mixers take max_len, the recurrent ones do not
_MIXERS = {
    "gqa": (GQA, gqa_apply, gqa_cache_init),
    "mla": (MLA, mla_apply, mla_cache_init),
    "mamba": (ssm.Mamba, ssm.mamba_apply, ssm.mamba_cache_init),
    "rwkv6": (ssm.RWKV6TimeMix, ssm.rwkv6_tm_apply, ssm.rwkv6_tm_cache_init),
}
_FFNS = ("swiglu", "relu2", "gelu", "moe", "rwkv6_cm", "none")
# the mixers with their cache-free layout written out (``dist/local.py``)
_LOCAL_MIXERS = {"gqa": gqa_local, "mla": mla_local}


def _check_kinds(kinds: tuple[str, str]) -> None:
    """A (mixer, ffn) pair of ``models/config.py``; raises for another."""
    if kinds[0] not in _MIXERS or kinds[1] not in _FFNS:
        raise ValueError(f"unknown block kinds {kinds}")


class Block(nn.Module):
    def __init__(self, kinds: tuple[str, str], cfg: ModelConfig, dtype, device):
        super().__init__()
        _check_kinds(kinds)
        self.mixer_kind, self.ffn_kind = kinds
        self.norm1 = RMSNorm(cfg.d_model, dtype, device)
        self.mixer = _MIXERS[self.mixer_kind][0](cfg, dtype, device)
        if self.ffn_kind != "none":
            self.norm2 = RMSNorm(cfg.d_model, dtype, device)
            if self.ffn_kind == "moe":
                self.ffn = MoE(cfg, dtype, device)
            elif self.ffn_kind == "rwkv6_cm":
                self.ffn = ssm.RWKV6ChannelMix(cfg, dtype, device)
            else:
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


def count_params_analytic(cfg: ModelConfig, active_only: bool = False) -> int:
    """Exact parameter count, from the model built on the ``meta`` device
    (no allocation).

    active_only: MoE experts counted as top_k (+shared) per layer instead of
    all experts — the N in MODEL_FLOPS = 6·N_active·D (the reference's rule).
    """
    total = sum(p.numel() for p in Model(cfg, "meta").parameters())
    if not active_only or cfg.moe is None:
        return total
    m = cfg.moe
    expert_params = 3 * cfg.d_model * m.d_ff_expert  # gate/up/down per expert
    n_moe_layers = sum(1 for _, f in cfg.layer_pattern if f == "moe")
    inactive = (m.num_experts - m.top_k) * expert_params * n_moe_layers
    return total - inactive


# --------------------------------------------------------------------------- #
# Forward
# --------------------------------------------------------------------------- #


_DENSE_FFNS = ("swiglu", "relu2", "gelu")


def _apply_block(block: Block, x, cfg, positions, cache, causal, decode_len):
    """A block against a cache (prefill, decode), on DTensors under a mesh."""
    args = (block.mixer, block.norm1(x, cfg.norm_eps), cfg, positions, cache, causal)
    if block.mixer_kind == "gqa":
        y, new_cache = gqa_apply(*args, decode_len)
    else:
        y, new_cache = _MIXERS[block.mixer_kind][1](*args)
    x = x + y
    if block.ffn_kind == "none":
        return x, new_cache
    h = block.norm2(x, cfg.norm_eps)
    if block.ffn_kind == "moe":
        y = moe_apply(block.ffn, h, cfg)
    elif block.ffn_kind == "rwkv6_cm":
        y, new_cache["ffn"] = ssm.rwkv6_cm_apply(block.ffn, h, cfg, cache["ffn"])
    else:
        y = block.ffn(h)
    return x + y, new_cache


def _normed(norm: RMSNorm, x, eps: float, lay):
    return rmsnorm(x, lay.weight(norm.scale), eps)


def _block_local(block: Block, x, cfg, positions, causal, lay):
    """A block without a cache on this rank's rows ``x`` (``lay``, a
    ``dist.local.Local``; ``positions`` [B, S] of every row): GQA, MLA, the
    MoE and the dense MLPs with their layout written out, the recurrent
    sublayers on DTensors at the reference's constraints (``lay.region``)."""
    eps = cfg.norm_eps
    if block.mixer_kind in _LOCAL_MIXERS:
        x = x + _LOCAL_MIXERS[block.mixer_kind](
            block.mixer, _normed(block.norm1, x, eps, lay), cfg, positions[lay.rows], causal, lay)
    else:
        mixer = _MIXERS[block.mixer_kind][1]
        x = x + lay.region(x, lambda xd: mixer(block.mixer, block.norm1(xd, eps), cfg,
                                               positions, None, causal)[0])
    if block.ffn_kind == "none":
        return x
    if block.ffn_kind in _DENSE_FFNS:
        return x + mlp_local(block.ffn, _normed(block.norm2, x, eps, lay), lay)
    if block.ffn_kind == "moe":
        return x + moe_local(block.ffn, _normed(block.norm2, x, eps, lay), cfg, lay)
    return x + lay.region(x, lambda xd: ssm.rwkv6_cm_apply(block.ffn, block.norm2(xd, eps),
                                                           cfg, None)[0])


def _vocab_part(lay, vocab: int):
    """(layout, first id) of this rank's part of the vocabulary: split over
    "model" where it divides the vocabulary, else whole."""
    return (lay, lay.r * (vocab // lay.m)) if vocab % lay.m == 0 else (lay.whole(), 0)


def _embed_local(table, tokens, lay):
    """The embedding of this rank's ``tokens``, vocabulary-parallel: each
    rank looks up the ids of its part, one all-reduce adds them."""
    lay, first = _vocab_part(lay, table.shape[0])
    w = lay.weight(table, 0)
    if lay.m == 1:
        return embed(w, tokens)
    ids = tokens - first
    hit = (ids >= 0) & (ids < w.shape[0])
    return lay.leave(embed(w, torch.where(hit, ids, 0)) * hit[..., None].to(w.dtype))


def _forward_local(params: Model, cfg: ModelConfig, tokens, embeddings, positions, lay):
    """The cache-free forward on this rank's share (``lay``): its rows'
    logits over its part of the vocabulary, and that part's layout."""
    causal = not cfg.encoder_only
    parts = []
    if embeddings is not None:
        parts.append(lay.local(embeddings))
    if tokens is not None:
        parts.append(_embed_local(params.embed.table, lay.local(tokens), lay))
    x = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    s = x.shape[1]
    batch = (tokens if tokens is not None else embeddings).shape[0]
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(batch, s)
    for block in params.blocks:
        block_fn = functools.partial(_block_local, block, cfg=cfg, positions=positions,
                                     causal=causal, lay=lay)
        x = _remat(block_fn, cfg.remat_policy)(x) if torch.is_grad_enabled() else block_fn(x)
    x = _normed(params.final_norm, x, cfg.norm_eps, lay)
    vlay, _ = _vocab_part(lay, cfg.vocab)
    x = vlay.enter(x)
    if cfg.tie_embeddings:
        return unembed(vlay.weight(params.embed.table, 0), x), vlay
    return head(vlay.weight(params.head.w, 1), x), vlay


_aten = torch.ops.aten


def _dots_policy(ctx, op, *args, **kwargs):
    """Save matrix products without batch dimensions (``mm``, ``addmm``, and
    ``bmm`` over a batch of one: einsum's projections); recompute the rest,
    the attention's batched products among them."""
    if op in (_aten.mm.default, _aten.addmm.default) or (
            op is _aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(block_fn, policy: str):
    if policy == "none":
        return block_fn
    if policy == "full":
        return functools.partial(checkpoint, block_fn, use_reentrant=False)
    if policy == "dots":
        return functools.partial(
            checkpoint, block_fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts, _dots_policy))
    raise ValueError(f"unknown remat_policy {policy!r}")


def forward(
    params: Model,
    cfg: ModelConfig,
    tokens=None,  # [B, S] int (None for pure-embedding frontends)
    embeddings=None,  # [B, S_e, D] precomputed frontend embeddings
    positions=None,
    cache=None,  # one dict per layer (init_cache)
):
    """Returns (logits [B, S_total, V], new_cache).  Without a cache the
    forward runs on each rank's share under a mesh (``dist/local.py``) and
    the logits come back as a DTensor, rows over the data dims and the
    vocabulary over "model"."""
    if cache is None:
        lay = shard_ctx.layout(tokens if tokens is not None else embeddings)
        logits, vlay = _forward_local(params, cfg, tokens, embeddings, positions, lay)
        return lay.dtensor(logits, 2 if vlay.m > 1 else None), None
    causal = not cfg.encoder_only
    parts = []
    if embeddings is not None:
        parts.append(embeddings)
    if tokens is not None:
        # pinned before the join: under a mesh the embedding of a
        # vocabulary-sharded table is a pending masked sum
        parts.append(shard_ctx.constrain_batch(embed(params.embed.table, tokens)))
    x = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    x = shard_ctx.constrain_batch(x)
    decode_len = None
    gqa_lens = [c["len"] for blk, c in zip(params.blocks, cache) if blk.mixer_kind == "gqa"]
    if gqa_lens and s == 1 and cfg.attn_window == 0:
        # one [B] length tensor per decode step, shared by every GQA layer
        # (the first may be a recurrent layer, which keeps no length)
        decode_len = decode_lengths(positions, gqa_lens[0], causal)
    new_cache = []
    for block, c in zip(params.blocks, cache):
        x, nc = _apply_block(block, x, cfg, positions, c, causal, decode_len)
        x = shard_ctx.constrain_batch(x)
        new_cache.append(nc)
    x = params.final_norm(x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = unembed(params.embed.table, x)
    else:
        logits = head(params.head.w, x)
    logits = shard_ctx.constrain_vocab(logits)
    return logits, new_cache


# --------------------------------------------------------------------------- #
# Loss / train objective
# --------------------------------------------------------------------------- #


def _logsumexp(x, lay):
    """``logsumexp`` over the last axis, split over "model" by ``lay``."""
    if lay.m == 1:
        return torch.logsumexp(x, dim=-1)
    top = lay.max(x.amax(dim=-1))
    return top + torch.log(lay.leave(torch.exp(x - top[..., None]).sum(dim=-1)))


def lm_loss(params: Model, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Next-token CE for decoders; per-position CE for encoder-only models.

    batch: {"tokens": [B,S]} (+ optional "embeddings", "labels", "mask").
    The float32 scalar mean over the valid positions.  Under a mesh each
    rank takes its rows and its part of the vocabulary (``dist/local.py``);
    the sums over the vocabulary cross "model", those over the rows the
    data dims, each reduced once."""
    tokens = batch.get("tokens")
    embeddings = batch.get("embeddings")
    lay = shard_ctx.layout(tokens if tokens is not None else embeddings)
    logits, vlay = _forward_local(params, cfg, tokens, embeddings, None, lay)
    valid = None
    if cfg.encoder_only:
        labels = lay.local(batch["labels"])
        pred = logits[:, -labels.shape[1]:, :]
    else:
        labels = lay.local(tokens)[:, 1:]
        pred = logits[:, :-1, :]
        if embeddings is not None:  # frontend prefix carries no LM labels
            pred = pred[:, embeddings.shape[1]:, :]
        if "mask" in batch:
            valid = lay.local(batch["mask"])[:, 1:].float()
    # The label's logit as the reference takes it, a one-hot contraction
    # (here a masked sum, exact: one term is not zero), over this rank's
    # part of the vocabulary.
    pred32 = pred.float()
    lse = _logsumexp(pred32, vlay)
    vocab_ids = vlay.r * pred.shape[-1] + torch.arange(pred.shape[-1], device=labels.device)
    label_logit = vlay.leave(torch.where(vocab_ids == labels[..., None], pred32, 0.0).sum(dim=-1))
    ll = label_logit - lse
    if valid is None:
        valid = torch.ones_like(ll)
    return -lay.rows_sum((ll * valid).sum()) / lay.rows_sum(valid.sum()).clamp(min=1.0)


# --------------------------------------------------------------------------- #
# KV cache and serve steps
# --------------------------------------------------------------------------- #


def _layer_cache(kinds, cfg: ModelConfig, batch: int, max_len: int, dtype, dev) -> dict:
    mixer_kind, ffn_kind = kinds
    init = _MIXERS[mixer_kind][2]
    if mixer_kind in ("gqa", "mla"):
        cache = init(cfg, batch, max_len, dtype, dev)
    else:
        cache = init(cfg, batch, dtype, dev)
    if ffn_kind == "rwkv6_cm":
        cache["ffn"] = ssm.rwkv6_cm_cache_init(cfg, batch, dtype, dev)
    return cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda") -> list[dict]:
    """One cache dict per layer, by the layer's kinds (module docstring)."""
    dev = resolve_device(device)
    for kinds in cfg.layer_pattern:
        _check_kinds(kinds)
    dtype = torch_dtype(cfg.dtype)
    return [_layer_cache(kinds, cfg, batch, max_len, dtype, dev) for kinds in cfg.layer_pattern]


@torch.no_grad()
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


@torch.no_grad()
def decode_step(params: Model, cfg: ModelConfig, token, cache, step_position):
    """One token per sequence against the cache. token: [B, 1]."""
    positions = torch.full(token.shape, int(step_position), dtype=torch.int32,
                           device=token.device)
    logits, cache = forward(params, cfg, tokens=token, positions=positions, cache=cache)
    return logits[:, -1, :], cache
