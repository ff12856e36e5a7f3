"""Architecture registry: --arch <id> -> ModelConfig + shape cells + specs.

Each assigned architecture contributes:
  * ``CONFIGS[arch]``     the exact published configuration (one data
    module each, copied from the reference);
  * ``SHAPES``            the four assigned input-shape cells with
    applicability flags (long_500k only for sub-quadratic families, no
    decode for encoder-only models);
  * ``input_specs(arch, shape)``  ``meta`` tensors standing in for every
    input of the traced step (the reference's ``ShapeDtypeStruct``s: the
    same shapes and dtypes, never allocated).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_cache

# one module per assigned architecture (kept separate for --arch ergonomics)
from . import (  # noqa: E402
    deepseek_v2_lite_16b,
    hubert_xlarge,
    jamba_1_5_large_398b,
    llama4_maverick_400b_a17b,
    nemotron_4_340b,
    phi4_mini_3_8b,
    pixtral_12b,
    rwkv6_1_6b,
    smollm_135m,
    yi_34b,
)

CONFIGS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        rwkv6_1_6b,
        phi4_mini_3_8b,
        yi_34b,
        nemotron_4_340b,
        smollm_135m,
        jamba_1_5_large_398b,
        hubert_xlarge,
        llama4_maverick_400b_a17b,
        deepseek_v2_lite_16b,
        pixtral_12b,
    )
}


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}

# image/audio frontends: stub prefix length (precomputed embeddings)
FRONTEND_PREFIX = 256


def cell_applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """(runnable?, reason-if-skipped) for an (arch, shape) cell."""
    cell = SHAPES[shape]
    if cfg.encoder_only and cell.kind == "decode":
        return False, "encoder-only architecture has no decode step"
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention architecture; 500k decode needs sub-quadratic mixer"
    return True, ""


def get_config(arch: str) -> ModelConfig:
    if arch not in CONFIGS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(CONFIGS)}")
    return CONFIGS[arch]


def input_specs(arch: str, shape: str) -> dict:
    """``meta`` tensor stand-ins for the step function of an (arch, shape)."""
    return input_specs_for(get_config(arch), shape)


def input_specs_for(cfg: ModelConfig, shape: str) -> dict:
    """input_specs against an explicit config (dry-run accounting clones).

    The reference's shapes and dtypes.  Caches are the port's
    ``init_cache`` on the ``meta`` device, one dict per layer.  A decode
    cell's ``step_position`` and every cache ``"len"`` are host ints,
    ``seq_len - 1``: the cache is full, so the step attends over all of T,
    as the reference's traced int32 scalar made it do (it could not know
    the length, so it read the whole cache).
    """
    cell = SHAPES[shape]
    ok, reason = cell_applicable(cfg, shape)
    if not ok:
        raise ValueError(f"{cfg.name} × {shape} skipped: {reason}")
    b, s = cell.global_batch, cell.seq_len
    f_act = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32

    def tok(bb, ss):
        return torch.empty((bb, ss), dtype=torch.int32, device="meta")

    def emb(bb, ss):
        return torch.empty((bb, ss, cfg.d_model), dtype=f_act, device="meta")

    if cell.kind == "train":
        if cfg.encoder_only:
            # frame-classification objective over precomputed frontend frames
            batch = {"embeddings": emb(b, s), "labels": tok(b, s)}
        elif cfg.frontend != "none":
            # modality prefix (stub embeddings) + text tokens
            batch = {"embeddings": emb(b, FRONTEND_PREFIX), "tokens": tok(b, s - FRONTEND_PREFIX)}
        else:
            batch = {"tokens": tok(b, s)}
        return {"batch": batch}

    if cell.kind == "prefill":
        if cfg.encoder_only:
            # encoder "prefill" = one full forward over embeddings
            return {"embeddings": emb(b, s)}
        cache = init_cache(cfg, b, s, device="meta")
        if cfg.frontend != "none":
            return {"tokens": tok(b, s - FRONTEND_PREFIX),
                    "embeddings": emb(b, FRONTEND_PREFIX), "cache": cache}
        return {"tokens": tok(b, s), "cache": cache}

    # decode: one new token against a full cache of seq_len
    cache = init_cache(cfg, b, s, device="meta")
    for layer in cache:
        if "len" in layer:
            layer["len"] = s - 1
    return {"token": tok(b, 1), "cache": cache, "step_position": s - 1}


def all_cells():
    """Every (arch, shape) pair with its applicability verdict."""
    out = []
    for arch, cfg in CONFIGS.items():
        for shape in SHAPES:
            ok, reason = cell_applicable(cfg, shape)
            out.append((arch, shape, ok, reason))
    return out
