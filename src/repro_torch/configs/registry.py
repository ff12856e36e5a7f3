"""Architecture registry: --arch <id> -> ModelConfig + shape cells.

Each assigned architecture contributes ``CONFIGS[arch]``, its exact
published configuration (one data module each, copied from the reference),
and the four assigned input-shape cells of ``SHAPES`` with their
applicability rules (long_500k only for sub-quadratic families, no decode
for encoder-only models).  The reference's ``input_specs`` stand-ins come
with the port of the dry-run launcher.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.models.config import ModelConfig

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


def all_cells():
    """Every (arch, shape) pair with its applicability verdict."""
    out = []
    for arch, cfg in CONFIGS.items():
        for shape in SHAPES:
            ok, reason = cell_applicable(cfg, shape)
            out.append((arch, shape, ok, reason))
    return out
