"""Pixtral-12B — VLM: pixtral-ViT frontend + mistral-nemo-style decoder.

[hf:mistralai/Pixtral-12B-2409] 40L, d_model=5120, 32 heads (GQA kv=8),
d_ff=14336, vocab=131072.  The ViT frontend is a stub: ``input_specs``
supplies precomputed patch embeddings as a 256-position prefix.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=160,
    d_ff=14336,
    vocab=131072,
    rope_theta=1000000000.0,
    mixer="gqa",
    ffn="swiglu",
    frontend="vision",
    scan_period=1,
    remat_policy="dots",
)
