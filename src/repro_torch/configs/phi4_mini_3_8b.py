"""Phi-4-mini 3.8B — dense GQA decoder. [arXiv:2412.08905; hf]

32L, d_model=3072, 24 heads (GQA kv=8), d_ff=8192, vocab=200064,
RoPE + SwiGLU.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=200064,
    rope_theta=10000.0,
    mixer="gqa",
    ffn="swiglu",
    tie_embeddings=True,  # 4.45B untied -> 3.84B tied (published 3.8B)
    scan_period=1,
    remat_policy="dots",
)
