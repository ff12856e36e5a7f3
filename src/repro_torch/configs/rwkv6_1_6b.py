"""RWKV-6 "Finch" 1.6B — attention-free, data-dependent decay.

[arXiv:2404.05892] 24L, d_model=2048, d_ff=7168, vocab=65536.
Heads follow the RWKV convention head_dim=64 -> 32 heads.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab=65536,
    mixer="rwkv6",
    ffn="rwkv6_cm",
    sub_quadratic=True,
    scan_period=1,
    remat_policy="dots",
)
