"""Llama-4 Maverick 400B (17B active) — top-1 MoE with shared expert.

[hf:meta-llama/Llama-4 family] 48L, d_model=5120, 40 heads (GQA kv=8),
d_ff=8192 (expert), vocab=202048, 128 routed experts top-1 + 1 shared,
MoE on every other layer (interleave step 2).
"""
from repro_torch.models.config import ModelConfig, MoEConfig

_PERIOD = (("gqa", "swiglu"), ("gqa", "moe"))

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,  # dense-layer FFN; experts use d_ff_expert=8192
    vocab=202048,
    rope_theta=500000.0,
    layer_pattern=_PERIOD * 24,
    scan_period=2,
    moe=MoEConfig(num_experts=128, top_k=1, d_ff_expert=8192, num_shared=1),
    remat_policy="full",
)
