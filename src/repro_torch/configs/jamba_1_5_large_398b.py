"""Jamba-1.5-Large 398B — hybrid Mamba+attention MoE. [arXiv:2403.19887; hf]

72L, d_model=8192, 64 heads (GQA kv=8), d_ff=24576, vocab=65536.
Jamba period = 8 layers: attention at position 4 (1:7 attn:mamba interleave),
MoE (16 experts, top-2) on every other layer, dense SwiGLU elsewhere.
Sub-quadratic (Mamba recurrence dominates) -> long_500k decode is runnable.
"""
from repro_torch.models.config import ModelConfig, MoEConfig, SSMConfig

_PERIOD = tuple(
    (
        "gqa" if i == 4 else "mamba",
        "moe" if i % 2 == 1 else "swiglu",
    )
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab=65536,
    layer_pattern=_PERIOD * 9,
    scan_period=8,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=24576),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    sub_quadratic=True,
    remat_policy="full",
)
