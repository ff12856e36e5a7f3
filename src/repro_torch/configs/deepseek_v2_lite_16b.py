"""DeepSeek-V2-Lite 16B — MLA + fine-grained MoE. [arXiv:2405.04434; hf]

27L, d_model=2048, 16 heads, MLA kv_lora=512 (nope 128 / rope 64 / v 128),
64 routed experts top-6 + 2 shared (expert d_ff=1408); first layer is dense
SwiGLU with d_ff=10944.  vocab=102400.

The first-layer exception breaks scan tiling, so the stack is unrolled
(scan_period = n_layers = 27): acceptable at this depth.
"""
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

_PATTERN = (("mla", "swiglu"),) + (("mla", "moe"),) * 26

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=10944,  # dense first layer; experts use d_ff_expert=1408
    vocab=102400,
    rope_theta=10000.0,
    layer_pattern=_PATTERN,
    scan_period=27,
    mla=MLAConfig(
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408, num_shared=2),
    remat_policy="dots",
)
