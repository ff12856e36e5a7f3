"""SmolLM-135M — small llama-arch GQA. [hf:HuggingFaceTB/SmolLM-135M]

30L, d_model=576, 9 heads (GQA kv=3), d_ff=1536, vocab=49152, tied embeddings.
Also the scale used by the end-to-end training example.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    head_dim=64,
    d_ff=1536,
    vocab=49152,
    rope_theta=10000.0,
    mixer="gqa",
    ffn="swiglu",
    tie_embeddings=True,
    scan_period=1,
    remat_policy="none",
)
