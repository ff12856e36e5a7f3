"""HuBERT X-Large — encoder-only audio transformer. [arXiv:2106.07447]

48L, d_model=1280, 16 heads, d_ff=5120, vocab=504 (cluster targets).
The CNN waveform frontend is a stub: ``input_specs`` supplies precomputed
frame embeddings; the backbone (the assigned part) is fully implemented.
Encoder-only => no decode shapes.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab=504,
    mixer="gqa",
    ffn="gelu",
    encoder_only=True,
    frontend="audio",
    scan_period=1,
    remat_policy="dots",
)
