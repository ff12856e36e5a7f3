"""Nemotron-4 340B — dense GQA with squared-ReLU MLP. [arXiv:2402.16819]

96L, d_model=18432, 96 heads (GQA kv=8), d_ff=73728, vocab=256000.
Full remat + Adafactor are forced by the memory budget (16GB/chip v5e).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab=256000,
    rope_theta=10000.0,
    mixer="gqa",
    ffn="relu2",
    scan_period=1,
    remat_policy="full",
)
