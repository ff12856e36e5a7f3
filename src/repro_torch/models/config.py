"""Model configuration: one dataclass describes every assigned architecture.

A copy of the reference's ``ModelConfig`` and its three sub-configs, field
for field, so both packages read the same ``configs/*.py`` data.

A model is a sequence of *blocks*; ``layer_pattern`` (one entry per layer)
selects each block's mixer ("gqa" | "mla" | "mamba" | "rwkv6") and its FFN
("swiglu" | "relu2" | "moe" | "rwkv6_cm" | "none").  The reference stacks
``scan_period`` layers into one ``lax.scan`` unit; the port walks its layers
in a Python loop, so here ``scan_period`` only checks that the pattern tiles.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Literal

Mixer = Literal["gqa", "mla", "mamba", "rwkv6"]
FFN = Literal["swiglu", "relu2", "moe", "rwkv6_cm", "none"]


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    d_ff_expert: int = 1024
    num_shared: int = 0  # always-on experts (DeepSeek style)
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    q_lora_rank: int = 0  # 0 = full-rank q projection


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 = ceil(d_model / 16)
    time_chunk: int = 0  # >0: remat the recurrence in time chunks (bwd memory)


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0  # 0 = d_model // n_heads
    d_ff: int = 1024
    vocab: int = 1024
    max_seq: int = 8192
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    mixer: Mixer = "gqa"  # default mixer for uniform models
    ffn: FFN = "swiglu"  # default ffn for uniform models
    layer_pattern: tuple[tuple[str, str], ...] = ()  # overrides mixer/ffn
    scan_period: int = 1
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    encoder_only: bool = False  # no causal mask, no decode step
    frontend: str = "none"  # none | audio | vision (stub embeddings)
    tie_embeddings: bool = False
    attn_window: int = 0  # 0 = full attention; >0 = sliding window
    attn_q_chunk: int = 0  # >0: query-chunked attention (peak act-mem / n_chunks)
    sub_quadratic: bool = False  # True: long_500k decode shape is runnable
    remat_policy: str = "none"  # none | dots | full
    dtype: str = "bfloat16"
    scan_unroll: int = 1  # lax.scan unroll factor (dry-run accounting clones
    #                       set it to num_scan_steps so HLO cost analysis —
    #                       which counts while bodies once — becomes exact)

    # ------------------------------------------------------------------ #
    def __post_init__(self):
        if not self.layer_pattern:
            pat = tuple((self.mixer, self.ffn) for _ in range(self.n_layers))
            object.__setattr__(self, "layer_pattern", pat)
        if len(self.layer_pattern) != self.n_layers:
            raise ValueError("layer_pattern length != n_layers")
        if self.n_layers % self.scan_period:
            raise ValueError("n_layers must be divisible by scan_period")
        # every scan unit must repeat the same pattern
        unit = self.layer_pattern[: self.scan_period]
        for i in range(0, self.n_layers, self.scan_period):
            if self.layer_pattern[i : i + self.scan_period] != unit:
                raise ValueError("layer_pattern must tile with scan_period")
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def scan_unit(self) -> tuple[tuple[str, str], ...]:
        return self.layer_pattern[: self.scan_period]

    @property
    def num_scan_steps(self) -> int:
        return self.n_layers // self.scan_period

    def reduced(self, **overrides) -> ModelConfig:
        """A smoke-test-sized sibling config (same family/pattern shape)."""
        scale = dict(
            n_layers=max(2, self.scan_period * 2)
            if self.scan_period > 1
            else min(self.n_layers, 2),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            head_dim=32,
            d_ff=256,
            vocab=512,
            max_seq=256,
            scan_period=self.scan_period,
            layer_pattern=(),
            remat_policy="none",
        )
        if self.moe is not None:
            scale["moe"] = MoEConfig(
                num_experts=4,
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=128,
                num_shared=min(self.moe.num_shared, 1),
            )
        if self.mla is not None:
            scale["mla"] = MLAConfig(
                kv_lora_rank=64, qk_nope_head_dim=32, qk_rope_head_dim=16,
                v_head_dim=32, q_lora_rank=0,
            )
        if self.ssm is not None:
            scale["ssm"] = SSMConfig(d_state=8, d_conv=4, expand=2)
        scale.update(overrides)
        new = dataclasses.replace(self, **scale)
        return new

    def param_count(self) -> int:
        """Exact parameter count of the port's model, built on the ``meta``
        device (no allocation); drives MODEL_FLOPS in the roofline."""
        from repro_torch.models.model import count_params_analytic

        return count_params_analytic(self)

    def active_param_count(self) -> int:
        from repro_torch.models.model import count_params_analytic

        return count_params_analytic(self, active_only=True)
