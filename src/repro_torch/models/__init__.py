from .config import MLAConfig, ModelConfig, MoEConfig, SSMConfig
from .model import Model, decode_step, forward, init_cache, init_params, lm_loss, prefill

__all__ = [
    "MLAConfig",
    "Model",
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "decode_step",
    "forward",
    "init_cache",
    "init_params",
    "lm_loss",
    "prefill",
]
