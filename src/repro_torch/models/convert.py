"""Load the reference's parameter tree into the port's model.

``params_from_numpy`` takes the tree that ``repro.models.init_params``
returns, as numpy arrays (any leaf ``np.asarray`` accepts), and fills a
port ``Model``: the reference stacks each scan-unit position's parameters
along a leading ``[num_scan_steps]`` axis, so layer ``step * scan_period +
u`` is ``blocks[u][...][step]``.  Every leaf goes through float32 to the
model's dtype, which is exact for bfloat16 leaves.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.api import resolve_device

from .config import ModelConfig
from .model import Model


def _flatten(node: dict, prefix: str, out: dict) -> dict:
    for name, sub in node.items():
        if isinstance(sub, dict):
            _flatten(sub, f"{prefix}{name}.", out)
        else:
            out[prefix + name] = sub
    return out


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") -> Model:
    dev = resolve_device(device)
    leaves = _flatten({n: t for n, t in tree.items() if n != "blocks"}, "", {})
    for u, stack in enumerate(tree["blocks"]):
        for name, arr in _flatten(stack, "", {}).items():
            for step in range(cfg.num_scan_steps):
                leaves[f"blocks.{step * cfg.scan_period + u}.{name}"] = arr[step]
    model = Model(cfg, dev)
    state = {}
    for name, p in model.named_parameters():
        if name not in leaves:
            raise ValueError(f"the reference tree has no leaf for {name}")
        state[name] = torch.from_numpy(np.asarray(leaves.pop(name), np.float32)).to(p.dtype)
    if leaves:
        raise ValueError(f"leaves the port's model does not have: {sorted(leaves)}")
    model.load_state_dict(state)
    return model.eval()
