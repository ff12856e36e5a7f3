"""Optimizers written out (no ``torch.optim``): AdamW and Adafactor.

The reference's ``repro.train.optimizer`` on the port's parameters.  Both
keep float32 state, compute in float32 and cast the new parameter to its
own dtype (``torch.optim.AdamW`` would keep bfloat16 moments for bfloat16
parameters).  The parameters are updated in place, where the reference's
jitted step donates its state.

``params`` is a ``Model`` (its named parameters) or a flat dict of tensors;
``grads`` a dict with the same names.  The state's leaves are keyed by
those names, so ``dist.sharding.param_specs`` places them as it places the
parameters, as the reference shards its optimizer state like its params.

Adafactor's statistics depend on how leaves are grouped: it factors every
leaf of rank 2 or more and clips each leaf's update by its RMS.  The
reference stacks each scan-unit position's layers on a leading axis, so a
layer's ``[D]`` norm scale is one row of a ``[L, D]`` leaf there, factored,
and every update RMS is taken over all layers of the leaf.  The port's
Adafactor runs on those same stacked groups (``convert.reference_groups``):
its stats are the reference's, keyed by the reference's leaf paths
(``blocks/<u>/mixer/wq``).  AdamW is elementwise, so its moments are kept
per parameter.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.tree import tree_leaves, tree_map


def _leaves(params) -> dict[str, torch.Tensor]:
    return dict(params.named_parameters()) if isinstance(params, nn.Module) else params


def _device(leaves: dict[str, torch.Tensor]) -> torch.device:
    return next(iter(leaves.values())).device


def global_norm(tree) -> torch.Tensor:
    leaves = [x.float().square().sum() for x in tree_leaves(tree)]
    return torch.stack(leaves).sum().sqrt()


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


# --------------------------------------------------------------------------- #
# AdamW
# --------------------------------------------------------------------------- #


def adamw_init(params) -> dict:
    leaves = _leaves(params)

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {
        "m": {n: zeros(p) for n, p in leaves.items()},
        "v": {n: zeros(p) for n, p in leaves.items()},
        "count": torch.zeros((), dtype=torch.int32, device=_device(leaves)),
    }


@torch.no_grad()
def adamw_update(
    params,
    grads,
    state: dict,
    lr: float | torch.Tensor = 1e-3,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
):
    """One step; ``params`` and the state's tensors change in place.
    Returns (params, state), as the reference returns its new ones."""
    count = state["count"] + 1
    c1 = 1.0 - b1 ** count.float()
    c2 = 1.0 - b2 ** count.float()
    for name, p in _leaves(params).items():
        g32 = grads[name].float()
        m, v = state["m"][name], state["v"][name]
        m.copy_(b1 * m + (1 - b1) * g32)
        v.copy_(b2 * v + (1 - b2) * g32.square())
        step = (m / c1) / ((v / c2).sqrt() + eps)
        p32 = p.float()
        p.copy_(p32 - lr * (step + weight_decay * p32))
    state["count"] = count
    return params, state


# --------------------------------------------------------------------------- #
# Adafactor (factored second moments; memory ~ params/row+col)
# --------------------------------------------------------------------------- #


def _groups(params) -> dict[str, str | list[str]]:
    """The optimizer's leaves: the reference's stacked groups for a model
    (``convert.reference_groups``), else every tensor its own leaf."""
    if isinstance(params, nn.Module):
        from repro_torch.models.convert import reference_groups

        return reference_groups(params)
    return {n: n for n in params}


def _group(leaves: dict, names: str | list[str]) -> torch.Tensor:
    if isinstance(names, str):
        return leaves[names]
    return torch.stack([leaves[n] for n in names])


def adafactor_init(params) -> dict:
    leaves = _leaves(params)

    def stats(shape, device):
        if len(shape) >= 2:
            return {
                "vr": torch.zeros(shape[:-1], dtype=torch.float32, device=device),  # rows
                "vc": torch.zeros(shape[:-2] + shape[-1:], dtype=torch.float32,
                                  device=device),
            }
        return {"v": torch.zeros(shape, dtype=torch.float32, device=device)}

    out = {}
    for key, names in _groups(params).items():
        first = leaves[names if isinstance(names, str) else names[0]]
        shape = tuple(first.shape) if isinstance(names, str) else (len(names), *first.shape)
        out[key] = stats(shape, first.device)
    return {"stats": out, "count": torch.zeros((), dtype=torch.int32, device=_device(leaves))}


@torch.no_grad()
def adafactor_update(
    params,
    grads,
    state: dict,
    lr: float | torch.Tensor = 1e-2,
    decay: float = 0.8,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    weight_decay: float = 0.0,
):
    """One step over the reference's leaves; ``params`` and the stats change
    in place.  Returns (params, state)."""
    count = state["count"] + 1
    beta = 1.0 - count.float() ** (-decay)
    leaves = _leaves(params)
    for key, names in _groups(params).items():
        p, g = _group(leaves, names), _group(grads, names).float()
        s = state["stats"][key]
        g2 = g.square() + eps
        if p.ndim >= 2:
            s["vr"].copy_(beta * s["vr"] + (1 - beta) * g2.mean(dim=-1))
            s["vc"].copy_(beta * s["vc"] + (1 - beta) * g2.mean(dim=-2))
            denom = torch.clamp(s["vr"].mean(dim=-1, keepdim=True), min=eps)
            precond = s["vr"][..., None] / denom[..., None] * s["vc"][..., None, :]
            update = g * torch.rsqrt(precond + eps)
        else:
            s["v"].copy_(beta * s["v"] + (1 - beta) * g2)
            update = g * torch.rsqrt(s["v"] + eps)
        # update clipping (RMS <= clip_threshold), over the whole leaf
        rms = (update.square().mean() + eps).sqrt()
        update = update / torch.clamp(rms / clip_threshold, min=1.0)
        p32 = p.float()
        new_p = p32 - lr * (update + weight_decay * p32)
        if isinstance(names, str):
            leaves[names].copy_(new_p)
        else:
            for i, n in enumerate(names):
                leaves[n].copy_(new_p[i])
    state["count"] = count
    return params, state


# --------------------------------------------------------------------------- #
# Schedules
# --------------------------------------------------------------------------- #


def cosine_schedule(step, base_lr: float, warmup: int, total: int, min_frac: float = 0.1):
    step = step.float() if isinstance(step, torch.Tensor) else torch.tensor(float(step))
    warm = base_lr * step / max(1.0, warmup)
    progress = torch.clamp((step - warmup) / max(1.0, total - warmup), 0.0, 1.0)
    cos = base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * progress)))
    return torch.where(step < warmup, warm, cos)


OPTIMIZERS = {
    "adamw": (adamw_init, adamw_update),
    "adafactor": (adafactor_init, adafactor_update),
}


def pick_optimizer(cfg) -> str:
    """Adafactor for >=100B-param configs, else AdamW."""
    return "adafactor" if cfg.param_count() >= 100e9 else "adamw"
