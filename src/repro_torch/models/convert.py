"""Carry weights and train states between the reference's layout and the port's.

The reference stacks each scan-unit position's parameters along a leading
``[num_scan_steps]`` axis, so layer ``step * scan_period + u`` is
``blocks[u][...][step]``; the port keeps one tensor per layer
(``blocks.<layer>.<name>``).  ``reference_groups`` names that mapping once:
each of the reference's parameter leaves, by its path, as the port
parameter(s) it holds.

``params_from_numpy`` takes the tree that ``repro.models.init_params``
returns, as numpy arrays (any leaf ``np.asarray`` accepts), and fills a port
``Model``.  ``state_from_numpy`` does the same for a whole train state
(``{"params", "opt", "step"}``: AdamW's ``m``/``v``/``count`` or
Adafactor's ``stats``/``count``), and ``state_to_numpy`` is its inverse,
giving the reference's tree (float32 arrays for bfloat16 tensors).  Every
leaf goes through float32 to the model's dtype, which is exact for bfloat16
leaves.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.api import resolve_device
from repro_torch.dist import local
from repro_torch.tree import flatten_with_names, tree_map, unflatten_names

from .config import ModelConfig
from .model import Model


def reference_groups(model: Model) -> dict[str, str | list[str]]:
    """The reference's parameter leaves, by path (``embed/table``,
    ``blocks/<u>/mixer/wq``), each as the port's parameter name (an
    unstacked leaf) or as the list of per-layer names it stacks, in scan
    step order."""
    cfg = model.cfg
    groups: dict[str, str | list[str]] = {}
    for name, _p in model.named_parameters():
        if name.startswith("blocks."):
            _, layer, rest = name.split(".", 2)
            step, u = divmod(int(layer), cfg.scan_period)
            key = f"blocks/{u}/" + rest.replace(".", "/")
            groups.setdefault(key, [""] * cfg.num_scan_steps)[step] = name
        else:
            groups[name.replace(".", "/")] = name
    return groups


def per_layer_stat(stat: str, layer_ndim: int) -> bool:
    """Whether Adafactor keeps ``stat`` of a stacked group per layer (a list
    that :func:`reference_tree` stacks): all but the columns of a stack of
    vectors (the mean over its layers, one tensor)."""
    return not (stat == "vc" and layer_ndim == 1)


def _flat(tree) -> dict:
    return dict(flatten_with_names(tree))


def _tensor(arr, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, np.float32)).to(device=device, dtype=dtype)


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") -> Model:
    dev = resolve_device(device)
    model = Model(cfg, dev)
    flat = _flat(tree)
    state = {}
    for key, names in reference_groups(model).items():
        if key not in flat:
            raise ValueError(f"the reference tree has no leaf for {key}")
        arr = np.asarray(flat.pop(key))
        for i, name in enumerate([names] if isinstance(names, str) else names):
            p = model.get_parameter(name)
            state[name] = _tensor(arr if isinstance(names, str) else arr[i], p.dtype, "cpu")
    if flat:
        raise ValueError(f"leaves the port's model does not have: {sorted(flat)}")
    model.load_state_dict(state)
    return model.eval()


def per_param_from_numpy(tree: dict, model: Model, device="cuda") -> dict[str, torch.Tensor]:
    """Float32 tensors, one per port parameter name, from a tree shaped as
    the reference's parameters (AdamW's ``m`` or ``v``, a gradient)."""
    flat = _flat(tree)
    out = {}
    for key, names in reference_groups(model).items():
        arr = np.asarray(flat[key])
        if isinstance(names, str):
            out[names] = _tensor(arr, torch.float32, device)
        else:
            for i, name in enumerate(names):
                out[name] = _tensor(arr[i], torch.float32, device)
    return out


def _int32(x, device) -> torch.Tensor:
    return torch.tensor(int(np.asarray(x)), dtype=torch.int32, device=device)


def state_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") -> dict:
    """The reference's whole train state (numpy leaves, leading scan axis)
    as the port's: ``{"params": Model, "opt", "step"}``."""
    dev = resolve_device(device)
    model = params_from_numpy(tree["params"], cfg, dev)
    opt = tree["opt"]
    if "m" in opt:
        new_opt = {"m": per_param_from_numpy(opt["m"], model, dev),
                   "v": per_param_from_numpy(opt["v"], model, dev)}
    else:
        flat = _flat(opt)
        new_opt = {"stats": {}}
        for key, names in reference_groups(model).items():
            ndim = model.get_parameter(names if isinstance(names, str) else names[0]).ndim
            stats = new_opt["stats"][key] = {}
            for s in ("vr", "vc") if f"stats/{key}/vr" in flat else ("v",):
                arr = np.asarray(flat[f"stats/{key}/{s}"])
                stats[s] = ([_tensor(a, torch.float32, dev) for a in arr]
                            if not isinstance(names, str) and per_layer_stat(s, ndim)
                            else _tensor(arr, torch.float32, dev))
    new_opt["count"] = _int32(opt["count"], dev)
    return {"params": model, "opt": new_opt, "step": _int32(tree["step"], dev)}


def _host(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor on the host (a DTensor gathered first, by
    ``dist.local.full``: gloo cannot all-gather CUDA tensors through
    DTensor)."""
    return local.full(t).detach().cpu()


def reference_tree(state: dict) -> dict:
    """The port's train state in the reference's layout, as CPU tensors of
    the state's dtypes (blocks stacked on the scan axis).  DTensors are
    gathered, which every rank of their mesh must do together."""
    model = state["params"]
    groups = reference_groups(model)

    def stacked(leaves: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        return {key: _host(leaves[names]) if isinstance(names, str)
                else torch.stack([_host(leaves[n]) for n in names])
                for key, names in groups.items()}

    params = dict(model.named_parameters())
    opt = state["opt"]
    flat = {f"params/{k}": v for k, v in stacked(params).items()}
    if "m" in opt:
        for part in ("m", "v"):
            flat.update({f"opt/{part}/{k}": v for k, v in stacked(opt[part]).items()})
    else:
        for key, stats in opt["stats"].items():  # a layer's own stats stacked
            flat.update({f"opt/stats/{key}/{s}": torch.stack([_host(x) for x in t])
                         if isinstance(t, list) else _host(t) for s, t in stats.items()})
    flat["opt/count"] = _host(opt["count"])
    flat["step"] = _host(state["step"])
    return unflatten_names(flat)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as numpy; bfloat16 (which numpy lacks) as float32."""
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def state_to_numpy(state: dict) -> dict:
    """``state_from_numpy``'s inverse: the reference's tree of numpy arrays."""
    return tree_map(to_numpy, reference_tree(state))
