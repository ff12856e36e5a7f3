"""Atomic, restart-safe checkpoints in the reference's format.

Layout (``repro.train.checkpoint``'s, byte for byte in its structure):
         <dir>/step_<N>/
           manifest.json       leaf names, shapes, logical dtypes, the
                               device count at save time, ``extra``
           shard_<host>.npz    flat leaf arrays (``leaf_<i>``)
         <dir>/step_<N>.done   commit marker (atomic rename)

Leaves carry the reference's names and shapes: a train state (a ``Model``
under ``"params"``) is written in the reference's layout, blocks stacked on
the scan axis (``models.convert.reference_tree``), so either package
restores the other's checkpoint; any other tree of tensors is written as it
is, under ``jax.tree_util``'s paths.  bfloat16 is stored as float32 (npz
has no bfloat16) with its logical dtype in the manifest.

Fault-tolerance contract, as the reference's:
  * a checkpoint is valid iff its .done marker exists (partial writes from a
    crashed host are never picked up);
  * ``latest_step`` scans markers only, so restart after any failure resumes
    from the last committed step;
  * restore places the state where the caller says: on ``device``, or on
    the current mesh by DTensor placements (elastic: the mesh at restore
    time may differ from the one at save time).

A state on a mesh is gathered on every rank (a collective); rank 0 of the
process group writes it, and every rank waits for the commit.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from repro_torch.api import resolve_device
from repro_torch.models.convert import reference_tree, state_from_numpy, to_numpy
from repro_torch.tree import flatten_with_names, tree_map, tree_map_with_names, unflatten_names


def _is_lm_state(state) -> bool:
    return isinstance(state, dict) and isinstance(state.get("params"), nn.Module)


def _host_tree(state):
    """``state`` as a tree of CPU tensors in the reference's layout."""
    if _is_lm_state(state):
        return reference_tree(state)
    return tree_map(lambda t: torch.as_tensor(t).detach().cpu(), state)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _ranks() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def save_checkpoint(
    directory: str,
    step: int,
    state,
    extra: dict[str, Any] | None = None,
    host_id: int = 0,
) -> str:
    """Write one atomic checkpoint; returns the committed path."""
    leaves = flatten_with_names(_host_tree(state))
    ckpt_dir = os.path.join(directory, f"step_{step:08d}")
    rank, world = _ranks()
    if rank == 0:
        tmp_dir = ckpt_dir + f".tmp{host_id}"
        os.makedirs(tmp_dir, exist_ok=True)
        arrays = {}
        meta = []
        for name, leaf in leaves:
            key = f"leaf_{len(meta)}"
            arrays[key] = to_numpy(leaf)
            meta.append({"name": name, "key": key, "shape": list(leaf.shape),
                         "dtype": _dtype_name(leaf)})
        np.savez(os.path.join(tmp_dir, f"shard_{host_id}.npz"), **arrays)
        manifest = {"step": step, "leaves": meta, "num_devices": world,
                    "extra": extra or {}}
        with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
            json.dump(manifest, f)

        # atomic commit: rename dir, then touch the .done marker
        if os.path.exists(ckpt_dir):
            shutil.rmtree(ckpt_dir)
        os.rename(tmp_dir, ckpt_dir)
        done = ckpt_dir + ".done"
        with open(done + ".tmp", "w") as f:
            f.write(str(step))
        os.rename(done + ".tmp", done)
    if world > 1:
        dist.barrier()
    return ckpt_dir


def latest_step(directory: str) -> int | None:
    """Largest committed step (None if no valid checkpoint exists)."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for entry in os.listdir(directory):
        if entry.startswith("step_") and entry.endswith(".done"):
            steps.append(int(entry[len("step_"): -len(".done")]))
    return max(steps) if steps else None


def restore_checkpoint(
    directory: str,
    like,
    step: int | None = None,
    shardings=None,
    host_id: int = 0,
    *,
    device=None,
    mesh=None,
):
    """Restore into the structure of ``like``; returns (state, extra).

    A train state comes back as a new ``{"params": Model, "opt", "step"}``
    of ``like``'s config and optimizer; any other tree with ``like``'s
    containers and dtypes.  It is placed on ``device`` (default: where
    ``like``'s first tensor lies), or, with ``shardings`` (``like``'s
    placements from ``dist.sharding``'s ``*_specs``) and ``mesh``, on the
    current mesh (``dist.sharding.to_named``; every rank of it restores).
    """
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint under {directory}")
    ckpt_dir = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(ckpt_dir, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(ckpt_dir, f"shard_{host_id}.npz")) as shard:
        by_name = {m["name"]: shard[m["key"]] for m in manifest["leaves"]}

    if _is_lm_state(like):
        model = like["params"]
        dev = resolve_device(device) if device is not None else model.embed.table.device
        # the checkpoint's own paths give the reference's tree
        state = state_from_numpy(unflatten_names(by_name), model.cfg,
                                 "cpu" if shardings is not None else dev)
    else:
        first = next((t for _n, t in flatten_with_names(like) if isinstance(t, torch.Tensor)),
                     None)
        dev = (resolve_device(device) if device is not None
               else first.device if first is not None else torch.device("cpu"))
        state = tree_map_with_names(lambda name, leaf: _like_tensor(by_name[name], leaf, dev),
                                    like)
    if shardings is not None:
        from repro_torch.dist.sharding import to_named

        state = to_named(state, shardings, mesh)
    return state, manifest.get("extra", {})


def _like_tensor(arr: np.ndarray, leaf, device) -> torch.Tensor:
    """``arr`` as a tensor of ``leaf``'s dtype (its own for a non-tensor)."""
    t = torch.from_numpy(np.asarray(arr))
    return t.to(device=device, dtype=leaf.dtype if isinstance(leaf, torch.Tensor) else t.dtype)
