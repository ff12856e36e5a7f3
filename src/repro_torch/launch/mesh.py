"""Meshes of ranks: the production meshes and a mesh over the ranks at hand.

Single pod:  (16, 16)      dims ("data", "model")         — 256 ranks
Multi-pod:   (2, 16, 16)   dims ("pod", "data", "model")  — 512 ranks

``make_production_mesh`` and ``make_host_mesh`` are functions (never module
constants), so importing this module touches no device and no process
group.  The caller starts the process group itself
(``torch.distributed.init_process_group`` with its address, world size and
rank) and chooses its backend: ``"nccl"`` when every rank has a card of its
own, ``"gloo"`` when ranks share a card or run on the CPU (NCCL refuses two
ranks on one card).  The dry-run (``launch/dryrun.py``) starts torch's
``"fake"`` backend with 256 or 512 ranks, which runs no collective, and
builds the production meshes over it.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.api import resolve_device


def rank_device(device_type: str = "cuda") -> torch.device:
    """This rank's device: ``cuda:{local_rank % device_count}`` (the local
    rank is ``LOCAL_RANK`` where a launcher sets it, else the global rank),
    or the CPU when ``device_type`` is ``"cpu"``.  Raises without CUDA
    unless the CPU is asked for."""
    if resolve_device(device_type).type == "cpu":
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """The (16, 16) ("data", "model") mesh, or (2, 16, 16) ("pod", "data",
    "model") with ``multi_pod``, over the default process group, which must
    hold that many ranks.  Touches no device: the dry-run builds it over a
    fake group on a host without a card."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 512 if multi_pod else 256
    if dist.get_world_size() != n:
        raise ValueError(f"the production mesh {shape} needs {n} ranks, "
                         f"the process group has {dist.get_world_size()}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=names)


def make_host_mesh(model: int = 1, *, device_type: str = "cuda") -> DeviceMesh:
    """A mesh of shape ``(world // model, model)`` with dims ``("data",
    "model")`` over the initialised default process group (``model`` is cut
    to the world size).  On the card it makes :func:`rank_device` this
    rank's current device."""
    dev = rank_device(device_type)
    world = dist.get_world_size()
    model = min(model, world)
    if world % model:
        raise ValueError(f"a model axis of {model} does not divide {world} ranks")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return DeviceMesh(
        device_type, torch.arange(world).reshape(world // model, model),
        mesh_dim_names=("data", "model"),
    )
