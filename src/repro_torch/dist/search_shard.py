"""Distributed IDList keyword search: lists cut into segments over the "model" group.

Every rank of a :class:`~torch.distributed.device_mesh.DeviceMesh` calls the
same function with the same inputs (SPMD), and every rank returns the same
answer, bit-identical to the single-device vectorized search (integer
lattice ops, no reassociation).  Two entry points:

``distributed_query(lists, mesh, semantics, *, backend)``
    One query.  The lists are packed on the host (``search_vec.pack_query``).
    Every rank copies the whole L0 (ids, parents, NDesc) to its own device,
    and rank r of the mesh's "model" group (size M) takes segment r of each
    other padded list, ids and NDesc, with local valid lengths ``clamp(n - r
    * SEG, 0, SEG)``.  A list whose bucket M does not divide stays whole on
    every rank (bucket sizes are powers of two >= 16, so any power-of-two M
    divides them), as does every list when M = 1.  Each rank finds every L0
    id in its own segment of each other list (``search_vec.membership_stage``:
    positions are local and serve only the local NDesc gather), found flags
    and NDesc are zero elsewhere, and one ``all_reduce(MAX)`` over the group
    combines them (MAX, not SUM, so that a list held whole is not counted M
    times).  Every rank then runs the keep stage (``search_vec.keep_stage``)
    on the whole L0.  The reference shards L0 as well and all-gathers it
    inside the mapped function; here every rank holds the packed L0 on the
    host already, so the gather would only move the same ids again.

``make_distributed_search(mesh, k, semantics, *, backend)``
    The production-shaped variant: ``fn(ids, pid, ndesc)`` takes the rank's
    own ``[Q, k, SEG]`` segment, the m-th of ``[Q, k, M, SEG]`` inputs whose
    ids ascend across the flattened ``(M, SEG)`` axis with INT_PAD tails,
    and returns the replicated ``(result_ids, result_mask)`` ``[Q, M *
    SEG]`` of the whole array.  Each rank holds only its segment of L0
    here, so L0's segments are all-gathered over the group first.

``backend`` names a membership backend of ``search_vec``'s registry:
``"torch"`` (the reference's default, ``"xla"``) or ``"chained"``, each
rank's membership through ``csrc/searchsorted.cu`` on its own segment.  The
reference forwards no backend; this is the port's one addition.

The process group's backend is the caller's (``launch/mesh.py``): NCCL with
one card per rank, gloo when ranks share a card or run on the CPU.  A
failing collective raises; nothing retries it another way.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

import repro_torch.kernels.ops  # noqa: F401  (registers the "chained" membership backend)
from repro_torch.core.idlist import IDList
from repro_torch.core.search_vec import (
    INT_PAD,
    keep_stage,
    membership_stage,
    pack_query,
)
from repro_torch.launch.mesh import rank_device

_CPU = torch.device("cpu")


def _model_axis(mesh: DeviceMesh) -> tuple:
    """(the "model" group, its size M, this rank's index in it)."""
    return (mesh.get_group("model"), mesh.size(mesh.mesh_dim_names.index("model")),
            mesh.get_local_rank("model"))


def _all_gather(t: torch.Tensor, group, m: int, dim: int = 0) -> torch.Tensor:
    """The group's M segments of ``t``, concatenated along ``dim`` in rank order."""
    parts = [torch.empty_like(t) for _ in range(m)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _combine(found: torch.Tensor, nd: torch.Tensor, group) -> tuple:
    """Every rank's found flags and NDesc, combined by one all_reduce(MAX)."""
    both = torch.stack([found.to(torch.int32), nd])
    dist.all_reduce(both, op=dist.ReduceOp.MAX, group=group)
    return both[0] != 0, both[1]


def _local_query(packed: dict, dev: torch.device, m: int, r: int) -> tuple:
    """The whole L0 and this rank's segment of the other lists with their
    local valid lengths, on ``dev``."""
    l0 = [packed[n].to(dev) for n in ("ids0", "pid0", "ndesc0")]
    oids, ond, on = packed["other_ids"], packed["other_ndesc"], packed["other_n"]
    if m > 1 and oids.shape[1] % m == 0:
        seg = oids.shape[1] // m
        oids, ond = oids[:, r * seg : (r + 1) * seg], ond[:, r * seg : (r + 1) * seg]
        on = (on - r * seg).clamp(0, seg)
    return (*l0, *(t.contiguous().to(dev) for t in (oids, ond, on)))


def distributed_query(
    lists: list[IDList], mesh: DeviceMesh, semantics: str = "slca", *,
    backend: str = "torch",
) -> np.ndarray:
    """One keyword query over model-axis segmented IDLists -> sorted node ids."""
    packed = pack_query(lists, _CPU)
    if packed is None:
        return np.zeros(0, dtype=np.int64)
    dev = rank_device(mesh.device_type)
    group, m, r = _model_axis(mesh)
    ids0, pid0, nd0, oids, ond, on = _local_query(packed, dev, m, r)
    found, nd = membership_stage(ids0[None], oids[None], ond[None], on[None], backend)
    if oids.shape[0]:  # every rank has the same lists, so all take this branch
        found, nd = _combine(found, nd, group)
    ids, mask = keep_stage(
        ids0[None], pid0[None], nd0[None], packed["n0"].reshape(1).to(dev),
        found, nd, semantics=semantics,
    )
    ids = ids[0].cpu().numpy()
    return ids[mask[0].cpu().numpy()].astype(np.int64)


def make_distributed_search(
    mesh: DeviceMesh, k: int, semantics: str = "slca", *, backend: str = "torch",
):
    """Batched search over each rank's ``[Q, k, SEG]`` segment of
    pre-segmented ``[Q, k, M, SEG]`` inputs."""
    group, m, _r = _model_axis(mesh)

    def fn(ids: torch.Tensor, pid: torch.Tensor, ndesc: torch.Tensor):
        q, kk, _seg = ids.shape
        if kk != k:
            raise ValueError(f"built for k={k} keyword lists, got inputs with {kk}")
        n_local = (ids < INT_PAD).sum(dim=-1, dtype=torch.int32)  # [Q, k]
        n_valid = n_local.clone()
        dist.all_reduce(n_valid, op=dist.ReduceOp.SUM, group=group)
        ids0, pid0, nd0 = (_all_gather(x[:, 0], group, m, dim=1) for x in (ids, pid, ndesc))
        found, nd = membership_stage(
            ids0, ids[:, 1:].contiguous(), ndesc[:, 1:].contiguous(),
            n_local[:, 1:].contiguous(), backend,
        )
        if kk > 1:
            found, nd = _combine(found, nd, group)
        return keep_stage(ids0, pid0, nd0, n_valid[:, 0], found, nd, semantics=semantics)

    return fn
