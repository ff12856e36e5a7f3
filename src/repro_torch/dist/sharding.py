"""DTensor placements for parameter / data / cache trees.

The reference's rule set (``repro.dist.sharding``), over a
``torch.distributed.device_mesh.DeviceMesh`` whose dims are named
``("data", "model")`` or ``("pod", "data", "model")``.  A spec is a tuple
with one placement per mesh dim (``Shard(i)`` or ``Replicate()``), where the
reference writes a ``PartitionSpec`` naming the mesh axes of each tensor
axis; a tensor axis the reference shards over ``("pod", "data")`` is
``Shard`` on both of those mesh dims here (pod-major, as there).

  params  shard the largest axis divisible by the "model" size; on a tie the
          *last* such axis (vocab / ffn columns).  Scalars and indivisible
          leaves replicate.
  data    shard axis 0 (the global batch) over the data-like dims ("pod",
          "data") when divisible; everything else replicated.
  cache   like data, plus rank-4 [B, T, Hk, hd] KV blocks shard their head
          axis over "model" when divisible.

The port's model keeps one tensor per layer where the reference stacks a
scan unit's layers on a leading axis, so the rule runs on each layer's own
shape: it names the same axis as the reference's on the stacked leaf,
except where the reference would pick the layer axis itself (more layers
than any divisible axis of a layer is long), which a per-layer tensor does
not have: such a leaf replicates here.

``to_named`` places a tree on the mesh with ``distribute_tensor``: every
rank calls it with the same tree and keeps its own pieces of each tensor,
with no communication.  An ``nn.Module`` in the tree has its parameters
replaced by DTensor parameters in place.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro_torch.tree import tree_map


def _sizes(mesh: DeviceMesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _data_axes(mesh: DeviceMesh) -> tuple[str, ...]:
    return tuple(n for n in ("pod", "data") if n in mesh.mesh_dim_names)


def _dp_size(mesh: DeviceMesh) -> int:
    sizes = _sizes(mesh)
    return math.prod(sizes[a] for a in _data_axes(mesh))


def placements(mesh: DeviceMesh, entries: dict[str, int]) -> tuple:
    """One placement per mesh dim: ``Shard(entries[name])`` for the dims
    named in ``entries`` (mesh dim -> tensor axis), ``Replicate()`` else."""
    return tuple(Shard(entries[n]) if n in entries else Replicate()
                 for n in mesh.mesh_dim_names)


def batch_entries(mesh: DeviceMesh) -> dict[str, int]:
    """Tensor axis 0 over every data-like mesh dim."""
    return {a: 0 for a in _data_axes(mesh)}


def _shape_of(leaf) -> tuple[int, ...] | None:
    shape = getattr(leaf, "shape", None)
    return tuple(shape) if shape is not None else None


def tensor_tree(tree):
    """``tree`` with each ``nn.Module`` as the dict of its named parameters."""
    if isinstance(tree, nn.Module):
        return dict(tree.named_parameters())
    if isinstance(tree, dict):
        return {k: tensor_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tensor_tree(v) for v in tree)
    return tree


def param_specs(tree, mesh: DeviceMesh):
    """Model-parallel placements per parameter (largest "model"-divisible axis)."""
    m = _sizes(mesh).get("model", 1)

    def spec(leaf) -> tuple:
        shape = _shape_of(leaf)
        if not shape or m <= 1:
            return placements(mesh, {})
        best = -1
        for i, s in enumerate(shape):
            if s % m == 0 and s >= m and (best < 0 or s >= shape[best]):
                best = i
        return placements(mesh, {} if best < 0 else {"model": best})

    return tree_map(spec, tensor_tree(tree))


def data_specs(tree, mesh: DeviceMesh):
    """Batch-parallel placements per input leaf (axis 0 over the data dims)."""
    dp = _dp_size(mesh)

    def spec(leaf) -> tuple:
        shape = _shape_of(leaf)
        if not shape or dp <= 1 or shape[0] % dp:
            return placements(mesh, {})
        return placements(mesh, batch_entries(mesh))

    return tree_map(spec, tensor_tree(tree))


def cache_specs(tree, mesh: DeviceMesh):
    """KV/state cache placements: batch over data, KV heads over "model"."""
    dp = _dp_size(mesh)
    m = _sizes(mesh).get("model", 1)

    def spec(leaf) -> tuple:
        shape = _shape_of(leaf)
        if not shape:
            return placements(mesh, {})
        entries = {}
        if dp > 1 and shape[0] % dp == 0:
            entries = batch_entries(mesh)
        if len(shape) == 4 and m > 1 and shape[2] % m == 0:
            entries["model"] = 2
        return placements(mesh, entries)

    return tree_map(spec, tensor_tree(tree))


def _place(leaf, spec, mesh: DeviceMesh):
    if not isinstance(leaf, torch.Tensor):
        return leaf
    if isinstance(leaf, DTensor):
        return leaf.redistribute(mesh, spec)
    # every rank holds the same tree: each keeps its own pieces, no scatter
    return distribute_tensor(leaf.detach(), mesh, spec, src_data_rank=None)


def to_named(tree, spec_tree, mesh: DeviceMesh):
    """``tree`` placed on ``mesh`` by ``spec_tree`` (its ``*_specs``): each
    tensor distributed (a DTensor redistributed), each ``nn.Module``'s
    parameters replaced in place by DTensor parameters, the module returned."""
    if isinstance(tree, nn.Module):
        for name, p in list(tree.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            mod = tree.get_submodule(owner)
            mod.register_parameter(leaf, nn.Parameter(
                _place(p.data, spec_tree[name], mesh), requires_grad=p.requires_grad))
        return tree
    if isinstance(tree, dict):
        return {k: to_named(v, spec_tree[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_named(v, s, mesh) for v, s in zip(tree, spec_tree))
    return _place(tree, spec_tree, mesh)
