"""Nested containers of tensors ("trees"), walked as ``jax.tree`` walks them.

The training state, its gradients and the sharding specs are nested dicts,
lists and tuples whose leaves are tensors (or numbers).  ``tree_map`` maps
leaves to leaves and keeps the containers; ``flatten_with_names`` lists the
leaves under the names the reference's checkpoints give them: dict keys in
sorted order, list and tuple indices, joined by ``/`` (``jax.tree_util``'s
order and ``repro.train.checkpoint``'s spelling).  ``None`` is an empty
subtree, as in jax.
"""
from __future__ import annotations

from collections.abc import Callable
from typing import Any


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, which have ``tree``'s structure); the same containers back."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return type(tree)(out)
    return fn(tree, *rest)


def tree_map_with_names(fn: Callable, tree, prefix: str = ""):
    """``fn(name, leaf)`` over the leaves, ``name`` as ``flatten_with_names``
    spells it; the same containers back."""
    if tree is None:
        return None
    join = (lambda k: f"{prefix}/{k}") if prefix else str
    if isinstance(tree, dict):
        return {k: tree_map_with_names(fn, v, join(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_names(fn, v, join(i)) for i, v in enumerate(tree))
    return fn(prefix, tree)


def flatten_with_names(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``[(name, leaf), ...]`` in ``jax.tree_util``'s leaf order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for key, sub in items:
        out.extend(flatten_with_names(sub, f"{prefix}/{key}" if prefix else key))
    return out


def tree_leaves(tree) -> list:
    return [leaf for _name, leaf in flatten_with_names(tree)]


def unflatten_names(flat: dict[str, Any]) -> dict:
    """Nested containers from ``{name: leaf}`` as ``flatten_with_names``
    spells the names: a level whose keys are all digits becomes a list."""
    root: dict = {}
    for path, value in flat.items():
        node = root
        *parents, leaf = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)
