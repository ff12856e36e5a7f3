"""The dry-run's profiler: what one device computes, moves and holds in a traced step.

The reference reads its costs out of compiled HLO (``cost_analysis``, the
collective ops' result shapes) and buckets per-op result bytes from the HLO
text.  The port compiles nothing: the dry-run (``launch/dryrun.py``) runs
each step eagerly on fake tensors (``FakeTensorMode``: shapes, no data),
and :class:`TraceCounter`, a dispatch mode, watches every op that one
device would run.  For each op it counts:

  * FLOPs, by ``torch.utils.flop_counter``'s formulas (the registered ops
    bring their own), as ``FlopCounterMode`` counts them: an op without a
    formula is decomposed first where it can be, then counted as 0;
  * bytes, the proxy that stands in for XLA's ``bytes accessed``: the
    bytes of each tensor the op reads plus each it writes (a tensor's
    elements times their size), counted once per op.  Views move nothing,
    nor do allocations (``empty``), collectives or their waits;
  * collective bytes by kind (the reference's five: all-reduce,
    all-gather, reduce-scatter, all-to-all, collective-permute), the bytes
    of each collective's result, as ``collective_bytes_from_hlo`` counted
    them;
  * memory: the bytes of the storages alive at once, arguments
    (:meth:`TraceCounter.hold`) included, and their peak.  A storage is
    alive from the op that makes it until its last tensor dies.

On DTensors it counts below DTensor: the mode passes each DTensor op on
(``NotImplemented``), DTensor redistributes (the collectives) and runs the
op on its local shards, and the mode counts those local ops, so every count
is per device.  The ops DTensor runs on whole-shape fake tensors to infer
an output's shape (its sharding propagation) are not counted
(:func:`tracing_dtensor`).

``traffic_by_op`` and ``biggest_ops`` read the op table (op name ->
calls, FLOPs, bytes, bytes written, the largest result) where the
reference read HLO text.
"""
from __future__ import annotations

import functools
import threading
import weakref
from contextlib import contextmanager, nullcontext

import torch
import torch.distributed._functional_collectives as funcol
from torch import nn
from torch._subclasses.fake_tensor import unset_fake_temporarily
from torch.distributed.tensor import DTensor, placement_types
from torch.distributed.tensor._ops._mask_buffer import MaskBuffer
from torch.distributed.tensor._sharding_prop import ShardingPropagator
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.roofline.analysis import COLLECTIVES, collective_bytes_from_trace

# op-name fragments of torch's collectives (c10d, functional, functional
# autograd, DTensor's all-to-all) -> the reference's kind
_KIND_OF = (
    ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
    ("all_gather", "all-gather"), ("allgather", "all-gather"),
    ("reduce_scatter", "reduce-scatter"),
    ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
    ("send", "collective-permute"), ("recv", "collective-permute"),
)
_ALLOCATIONS = {"empty", "empty_strided", "new_empty", "new_empty_strided", "empty_like"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors under ``tree`` (dicts, lists, tuples; a module as its
    parameters and buffers)."""
    if isinstance(tree, nn.Module):
        return [*tree.parameters(), *tree.buffers()]
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _local(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if isinstance(t, DTensor) else t


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages of the tensors under ``tree`` (a
    DTensor's local shard)."""
    sizes = {}
    for t in _tensors(tree):
        st = _local(t).untyped_storage()
        sizes[st._cdata] = st.nbytes()
    return sum(sizes.values())


class _Kind:
    """How the counter treats one op overload (cached per overload)."""

    __slots__ = ("name", "collective", "moves", "fresh")

    def __init__(self, func):
        ns, base = func.namespace, func._opname
        self.name = f"{ns}.{base}"
        self.collective = None  # "" for one that is none of the five kinds
        if ns in ("c10d", "_c10d_functional", "_c10d_functional_autograd", "_dtensor"):
            self.collective = next((k for frag, k in _KIND_OF if frag in base), "")
        rets = func._schema.returns
        views = any(r.alias_info is not None and not r.alias_info.is_write for r in rets)
        # bytes are moved by every op but views, allocations and collectives
        self.moves = not (views or base in _ALLOCATIONS or self.collective is not None)
        # outputs are new storages unless they alias an input
        self.fresh = all(r.alias_info is None for r in rets)


class TraceCounter(TorchDispatchMode):
    """Counts FLOPs, bytes, collective bytes, live memory and an op table of
    the ops one device runs while it is active (module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives = dict.fromkeys(COLLECTIVES, 0)
        self.table: dict[str, dict] = {}
        self.live = 0
        self.peak = 0
        self._held: dict[int, int] = {}  # storage key -> bytes
        self._kinds: dict = {}
        self._lock = threading.RLock()

    # -------------------------------------------------------------- memory
    def _track(self, st) -> int:
        key = st._cdata
        if key in self._held:
            return 0
        n = st.nbytes()
        self._held[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._release, key)
        return n

    def _release(self, key: int) -> None:
        with self._lock:
            self.live -= self._held.pop(key, 0)

    def hold(self, tree) -> int:
        """Count the tensors of ``tree`` (their local shards) as alive, as a
        step's arguments are; returns the bytes newly counted."""
        with self._lock:
            return sum(self._track(_local(t).untyped_storage()) for t in _tensors(tree))

    # ------------------------------------------------------------ dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs it on the local shards
        if _PROPAGATING.depth:
            return func(*args, **kwargs)
        kind = self._kinds.get(func)
        if kind is None:
            kind = self._kinds[func] = _Kind(func)
        if kind.name.startswith("prim.") or kind.name.endswith(".wait_tensor"):
            return func(*args, **kwargs)  # metadata, or the wait on a collective
        # as FlopCounterMode: an op that decomposes is counted as its parts
        with self:
            r = func.decompose(*args, **kwargs)
        if r is not NotImplemented:
            return r
        out = func(*args, **kwargs)
        self._count(func, kind, args, kwargs, out)
        return out

    def _count(self, func, kind: _Kind, args, kwargs, out) -> None:
        outs = _tensors(out)
        flop_fn = flop_registry.get(func._overloadpacket)
        flops = flop_fn(*args, **kwargs, out_val=out) if flop_fn else 0
        # bytes written: none for a view or an allocation
        result = sum(_nbytes(t) for t in outs) if kind.moves or kind.collective else 0
        moved = 0
        if kind.moves:
            moved = sum(_nbytes(t) for t in _tensors((args, kwargs))) + result
        with self._lock:
            self.flops += flops
            self.bytes += moved
            if kind.collective is not None:
                if not kind.collective:
                    raise ValueError(f"{kind.name}: a collective the dry-run cannot name")
                self.collectives[kind.collective] += result
            row = self.table.get(kind.name)
            if row is None:
                row = self.table[kind.name] = {"calls": 0, "flops": 0, "bytes": 0,
                                               "result_bytes": 0, "max_result_bytes": 0,
                                               "max_result": ""}
            row["calls"] += 1
            row["flops"] += flops
            row["bytes"] += moved
            row["result_bytes"] += result
            if result > row["max_result_bytes"]:
                row["max_result_bytes"] = result
                row["max_result"] = ", ".join(f"{t.dtype}{list(t.shape)}" for t in outs)[:80]
            if kind.fresh:
                for t in outs:
                    self._track(t.untyped_storage())

    def costs(self) -> dict:
        """The reference's cost keys: flops, bytes, collective bytes (total
        and by kind)."""
        coll = collective_bytes_from_trace(self)
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "collective_bytes": float(coll["total"]), "collectives": coll}


class _Propagating(threading.local):
    depth = 0


_PROPAGATING = _Propagating()


def _all_to_all(input, gather_dim, shard_dim, mesh, mesh_dim):
    """DTensor's all-to-all of a shard, issued on every mesh."""
    group = funcol._resolve_group((mesh, mesh_dim))
    return torch.ops._dtensor.shard_dim_alltoall(
        input, gather_dim, shard_dim, funcol._group_or_group_name(group))


def _not_the_device(fn, real: bool = False):
    """``fn`` with every :class:`TraceCounter` passing its ops (and, with
    ``real``, on real tensors: outside the fake mode)."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        _PROPAGATING.depth += 1
        try:
            with unset_fake_temporarily() if real else nullcontext():
                return fn(*args, **kwargs)
        finally:
            _PROPAGATING.depth -= 1

    return wrapped


@contextmanager
def tracing_dtensor():
    """DTensor as a traced step needs it, while active:

      * the ops DTensor's sharding propagation runs (on whole-shape fake
        tensors, to infer output shapes, and its placement arithmetic) are
        passed by every :class:`TraceCounter`: they are not the device's
        work;
      * a strided shard's sizes and offsets are computed on real tensors,
        as outside a trace (DTensor computes them with ``arange`` and
        ``tolist``, which a fake tensor cannot answer);
      * a shard moves to another tensor dim by one all-to-all on a mesh of
        any device type, as on the card (DTensor replaces it by an
        all-gather on a ``"cpu"`` mesh, for gloo; the fake group runs
        neither);
      * a vocabulary-sharded embedding's mask, made again for a second use,
        is not compared with the first one by value (``torch.equal``: a
        fake tensor has no values; the two are made alike)."""
    patches = [
        (ShardingPropagator, "propagate_op_sharding_non_cached", False),
        (ShardingPropagator, "_propagate_tensor_meta_non_cached", False),
        (placement_types._StridedShard, "local_shard_size_and_offset", True),
    ]
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in patches]
    saved += [(placement_types, "shard_dim_alltoall", placement_types.shard_dim_alltoall),
              (MaskBuffer, "materialize_mask", MaskBuffer.materialize_mask)]
    for owner, name, real in patches:
        setattr(owner, name, _not_the_device(getattr(owner, name), real))
    placement_types.shard_dim_alltoall = _all_to_all
    MaskBuffer.materialize_mask = _materialize_mask
    try:
        yield
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def _materialize_mask(self, mask):
    """``MaskBuffer.materialize_mask`` without its by-value compare."""
    if self.refcount == 0:
        self.data = mask
    elif self.data is None or self.data.shape != mask.shape:
        raise RuntimeError("MaskBuffer has been materialized with conflicting data")
    self.refcount += 1


def traffic_by_op(table: dict, top: int = 12) -> list[tuple[str, int]]:
    """(op, bytes its calls wrote), the largest first: which ops write the
    bytes."""
    rows = [(op, row["result_bytes"]) for op, row in table.items()]
    rows.sort(key=lambda r: r[1], reverse=True)
    return rows[:top]


def biggest_ops(table: dict, top: int = 12) -> list[tuple[int, str, str]]:
    """(bytes, op, result shapes) of each op's largest single result, the
    largest first."""
    rows = [(row["max_result_bytes"], op, row["max_result"]) for op, row in table.items()]
    rows.sort(reverse=True)
    return rows[:top]
