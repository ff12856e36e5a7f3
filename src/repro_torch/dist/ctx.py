"""Ambient sharding context: a mesh that model code can consult.

Model forward passes call :func:`constrain_batch` / :func:`constrain_vocab`
/ :func:`constrain_heads` (and the MoE's :func:`moe_groups` /
:func:`constrain_groups` / :func:`constrain_experts`, the train step's
:func:`replicate`) unconditionally;
with no active context they are the identity, so single-device paths pay
nothing and stay mesh-free.  Inside
``with ctx.use(mesh):`` the same calls redistribute a DTensor to the (data,
model) layout the reference pins with ``with_sharding_constraint``: a
``Partial`` sum becomes whole (an all-reduce), a replicated axis is cut.  A
plain tensor passes through unchanged.

``use`` also enters DTensor's ``implicit_replication``: the plain tensors
the model makes on the way (positions, masks, rotary tables) count as
replicated over the mesh when they meet a DTensor.

Constraints are *best effort*, as the reference's: an axis that does not
divide the mesh dims is left as it is rather than padded.

:func:`layout` is the other way: the cache-free forward (training, an
encoder's forward) runs on the rank's local tensors with its collectives
written out (``dist/local.py``), and only the sublayers without such a
layout (MoE, MLA, Mamba, RWKV-6) meet DTensor, at the constraints above.
"""
from __future__ import annotations

from contextlib import contextmanager
from contextvars import ContextVar

from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.dist import local
from repro_torch.dist.sharding import _data_axes, _dp_size, _sizes, batch_entries, placements

_ACTIVE: ContextVar["ShardCtx | None"] = ContextVar("repro_torch_shard_ctx", default=None)


class ShardCtx:
    """One active mesh plus the derived axis bookkeeping.

    Axis policy (which mesh dims are data-like, how the batch is placed) is
    owned by :mod:`repro_torch.dist.sharding` so activations and input
    placements can never disagree.
    """

    def __init__(self, mesh: DeviceMesh):
        self.mesh = mesh
        self.data_axes = _data_axes(mesh)
        self.model_size = _sizes(mesh).get("model", 1)

    def dp_size(self) -> int:
        return _dp_size(self.mesh)

    def _constrain(self, x, entries: dict[str, int]):
        if not isinstance(x, DTensor):
            return x
        want = placements(self.mesh, entries)
        if tuple(x.placements) == want:
            return x
        return x.redistribute(self.mesh, want)

    def _batch(self, x) -> dict[str, int]:
        """The batch entries when the data dims divide axis 0, else none."""
        if self.data_axes and x.ndim >= 1 and x.shape[0] % self.dp_size() == 0:
            return batch_entries(self.mesh)
        return {}

    def constrain_batch(self, x):
        """Pin axis 0 (batch) over the data dims; the rest replicated.  A
        batch the data dims do not divide stays as it is, unless a pending
        sum (``Partial``) is on it: that is reduced here, once (a
        vocabulary-sharded embedding's masked sum can be reduced only once,
        and every consumer of an unreduced one would reduce it again)."""
        entries = self._batch(x)
        if entries or (isinstance(x, DTensor) and any(p.is_partial() for p in x.placements)):
            return self._constrain(x, entries)
        return x

    def constrain_vocab(self, x):
        """Pin the trailing (vocab) axis over "model"; batch over data."""
        if self.model_size <= 1 or x.ndim < 1 or x.shape[-1] % self.model_size:
            return self.constrain_batch(x)
        entries = self._batch(x) if x.ndim > 1 else {}
        return self._constrain(x, {**entries, "model": x.ndim - 1})

    def constrain_heads(self, x):
        """Pin axis 2 (heads) of [B, S, H, hd] over "model" (head-TP)."""
        if x.ndim != 4 or self.model_size <= 1 or x.shape[2] % self.model_size:
            return self.constrain_batch(x)
        return self._constrain(x, {**self._batch(x), "model": 2})

    def shard_rows(self, x):
        """Pin axis 0 (a step's rows) over the data dims that divide it, the
        innermost first, the rest whole: a microbatch of fewer rows than
        data ranks is split where it can be, and repeated only over the
        dims that cannot split it."""
        sizes, entries, n = _sizes(self.mesh), {}, 1
        for a in reversed(self.data_axes):
            if x.shape[0] % (n * sizes[a]) == 0:
                entries[a], n = 0, n * sizes[a]
        return self._constrain(x, entries)

    def moe_groups(self, t: int, num_experts: int) -> int:
        """The MoE's routing groups for ``t`` tokens: one per data shard when
        they divide ``t`` and each group holds ``num_experts`` tokens or
        more, else one."""
        g = self.dp_size()
        return g if g > 1 and t % g == 0 and t // g >= num_experts else 1

    def replicate(self, x):
        """The whole of ``x`` (a step's input: no gradient) on every rank:
        what is sharded is gathered (``local.full``: gloo cannot all-gather
        CUDA tensors through DTensor), what is pending is reduced."""
        if not isinstance(x, DTensor):
            return x
        return DTensor.from_local(local.full(x), self.mesh, placements(self.mesh, {}))

    def constrain_groups(self, x):
        """Pin axis 0 (the MoE's token groups) over the data dims, the rest
        whole, in the forward pass and for the gradient in the backward:
        DTensor's view rules mis-size a reshape of a tensor sharded on two
        mesh dims, and the MoE reshapes its tokens into groups and back."""
        if not isinstance(x, DTensor):
            return x
        return x.redistribute(self.mesh, placements(self.mesh, self._batch(x)))

    def constrain_experts(self, x):
        """Pin [G, E, C, D]: groups over the data dims, experts over "model"
        when it divides E (expert parallelism)."""
        entries = self._batch(x)
        if self.model_size > 1 and x.shape[1] % self.model_size == 0:
            entries["model"] = 1
        return self._constrain(x, entries)


# ---------------------------------------------------------------------- #
# Module-level API (what model code imports)
# ---------------------------------------------------------------------- #


def current() -> ShardCtx | None:
    """The active ShardCtx, or None outside any ``use`` block."""
    return _ACTIVE.get()


@contextmanager
def use(mesh: DeviceMesh):
    """Activate ``mesh`` for the dynamic extent of the block."""
    token = _ACTIVE.set(ShardCtx(mesh))
    try:
        with implicit_replication():
            yield _ACTIVE.get()
    finally:
        _ACTIVE.reset(token)


def constrain_batch(x):
    sctx = current()
    return x if sctx is None else sctx.constrain_batch(x)


def constrain_vocab(x):
    sctx = current()
    return x if sctx is None else sctx.constrain_vocab(x)


def constrain_heads(x):
    sctx = current()
    return x if sctx is None else sctx.constrain_heads(x)


def shard_rows(x):
    sctx = current()
    return x if sctx is None else sctx.shard_rows(x)


def moe_groups(t: int, num_experts: int) -> int:
    sctx = current()
    return 1 if sctx is None else sctx.moe_groups(t, num_experts)


def replicate(x):
    sctx = current()
    return x if sctx is None else sctx.replicate(x)


def constrain_groups(x):
    sctx = current()
    return x if sctx is None else sctx.constrain_groups(x)


def constrain_experts(x):
    sctx = current()
    return x if sctx is None else sctx.constrain_experts(x)


def layout(x) -> local.Local:
    """The explicit layout (``dist/local.py``) of a cache-free forward over
    the batch input ``x``: this rank's rows of ``x`` under an active mesh,
    else one device."""
    sctx = current()
    if sctx is None or not isinstance(x, DTensor):
        return local.ONE_DEVICE
    return local.Local(sctx.mesh, x)
