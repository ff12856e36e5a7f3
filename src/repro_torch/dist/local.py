"""The cache-free forward on local tensors: the sharded step's layout written out.

Under a mesh, the forward without a cache (training, an encoder's forward:
``models/model.py::_forward_local``) runs on each rank's local tensors
with fixed collectives: the rank's rows of the batch (split over the data
dims), whole over "model" between sublayers, and in each sublayer its
share of the work.  DTensor's sharding propagation never picks this
layout, and its view rules never meet a tensor sharded on two mesh dims;
only the sublayers without a layout here (Mamba, RWKV-6) run on DTensors
(:meth:`Local.region`), and the parameters and optimizer state stay
DTensors placed by ``dist/sharding.py::param_specs``.

A replicated activation carries the whole gradient on every "model" rank,
as Megatron-LM's tensor parallelism keeps it.  :class:`Local` gives the
forward its layout's pieces:

  * ``weight(w, dim)``: the parameter in its compute layout, ``dim`` split
    over "model" or the whole of it, moved from the layout it is stored in
    (an all-to-all, an all-gather or a slice of the local piece); in the
    backward pass its gradient goes back to the stored layout (an
    all-to-all, a reduce-scatter or a slice) and is summed over the data
    dims that split the rows (an all-reduce each);
  * ``enter`` / ``leave``: the identity with an all-reduce over "model" of
    the gradient, and an all-reduce of partial sums with the gradient
    passed through (around column- and row-parallel products);
  * ``split`` / ``gather``: this rank's part of an axis (gathered again in
    the backward pass), and the whole axis from every rank's part (the
    gradient cut to this rank's part, or summed first where each rank's
    part of the work reads the whole);
  * ``rows_sum``: a sum over the rows of every rank (the loss);
  * ``all_rows``: every rank's rows joined (the MoE where a rank's rows
    hold no whole routing group), the gradient summed and cut back.

Every collective is one of ``torch.ops._c10d_functional``'s (the functional
collectives), which the dry-run's ``roofline/profile.py::TraceCounter``
counts, in an autograd function of this module (the ``_autograd``
variants differ between torch releases).  Gloo kills a rank that
all-gathers CUDA tensors through them (ranks sharing one card), so there
an all-gather sends each rank the piece by an all-to-all.

With no mesh, :data:`ONE_DEVICE` is a layout of one rank: every piece is
the identity, and the forward computes what the one-device model computes.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

_C = torch.ops._c10d_functional


# --------------------------------------------------------------------------- #
# Collectives on local tensors
# --------------------------------------------------------------------------- #


def _wait(t: torch.Tensor) -> torch.Tensor:
    return _C.wait_tensor(t)


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The sum (or ``op``) over ``group`` of every rank's ``x``."""
    if group.size() == 1:
        return x
    return _wait(_C.all_reduce(x.contiguous(), op, group.group_name))


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Piece ``j`` of axis 0 to rank ``j``; axis 0 of the result holds the
    pieces every rank sent this one, in rank order."""
    n = group.size()
    sizes = [x.shape[0] // n] * n
    return _wait(_C.all_to_all_single(x.contiguous(), sizes, sizes, group.group_name))


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` joined along ``dim``, in rank order."""
    n = group.size()
    if n == 1:
        return x
    if x.is_cuda and dist.get_backend(group) == "gloo":
        out = _all_to_all(x.repeat(n, *[1] * (x.ndim - 1)), group)
    else:
        out = _wait(_C.all_gather_into_tensor(x.contiguous(), n, group.group_name))
    return out if dim == 0 else torch.cat(out.chunk(n), dim)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Part ``rank`` of the sum over ``group`` of every rank's ``x``, cut
    along ``dim``."""
    n = group.size()
    if n == 1:
        return x
    if dim:
        x = torch.cat(x.chunk(n, dim), 0)
    return _wait(_C.reduce_scatter_tensor(x.contiguous(), "sum", n, group.group_name))


def all_to_all(x: torch.Tensor, split: int, join: int, group) -> torch.Tensor:
    """``x`` cut along ``split`` and rejoined along ``join``: this rank's
    part of ``split`` and the whole of ``join``, from each rank's part of
    ``join`` and the whole of ``split``."""
    n = group.size()
    if n == 1:
        return x
    pieces = torch.stack(x.chunk(n, split))  # [n, *piece]
    out = _all_to_all(pieces.reshape(-1, *pieces.shape[2:]), group)
    return torch.cat(out.reshape(pieces.shape).unbind(0), join)


def _part(x: torch.Tensor, dim: int, n: int, rank: int) -> torch.Tensor:
    return x.chunk(n, dim)[rank].contiguous()


# --------------------------------------------------------------------------- #
# Autograd pieces
# --------------------------------------------------------------------------- #


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        for group in groups:
            x = all_reduce(x, group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _part(x, dim, group.size(), group.rank())

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.group), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, partial, group):
        ctx.dim, ctx.partial, ctx.group = dim, partial, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            return reduce_scatter(g, ctx.dim, ctx.group), None, None, None
        return _part(g, ctx.dim, ctx.group.size(), ctx.group.rank()), None, None, None


class _Move(torch.autograd.Function):
    """A weight's local piece from its stored layout (``stored``: the
    sharded axis over "model", or None) to its compute layout (``dim``, or
    None for the whole); the gradient back, reduced (module docstring)."""

    @staticmethod
    def forward(ctx, w, stored, dim, partial, model, data):
        ctx.args = stored, dim, partial, model, data
        if stored == dim:
            return w.view_as(w)
        if dim is None:
            return all_gather(w, stored, model)
        if stored is None:
            return _part(w, dim, model.size(), model.rank())
        return all_to_all(w, dim, stored, model)

    @staticmethod
    def backward(ctx, g):
        stored, dim, partial, model, data = ctx.args
        if stored == dim:
            if dim is None and partial:
                g = all_reduce(g, model)
        elif dim is None:
            g = (reduce_scatter(g, stored, model) if partial
                 else _part(g, stored, model.size(), model.rank()))
        elif stored is None:
            g = all_gather(g, dim, model)
        else:
            g = all_to_all(g, stored, dim, model)
        for group in data:
            g = all_reduce(g, group)
        return g, None, None, None, None, None


# --------------------------------------------------------------------------- #
# The layout of one rank's share
# --------------------------------------------------------------------------- #


class Local:
    """One rank's share of the cache-free forward (module docstring):
    ``m`` ranks over "model", this one ``r``; ``rows`` the slice of the
    batch this rank holds, as ``x``, a batch input, is placed, one of
    ``pieces`` slices."""

    def __init__(self, mesh=None, x: DTensor | None = None):
        self.mesh, self.whole_model = mesh, False
        self.m, self.r, self.rows, self.pieces = 1, 0, slice(None), 1
        self.placements, self._model, self._data = (), None, ()
        if mesh is None:
            return
        names = mesh.mesh_dim_names
        # the rows over the data dims that split them, whole over "model"
        self.placements = tuple(Shard(0) if n != "model" and isinstance(p, Shard) and p.dim == 0
                                else Replicate() for n, p in zip(names, x.placements))
        self._model = mesh.get_group("model")
        # a weight's gradient is a partial sum over the dims that split the rows
        self._data = tuple(mesh.get_group(n) for n, p in zip(names, self.placements)
                           if isinstance(p, Shard))
        self.m, self.r = mesh.size(names.index("model")), mesh.get_local_rank("model")
        piece = 0  # this rank's piece of axis 0, cut evenly, pod-major
        for i, (n, p) in enumerate(zip(names, self.placements)):
            if isinstance(p, Shard):
                piece = piece * mesh.size(i) + mesh.get_local_rank(n)
                self.pieces *= mesh.size(i)
        b = x.to_local().shape[0]
        self.rows = slice(piece * b, (piece + 1) * b)

    def whole(self) -> "Local":
        """The same rows, every "model" rank computing the whole (for widths
        "model" does not divide)."""
        if self.mesh is None or self.whole_model:
            return self
        out = Local.__new__(Local)
        out.__dict__.update(self.__dict__, whole_model=True, m=1, r=0)
        return out

    def local(self, t):
        """This rank's rows of a batch input (``t`` itself on one device)."""
        return t.to_local() if isinstance(t, DTensor) else t

    def dtensor(self, x, dim: int | None = None):
        """The DTensor of this rank's rows ``x`` (whole over "model", or
        axis ``dim`` split over it)."""
        if self.mesh is None:
            return x
        placements = list(self.placements)
        if dim is not None and self.m > 1:
            placements[self.mesh.mesh_dim_names.index("model")] = Shard(dim)
        return DTensor.from_local(x, self.mesh, placements)

    def region(self, x, fn):
        """``fn`` (a sublayer on DTensors, at the reference's constraints)
        of this rank's rows ``x``; its result's rows, whole over "model"."""
        if self.mesh is None:
            return fn(x)
        y = fn(DTensor.from_local(x, self.mesh, self.placements))
        if tuple(y.placements) != self.placements:
            y = y.redistribute(self.mesh, self.placements)
        return y.to_local(grad_placements=self.placements)

    def weight(self, w: torch.Tensor, dim: int | None = None, *, partial: bool = False):
        """``w``'s piece in the compute layout: axis ``dim`` split over
        "model", or (None) the whole of it, whose gradient each rank holds
        in part (``partial``: the ranks split the work) or whole."""
        if self.mesh is None:
            return w
        if self.whole_model:
            dim, partial = None, False
        model = w.placements[self.mesh.mesh_dim_names.index("model")]
        stored = model.dim if isinstance(model, Shard) else None
        local = w.to_local(grad_placements=w.placements)
        return _Move.apply(local, stored, dim, partial, self._model, self._data)

    def enter(self, x):
        """The identity; the gradient summed over "model" (the input of
        column-parallel products)."""
        return x if self.m == 1 else _Enter.apply(x, self._model)

    def leave(self, y):
        """The sum over "model" of the ranks' partial ``y`` (the output of
        row-parallel products); the gradient passed through."""
        return y if self.m == 1 else _Sum.apply(y, (self._model,))

    def max(self, x):
        """The largest over "model" of the ranks' ``x`` (no gradient)."""
        return x if self.m == 1 else all_reduce(x.detach(), self._model, "max")

    def rows_sum(self, x):
        """The sum over the ranks' rows (the data dims that split them) of
        ``x``, a sum over this rank's rows; the gradient passed through."""
        return _Sum.apply(x, self._data) if self._data else x

    def all_rows(self, x):
        """Every rank's rows of ``x`` joined in batch order; each rank reads
        them all, so the gradient is summed over the data dims that split
        the rows and cut to this rank's (take its own back with
        ``[self.rows]``)."""
        for group in reversed(self._data):  # inner dims first: pod-major order
            x = _Gather.apply(x, 0, True, group)
        return x

    def split(self, x, dim: int):
        """This rank's part of axis ``dim`` of a replicated ``x``."""
        return x if self.m == 1 else _Split.apply(x, dim, self._model)

    def gather(self, x, dim: int, *, partial: bool):
        """Axis ``dim`` whole from every rank's part; ``partial``: each rank
        reads the whole, so the gradient is summed over "model"."""
        return x if self.m == 1 else _Gather.apply(x, dim, partial, self._model)


ONE_DEVICE = Local()


def full(t: torch.Tensor) -> torch.Tensor:
    """The whole of ``t`` on every rank, as ``DTensor.full_tensor`` gives it,
    with each sharded mesh dim gathered by :func:`all_gather` (a plain
    tensor as it is)."""
    if not isinstance(t, DTensor):
        return t
    mesh, placements = t.device_mesh, t.placements
    if any(p.is_partial() for p in placements):
        t = t.redistribute(mesh, [Replicate() if p.is_partial() else p for p in placements])
        placements = t.placements
    if any(type(p) is not Shard and not p.is_replicate() for p in placements):
        return t.full_tensor()  # a strided shard: DTensor's own gather
    x = t.to_local()
    for i in reversed(range(mesh.ndim)):  # inner dims first: pod-major order
        if isinstance(placements[i], Shard):
            x = all_gather(x, placements[i].dim, mesh.get_group(i))
    return x
