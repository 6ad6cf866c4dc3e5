"""Partition specs, DTensor placement and the collectives of the sharded
forward.

The port's stand-in for ``jax.sharding``: a :class:`PartitionSpec` with
the reference's spelling (``PartitionSpec(None, 'model')``), a
:class:`NamedSharding` of a ``DeviceMesh`` and a spec, and the
``Shard``/``Replicate`` placements a spec gives on that mesh. Several
mesh axes on one tensor dim (``PartitionSpec(('data', 'model'), None)``)
shard it in mesh order, outer axis first, as JAX does.

DTensor is kept at the storage boundary. :func:`device_put` places a
global tensor (the same on every rank) by keeping each rank's own piece,
with no collective; :func:`split` hands model code that piece as a plain
tensor and says where it lies (:class:`Sharded`); :func:`all_reduce` and
:func:`all_gather` run on the mesh axes' process groups. The kernels only
ever see plain local tensors. A mesh axis of size 1 has no collective: on
one device the sharded forward runs the replicated forward's operations.
Every sharded dim must divide its axes evenly (``ValueError``
otherwise).

Gradients. A sum's backward is a sum over the same axes and a gather's
backward sums the cotangent over its axes and keeps this rank's slice,
the transposes of ``psum`` and ``all_gather`` under the reference's
``shard_map``: the cotangent of a tensor every rank of an axis holds
the same is kept as per-rank partial sums, and every collective's
backward completes them. A training step that runs a replicated loss on
every rank therefore backpropagates its loss divided by the ranks and
sums the gradients of the leaves replicated over an axis over it
(``launch.steps``). Without grad (serving) both run the plain in-place
collectives, unchanged. :func:`collective_trace` hands every collective's
result bytes to a callback (``launch.hlo_analysis``).
"""
from __future__ import annotations

import contextlib
import contextvars
import sys
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor, without importing DTensor (about a
    second and a half) in a process that never made one."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


class PartitionSpec(tuple):
    """A tuple of mesh axis names (or tuples of them, or None) per tensor
    dim, printed as ``jax.sharding.PartitionSpec`` prints."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)

    __str__ = __repr__


P = PartitionSpec


def spec_axes(s) -> Tuple[str, ...]:
    """The axis names of one entry of a spec."""
    if s is None:
        return ()
    return (s,) if isinstance(s, str) else tuple(s)


def placements_of(spec: PartitionSpec, mesh) -> tuple:
    """DTensor placements (one per mesh dim) of ``spec`` on ``mesh``; axes
    the mesh lacks are dropped (replicated)."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    out = [Replicate()] * mesh.ndim
    for tdim, s in enumerate(spec):
        for a in spec_axes(s):
            if a in names:
                out[names.index(a)] = Shard(tdim)
    return tuple(out)


class NamedSharding(NamedTuple):
    """``spec`` over ``mesh`` (``jax.sharding.NamedSharding``)."""
    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements_of(self.spec, self.mesh)


def _local_piece(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's piece of the global tensor ``t`` (a view)."""
    for mdim, p in enumerate(placements):
        if p.is_shard():
            k = mesh.size(mdim)
            n = t.shape[p.dim]
            if n % k:
                raise ValueError(
                    f"dim {p.dim} of size {n} does not divide over mesh "
                    f"axis {mesh.mesh_dim_names[mdim]!r} of size {k}")
            c = mesh.get_local_rank(mdim)
            t = t.narrow(p.dim, c * (n // k), n // k)
    return t


def device_put(x, sharding: NamedSharding, device=None):
    """Place ``x`` (a numpy array or tensor holding the global value on
    every rank) as a DTensor: each rank moves only its own piece to
    ``device`` (one transfer, none at all when ``x`` is already there:
    on one device the DTensor wraps ``x`` itself) and no collective
    runs."""
    from torch.distributed.tensor import DTensor

    t = torch.as_tensor(x)
    placements = sharding.placements
    local = _local_piece(t, sharding.mesh, placements)
    if device is not None:
        local = local.to(device, non_blocking=True)
    return DTensor.from_local(local, sharding.mesh, placements,
                              run_check=False)


class Axis(NamedTuple):
    """One mesh axis as this rank sees it."""
    name: str
    group: object        # its ProcessGroup
    size: int
    coord: int           # this rank's index along it


def mesh_axes(mesh, names: Sequence[str]) -> List[Axis]:
    """The axes of ``names`` that ``mesh`` has with more than one rank,
    in mesh order (outer first)."""
    out = []
    for mdim, name in enumerate(mesh.mesh_dim_names):
        if name in names and mesh.size(mdim) > 1:
            out.append(Axis(name, mesh.get_group(name), mesh.size(mdim),
                            mesh.get_local_rank(mdim)))
    return out


_BATCH: contextvars.ContextVar = contextvars.ContextVar("batch_axes",
                                                        default=())


@contextlib.contextmanager
def batch_split(axes: Sequence[Axis]):
    """Declare, for the ``with`` block, that the rows of the batch the
    forward sees are split evenly over ``axes`` (row-major, as
    :func:`flat_coord` numbers the ranks). A row-sharded table whose
    axes include one of them gathers the indices over it first
    (``models.recsys.embedding.lookup``): the batch and the table are
    sharded differently, and this is the exchange between them."""
    token = _BATCH.set(tuple(axes))
    try:
        yield
    finally:
        _BATCH.reset(token)


def batch_axes() -> Tuple[Axis, ...]:
    return _BATCH.get()


def flat_coord(axes: Sequence[Axis]) -> Tuple[int, int]:
    """(this rank's row-major index over ``axes``, their total size)."""
    idx, total = 0, 1
    for a in axes:
        idx, total = idx * a.size + a.coord, total * a.size
    return idx, total


class Sharded(NamedTuple):
    """Where a local piece lies in its global tensor."""
    dim: int             # the sharded tensor dim
    offset: int          # the piece's first index along it
    total: int           # the global length along it
    ways: int            # the number of pieces
    axes: List[Axis]     # the mesh axes it is sharded over, outer first


def split(t) -> Tuple[torch.Tensor, Optional[Sharded]]:
    """(the local tensor, its :class:`Sharded`) of a parameter leaf. A
    plain tensor, or a DTensor whose sharding axes all have size 1,
    gives ``None``: the caller runs the replicated code."""
    if not is_dtensor(t):
        return t, None
    mesh = t.device_mesh
    dims = {p.dim for p in t.placements if p.is_shard()}
    if len(dims) > 1:
        raise ValueError(f"one sharded dim per tensor, got {t.placements}")
    local = t.to_local()
    names = [mesh.mesh_dim_names[m] for m, p in enumerate(t.placements)
             if p.is_shard()]
    axes = mesh_axes(mesh, names)
    if not axes:
        return local, None
    dim = dims.pop()
    idx, ways = flat_coord(axes)
    return local, Sharded(dim, idx * local.shape[dim], t.shape[dim], ways,
                          axes)


# the ``collective_trace`` callback: a process-wide slot, not a context
# variable, so that a backward pass on autograd's own thread reports too
_TRACE: list = []


@contextlib.contextmanager
def collective_trace(note):
    """Call ``note(kind, result_bytes)`` for every collective of the
    ``with`` block (``kind`` is ``"all-reduce"`` or ``"all-gather"``),
    backward passes included, on any thread."""
    _TRACE.append(note)
    try:
        yield
    finally:
        _TRACE.remove(note)


def _noted(kind: str, t: torch.Tensor) -> None:
    if _TRACE:
        _TRACE[-1](kind, t.numel() * t.element_size())


def _reduce_(x: torch.Tensor, axes: Sequence[Axis], red) -> None:
    for a in axes:
        _noted("all-reduce", x)
        dist.all_reduce(x, op=red, group=a.group)


def _gather(x: torch.Tensor, axes: Sequence[Axis], dim: int) -> torch.Tensor:
    for a in reversed(axes):
        parts = [torch.empty_like(x) for _ in range(a.size)]
        dist.all_gather(parts, x.contiguous(), group=a.group)
        x = torch.cat(parts, dim=dim)
        _noted("all-gather", x)
    return x


class _AllReduce(torch.autograd.Function):
    """Sum over ``axes``; its backward sums the cotangent over them."""

    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        y = x.contiguous().clone()
        _reduce_(y, axes, dist.ReduceOp.SUM)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        _reduce_(g, ctx.axes, dist.ReduceOp.SUM)
        return g, None


class _AllGather(torch.autograd.Function):
    """Gather over ``axes``; its backward sums the cotangent over them and
    keeps this rank's slice."""

    @staticmethod
    def forward(ctx, x, axes, dim):
        ctx.axes, ctx.dim, ctx.n = axes, dim, x.shape[dim]
        return _gather(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        _reduce_(g, ctx.axes, dist.ReduceOp.SUM)
        i, _ = flat_coord(ctx.axes)
        return g.narrow(ctx.dim, i * ctx.n, ctx.n), None, None


def _differentiable(x: torch.Tensor, axes) -> bool:
    return bool(axes) and torch.is_grad_enabled() and x.requires_grad


def all_reduce(x: torch.Tensor, axes: Sequence[Axis],
               op: str = "sum") -> torch.Tensor:
    """``x`` reduced over ``axes``. Without grad it is reduced in place
    when ``x`` is contiguous (pass a temporary); a sum that needs a
    gradient runs on a copy, with the backward of the module note. A
    max passes no gradient."""
    if op == "sum" and _differentiable(x, axes):
        return _AllReduce.apply(x, tuple(axes))
    x = x.detach().contiguous() if x.requires_grad else x.contiguous()
    _reduce_(x, axes, {"sum": dist.ReduceOp.SUM,
                       "max": dist.ReduceOp.MAX}[op])
    return x


def all_gather(x: torch.Tensor, axes: Sequence[Axis],
               dim: int) -> torch.Tensor:
    """The pieces of ``axes`` concatenated along ``dim`` in mesh order:
    the inner axis first, then the outer (the backward of the module
    note when ``x`` needs a gradient)."""
    if _differentiable(x, axes):
        return _AllGather.apply(x, tuple(axes), dim)
    return _gather(x, axes, dim)


def full_tensor(t) -> torch.Tensor:
    """The global value of a DTensor as a plain tensor (``t`` itself when
    it is plain); only sharded axes of more than one rank communicate."""
    local, sh = split(t)
    return local if sh is None else all_gather(local, sh.axes, sh.dim)
