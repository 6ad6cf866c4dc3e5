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


def all_reduce(x: torch.Tensor, axes: Sequence[Axis],
               op: str = "sum") -> torch.Tensor:
    """``x`` reduced over ``axes``, in place when ``x`` is contiguous
    (pass a temporary)."""
    x = x.contiguous()
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    for a in axes:
        dist.all_reduce(x, op=red, group=a.group)
    return x


def all_gather(x: torch.Tensor, axes: Sequence[Axis],
               dim: int) -> torch.Tensor:
    """The pieces of ``axes`` concatenated along ``dim`` in mesh order:
    the inner axis first, then the outer."""
    for a in reversed(axes):
        parts = [torch.empty_like(x) for _ in range(a.size)]
        dist.all_gather(parts, x.contiguous(), group=a.group)
        x = torch.cat(parts, dim=dim)
    return x


def full_tensor(t) -> torch.Tensor:
    """The global value of a DTensor as a plain tensor (``t`` itself when
    it is plain); only sharded axes of more than one rank communicate."""
    local, sh = split(t)
    return local if sh is None else all_gather(local, sh.axes, sh.dim)
