"""Ambient-mesh sharding constraints usable inside model code.

Counterpart of ``repro.distribution.constraints``. The ambient mesh is a
``contextvars.ContextVar`` set by :func:`use_mesh` (the reference's
``jax.set_mesh``). ``constrain(x, *spec)`` redistributes a DTensor to
``spec`` on that mesh; it is a no-op on a plain tensor or without a mesh,
so model code stays mesh-agnostic and smoke tests run unchanged.
:func:`shard_map` runs a function on each rank's local pieces.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Optional, Tuple

import torch

from repro_torch.distribution.placement import (NamedSharding,
                                                PartitionSpec, device_put,
                                                is_dtensor, placements_of,
                                                spec_axes)

_MESH: contextvars.ContextVar = contextvars.ContextVar("ambient_mesh",
                                                       default=None)


def ambient_mesh():
    """The mesh :func:`use_mesh` made ambient, or None."""
    return _MESH.get()


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` ambient for the ``with`` block."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def recompute_context():
    """``context_fn`` for ``torch.utils.checkpoint``: the recomputation
    in the backward pass (which may run on autograd's own thread, where
    this thread's context variables are unset) sees the ambient mesh and
    the batch split (``placement.batch_split``) of the forward."""
    from repro_torch.distribution.placement import batch_axes, batch_split
    mesh, axes = ambient_mesh(), batch_axes()

    @contextlib.contextmanager
    def again():
        with use_mesh(mesh), batch_split(axes):
            yield
    return contextlib.nullcontext(), again()


def axis_in_mesh(name: str) -> bool:
    m = ambient_mesh()
    return bool(m is not None and name in m.mesh_dim_names)


def dp_spec() -> Optional[Tuple[str, ...]]:
    m = ambient_mesh()
    if m is None:
        return None
    axes = tuple(a for a in m.mesh_dim_names if a in ("pod", "data"))
    return axes or None


def _fixed(spec, names) -> PartitionSpec:
    """``spec`` with the axis names absent from the mesh dropped to
    None."""
    fixed = []
    for s in spec:
        kept = tuple(a for a in spec_axes(s) if a in names)
        fixed.append(None if not kept
                     else kept[0] if isinstance(s, str) else kept)
    return PartitionSpec(*fixed)


def _redistribute(x, spec, mesh):
    placements = placements_of(_fixed(spec, mesh.mesh_dim_names), mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def constrain(x, *spec):
    """``x`` redistributed to ``spec`` on the ambient mesh when ``x`` is a
    DTensor (no-op otherwise, or without a mesh). Axis names absent from
    the mesh are dropped to None."""
    m = ambient_mesh()
    if m is None or not is_dtensor(x):
        return x
    return _redistribute(x, spec, m)


def _to_local(x, spec, mesh):
    if is_dtensor(x):
        return _redistribute(x, spec, mesh).to_local()
    if isinstance(x, torch.Tensor):
        return device_put(x, NamedSharding(mesh, spec)).to_local()
    return x


def shard_map(f: Callable, *, mesh, in_specs, out_specs) -> Callable:
    """``f`` run on local pieces: each argument is brought to its entry of
    ``in_specs`` (a DTensor is redistributed, a plain tensor is taken as
    the global value and cut to this rank's piece), ``f`` sees plain local
    tensors, and each output becomes a DTensor with its entry of
    ``out_specs`` (a spec, or a tuple of specs for a tuple of outputs).
    Collectives inside ``f`` are the caller's, as in the reference's
    ``shard_map``."""
    from torch.distributed.tensor import DTensor

    def run(*args):
        local = [_to_local(a, s, mesh) for a, s in zip(args, in_specs)]
        out = f(*local)
        if isinstance(out_specs, PartitionSpec):
            return DTensor.from_local(out, mesh,
                                      placements_of(out_specs, mesh),
                                      run_check=False)
        return tuple(DTensor.from_local(o, mesh, placements_of(s, mesh),
                                        run_check=False)
                     for o, s in zip(out, out_specs))
    return run
