"""Device meshes over ``torch.distributed`` ranks.

Counterpart of ``repro.launch.mesh``. A mesh is a ``DeviceMesh`` of
global ranks with the reference's axis names; each rank drives one
device. ``make_production_mesh`` is (data=16, model=16), or (pod=2,
data=16, model=16) with ``multi_pod``, and needs a process group of that
many ranks. ``make_host_mesh`` is a small mesh for tests and smoke runs:
one H100 is the (1, 1) mesh of a world of one, which it creates itself
(from a ``HashStore``: no network port) when no process group exists.
Multi-rank meshes come from a caller's ``init_process_group`` (the CPU
tests use gloo ranks with a ``FileStore``). Importing this module
creates no group and touches no device.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import resolve


def world_size() -> int:
    """Ranks in the default process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def init_world(device=None) -> None:
    """The default process group of this one process on ``device``
    (``cuda`` unless named): NCCL on the card, gloo on the CPU, from an
    in-process ``HashStore``. A group of one runs no collective (see
    ``distribution.placement``), so NCCL never opens a communicator."""
    dev = resolve(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)   # the device NCCL would use
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)


def destroy_world() -> None:
    """Destroy the default process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def mesh_from_devices(devices: Sequence[int], shape: Tuple[int, ...],
                      axes: Tuple[str, ...], device=None) -> DeviceMesh:
    """A mesh of the global ranks ``devices``, laid out row-major in
    ``shape`` with axis names ``axes``, on ``device``'s type."""
    ranks = torch.as_tensor(np.asarray(list(devices), np.int64)
                            ).reshape(shape)
    return DeviceMesh(resolve(device).type, ranks,
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    if world_size() < n:
        raise ValueError(f"the production mesh {shape} needs a process "
                         f"group of {n} ranks, have {world_size()}")
    return mesh_from_devices(range(n), shape, axes, device)


def make_host_mesh(shape: Tuple[int, ...] = (1, 1),
                   axes: Tuple[str, ...] = ("data", "model"),
                   device=None) -> DeviceMesh:
    """Small mesh over the ranks that exist (tests/smoke). With no
    process group and one device asked for, it creates the world of one
    (:func:`init_world`); the caller ends it with
    :func:`destroy_world`."""
    dev = resolve(device)
    n = int(np.prod(shape))
    if not dist.is_initialized() and n == 1:
        init_world(dev)
    if world_size() < n:
        raise ValueError(f"need {n} devices, have {world_size()}")
    return mesh_from_devices(range(n), shape, axes, dev)
