"""Fused Trust-DB probe + load-shedding tier assignment (paper §5).

Counterpart of ``repro.kernels.shed_partition``: for a stream of N
candidate URLs, (1) probe the Trust DB, (2) split Normal/Drop queues by
arrival position vs Ucapacity, (3) grant drop-queue evaluation slots up
to the deadline budget, (4) everything else falls to the prior. Outputs
per item: tier code, cached value, and the compacted eval rank.

``shed_partition`` launches the hand-written CUDA kernel
(``csrc/shed_partition.cu``) for CUDA tensors and takes the plain
version ``shed_partition_ref`` only for CPU tensors. Any N is accepted,
0 and ragged sizes included; there is no padding rule.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core import trust_cache as TC
from repro_torch.core.shedder import (TIER_CACHED, TIER_EVAL, TIER_INVALID,
                                      TIER_PRIOR)
from repro_torch.kernels._build import (fake_launch, is_fake,
                                        library_function, refuse_grad)

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def shed_partition_ref(keys: torch.Tensor, valid: torch.Tensor,
                       cache_keys: torch.Tensor, cache_values: torch.Tensor,
                       u_capacity: int, u_threshold: int, budget: int,
                       budget_is_total: bool = False) -> Outputs:
    """Plain version = ``trust_cache.lookup`` + the tier scans (the
    reference's ``kernels.ref.shed_partition_ref``).

    ``budget`` is the drop-queue eval budget, or with ``budget_is_total``
    the total eval budget from which the normal-queue evaluations are
    netted out."""
    state = {"keys": cache_keys, "values": cache_values}
    vals, hit = TC.lookup(state, keys)
    valid = valid.to(torch.bool)
    hit = hit & valid
    v32 = valid.to(torch.int32)
    pos = torch.cumsum(v32, 0) - v32
    in_normal = valid & (pos < u_capacity)
    tier = torch.where(hit, TIER_CACHED, TIER_PRIOR)
    tier = torch.where(in_normal & ~hit, TIER_EVAL, tier)
    dq = valid & ~in_normal & ~hit
    d32 = dq.to(torch.int32)
    rank = torch.cumsum(d32, 0) - d32
    if budget_is_total:
        n_normal_evals = (in_normal & ~hit).to(torch.int32).sum()
        budget_dq = torch.clamp(budget - n_normal_evals, min=0)
    else:
        budget_dq = budget
    tier = torch.where(dq & (rank < budget_dq), TIER_EVAL, tier)
    tier = torch.where(valid, tier, TIER_INVALID)
    is_eval = tier == TIER_EVAL
    e32 = is_eval.to(torch.int32)
    erank = torch.where(is_eval, torch.cumsum(e32, 0) - e32, -1)
    return (tier.to(torch.int32),
            torch.where(hit, vals, torch.zeros_like(vals)),
            erank.to(torch.int32))


def _check(keys, valid, cache_keys, cache_values) -> None:
    dev = keys.device
    for name, t, dtype in (("keys", keys, torch.int32),
                           ("valid", valid, torch.bool),
                           ("cache_keys", cache_keys, torch.int32),
                           ("cache_values", cache_values, torch.float32)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, keys on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if keys.dim() != 1 or valid.shape != keys.shape:
        raise ValueError(f"keys and valid must be (N,), got "
                         f"{tuple(keys.shape)} and {tuple(valid.shape)}")
    if cache_keys.dim() != 2 or cache_values.shape != cache_keys.shape:
        raise ValueError("cache keys and values must share one 2-D shape")
    if cache_keys.numel() >= 2 ** 32:
        raise ValueError("the kernel addresses the cache with 32-bit "
                         "offsets: at most 2**32 - 1 entries")


def cost(n: int, way_reads: int, hits: int):
    """(operations, bytes) of one call on ``n`` items: keys and flags
    read (5 B an item), three outputs written (12 B), and for each probed
    item its set's way keys up to its hit (``way_reads`` keys in all,
    every way on a miss) and each hit's value. Its work is loads and
    compares: no arithmetic is counted."""
    return 0, 17 * n + 4 * (way_reads + hits)


def shed_partition(keys: torch.Tensor, valid: torch.Tensor,
                   cache_keys: torch.Tensor, cache_values: torch.Tensor,
                   u_capacity: int, u_threshold: int, budget: int, *,
                   budget_is_total: bool = False) -> Outputs:
    """keys: (N,) int32 holding uint32 bit patterns; valid: (N,) bool;
    cache_*: (ways, slots) ways-leading or legacy (slots, ways), int32
    bit patterns and float32 (layout from the shape,
    ``trust_cache.dims``). Scalars are host ints.

    Returns (tier (N,) int32, cached_vals (N,) f32, eval_rank (N,)
    int32). CUDA tensors launch the kernel (counted in
    ``shed_partition.launches``); CPU tensors take the plain version.
    """
    _check(keys, valid, cache_keys, cache_values)
    if keys.device.type == "cpu" and not is_fake(keys):
        return shed_partition_ref(keys, valid, cache_keys, cache_values,
                                  u_capacity, u_threshold, budget,
                                  budget_is_total)
    if keys.device.type != "cuda" and not is_fake(keys):
        raise ValueError(f"shed_partition runs on cuda or cpu, "
                         f"not {keys.device}")
    refuse_grad("shed_partition", cache_values)
    n = keys.shape[0]
    n_slots, n_ways, ways_leading = TC.dims(tuple(cache_keys.shape))
    if is_fake(keys, valid, cache_keys, cache_values):
        # the probes are data: a trace counts every item probed, every
        # way read and a hit's value
        fake_launch("shed_partition", *cost(n, n * n_ways, n))
        return (torch.empty(n, dtype=torch.int32, device=keys.device),
                torch.empty(n, dtype=torch.float32, device=keys.device),
                torch.empty(n, dtype=torch.int32, device=keys.device))
    fn = library_function(
        "shed_partition", "shed_partition_launch",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 4)
    tier = torch.empty(n, dtype=torch.int32, device=keys.device)
    cval = torch.empty(n, dtype=torch.float32, device=keys.device)
    rank = torch.empty(n, dtype=torch.int32, device=keys.device)
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    err = fn(keys.data_ptr(), valid.data_ptr(), cache_keys.data_ptr(),
             cache_values.data_ptr(), n, n_slots, n_ways, int(ways_leading),
             int(u_capacity), int(budget), int(budget_is_total),
             tier.data_ptr(), cval.data_ptr(), rank.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"shed_partition kernel launch failed: "
                           f"cudaError {err}")
    shed_partition.launches += 1
    return tier, cval, rank


shed_partition.launches = 0
