"""Trust DB (paper §4): a set-associative cache held in device tensors.

Counterpart of ``repro.core.trust_cache``. Eviction is oldest-age within
the set (LRU over ways). Key 0 is reserved for "empty".

Keys are uint32 values stored as **int32 tensors that hold the uint32 bit
pattern**: torch has no ``>>`` or ``%`` on uint32 on the CPU. Callers
convert numpy uint32 keys with ``.view(np.int32)``, never with a value
cast; the CUDA kernels read the same buffers as ``uint32_t*``.

Layout: ``(n_ways, n_slots)`` ways-leading by default, or the legacy
``(n_slots, n_ways)``; every op infers it from the shape (``dims``).

Functional, as the reference is: ``insert`` returns a new state and never
writes into the tensors it was given, so a caller may hold an old state
(a snapshot) by reference.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 ``x`` in [0, 2**32), without a
    product that leaves int64: the constant is split in 16-bit halves."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """splitmix32-style avalanche hash of the uint32 bit pattern in
    ``x`` (any integer dtype). Returns int64 values in [0, 2**32)."""
    x = x.to(torch.int64) & _M32
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def slots_of(keys: torch.Tensor, n_slots: int) -> torch.Tensor:
    """Set index of each key: ``_hash32(key) % n_slots`` (unsigned)."""
    return _hash32(keys) % n_slots


def dims(shape: Tuple[int, int]) -> Tuple[int, int, bool]:
    """(n_slots, n_ways, ways_leading) inferred from a cache array shape.

    The ways axis is the strictly smaller one (``init`` guarantees
    ``n_ways < n_slots``); a square shape is read as the legacy
    slots-leading layout.
    """
    a, b = shape
    if a < b:
        return b, a, True
    return a, b, False


def init(n_slots: int, n_ways: int, *, ways_leading: bool = True,
         device=None) -> Dict[str, torch.Tensor]:
    if n_ways >= n_slots:
        raise ValueError(
            f"trust cache needs n_ways < n_slots for layout inference, "
            f"got n_slots={n_slots} n_ways={n_ways}")
    shape = (n_ways, n_slots) if ways_leading else (n_slots, n_ways)
    return {
        "keys": torch.zeros(shape, dtype=torch.int32, device=device),
        "values": torch.zeros(shape, dtype=torch.float32, device=device),
        "age": torch.zeros(shape, dtype=torch.int32, device=device),
        "clock": torch.zeros((), dtype=torch.int32, device=device),
    }


def candidates(arr: torch.Tensor, slot: torch.Tensor,
               ways_leading: bool) -> torch.Tensor:
    """(N, ways) entries of each key's set in a cache array."""
    return arr[:, slot].T if ways_leading else arr[slot]


def lookup(state: Dict, keys: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """keys: (N,) int32 bit patterns -> (values (N,) f32, hit (N,) bool)."""
    n_slots, _, ways_leading = dims(state["keys"].shape)
    keys = keys.to(torch.int32)
    slot = slots_of(keys, n_slots)
    match = candidates(state["keys"], slot, ways_leading) == keys[:, None]
    hit = match.any(dim=-1) & (keys != 0)
    way = match.to(torch.int8).argmax(dim=-1)        # first matching way
    vals = candidates(state["values"], slot, ways_leading).gather(
        1, way[:, None])[:, 0]
    return torch.where(hit, vals, torch.zeros_like(vals)), hit


def insert(state: Dict, keys: torch.Tensor, values: torch.Tensor,
           mask: torch.Tensor) -> Dict:
    """Insert/update (keys, values) where ``mask``; returns a new state.

    Way choice: matching key if present (update) > empty way > oldest age,
    each decided against the state before the batch. Several writes to
    one (way, slot) within the batch resolve last-write-wins: the write
    of the latest item in the batch is kept, explicitly, because a
    scatter with duplicate indices has no order on CUDA.
    """
    n_slots, n_ways, ways_leading = dims(state["keys"].shape)
    keys = keys.to(torch.int32)
    n = keys.shape[0]
    slot = slots_of(keys, n_slots)
    cand_k = candidates(state["keys"], slot, ways_leading)     # (N, ways)
    cand_age = candidates(state["age"], slot, ways_leading)
    match = (cand_k == keys[:, None]).to(torch.int32)
    empty = (cand_k == 0).to(torch.int32)
    # priority: match (2^30) > empty (2^20) > -age (older = larger)
    prio = match * (1 << 30) + empty * (1 << 20) - cand_age
    way = prio.argmax(dim=-1)                                   # (N,)
    ok = mask.to(torch.bool) & (keys != 0)
    flat = way * n_slots + slot if ways_leading else slot * n_ways + way
    # Winner per target: the latest ok item (amax of its batch index);
    # masked items scatter -1, which changes no target.
    order = torch.arange(n, device=keys.device)
    winner = torch.full((n_slots * n_ways,), -1, dtype=torch.int64,
                        device=keys.device)
    winner.scatter_reduce_(0, torch.where(ok, flat, torch.zeros_like(flat)),
                           torch.where(ok, order, torch.full_like(order, -1)),
                           reduce="amax")
    written = winner >= 0
    src = winner.clamp(min=0)
    clock = state["clock"] + 1

    def put(old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
        if n == 0:
            return old.clone()
        return torch.where(written, new[src],
                           old.reshape(-1)).reshape(old.shape)

    return {
        "keys": put(state["keys"], keys),
        "values": put(state["values"], values.to(torch.float32)),
        "age": put(state["age"], clock.expand(n)),
        "clock": clock,
    }


def occupancy(state: Dict) -> torch.Tensor:
    return (state["keys"] != 0).to(torch.float32).mean()
