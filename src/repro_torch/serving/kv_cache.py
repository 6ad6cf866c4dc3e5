"""Slotted KV-cache manager for continuous-batching decode.

Counterpart of ``repro.serving.kv_cache``. A fixed pool of ``n_slots``
sequences (the decode batch) over a ``max_len`` cache on the device;
requests claim a slot at admission and free it at completion. Slot
claims and frees are host-side bookkeeping; ``admit`` and ``retire``
write the slot's rows and length in place. The pool plugs into the
``kv_pool`` hook of ``Scheduler`` and ``ServingEngine``, which counts its
free slots.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.configs.base import TransformerConfig
from repro_torch.device import resolve
from repro_torch.models import transformer as T


@dataclass
class SlotAllocator:
    n_slots: int
    free: List[int] = field(default_factory=list)
    owner: Dict[int, int] = field(default_factory=dict)   # slot -> req id

    def __post_init__(self):
        self.free = list(range(self.n_slots))[::-1]

    def claim(self, request_id: int) -> Optional[int]:
        if not self.free:
            return None
        slot = self.free.pop()
        self.owner[slot] = request_id
        return slot

    def release(self, slot: int) -> None:
        if slot in self.owner:
            del self.owner[slot]
            self.free.append(slot)

    @property
    def n_active(self) -> int:
        return self.n_slots - len(self.free)


class KVCachePool:
    """Device-side cache (``T.init_kv_cache`` on ``device``) + host-side
    slot map. ``cache`` is the dict ``T.decode_step`` takes and returns:
    assign its result back to ``pool.cache`` after each step."""

    def __init__(self, cfg: TransformerConfig, n_slots: int, max_len: int,
                 device=None):
        self.cfg = cfg
        self.max_len = max_len
        self.alloc = SlotAllocator(n_slots)
        self.cache = T.init_kv_cache(cfg, n_slots, max_len,
                                     device=resolve(device))

    def admit(self, request_id: int, prompt_kv: Optional[Dict] = None,
              prompt_len: int = 0) -> Optional[int]:
        """Claim a slot and set its length to ``prompt_len``; with
        ``prompt_kv`` (a batch-1 cache from ``T.prefill``) copy its first
        ``prompt_len`` positions into the slot. None when no slot is
        free."""
        if not 0 <= prompt_len <= self.max_len:
            raise ValueError(f"prompt_len {prompt_len} outside "
                             f"[0, {self.max_len}]")
        slot = self.alloc.claim(request_id)
        if slot is None:
            return None
        self.cache["lengths"][slot] = prompt_len
        if prompt_kv is not None:
            for name in ("k", "v"):
                self.cache[name][:, slot, :prompt_len] = \
                    prompt_kv[name][:, 0, :prompt_len]
        return slot

    def retire(self, slot: int) -> None:
        self.cache["lengths"][slot] = 0
        self.alloc.release(slot)

    def active_mask(self) -> np.ndarray:
        m = np.zeros((self.alloc.n_slots,), bool)
        for slot in self.alloc.owner:
            m[slot] = True
        return m
