"""Cross-request micro-batching: coalesce queued candidate sets into one

Counterpart of ``repro.scheduling.batcher``: host packing copied;
``to_fused_inputs`` returns torch tensors on a given device.
padded, budget-shaped batch.

The synchronous engine paid per-request overhead — one Trust-DB probe,
one cache insert, one prior update, and a partially-filled evaluator
chunk per request. The batcher amortizes all four: requests are popped
from the priority bank (strict priority, EDF within class) and packed
back-to-back into arrays of a *static* ``capacity_items`` length, so

  * the packed batch feeds ``LoadShedder.process`` (host path) or
    ``FusedLoadShedder`` (one device step, via :func:`to_fused_inputs`)
    as a single shedding decision,
  * array shapes are identical across drains — one shape set on the
    device, whatever the fill.

Packing stops at the first queued request that does not fit the
remaining budget (no reordering past the head — preserves priority/EDF
order). A single request larger than the budget is emitted alone,
padded to the next multiple of ``capacity_items`` (shape set stays
bounded: one shape per jumbo multiple ever seen).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.shedder import keys_as_int32
from repro_torch.device import resolve
from repro_torch.scheduling.queues import PriorityQueueBank, QueuedRequest
from repro_torch.tracing import traced


class BatchRecord:
    """What one micro-batch went through, kept while a profiler runs
    (``tracing.enabled``) for the serving path's per-layer readings.
    Stamps are ``time.monotonic`` seconds: ``formed`` (the batcher packed
    it), ``staged`` (its host->device copies enqueued), ``dispatched``
    (its step launched), ``ready`` (the host first saw the step complete:
    an ``is_ready`` poll, or the end of the blocking copy) and
    ``answered`` (its responses handed back). ``enqueued`` holds each
    request's ``arrival_s``, in ``request_ids`` order. ``n_evaluated``
    counts the step's evaluated items; ``max_evals`` (the evaluator's
    rows) and ``device_ms`` (the step's time on the device between two
    CUDA events) are a fused step's and stay None on a path that has no
    such thing (the host chunk loop, the CPU); a rescued batch fills none
    of the three."""

    _LATER = ("staged", "dispatched", "ready", "answered", "max_evals",
              "n_evaluated", "device_ms")
    __slots__ = ("batch_id", "request_ids", "enqueued", "formed") + _LATER

    def __init__(self, batch_id: int, request_ids: Tuple[int, ...],
                 enqueued: Tuple[float, ...]):
        self.batch_id = batch_id
        self.request_ids = request_ids
        self.enqueued = enqueued
        self.formed = time.monotonic()
        for k in self._LATER:
            setattr(self, k, None)

    def note_dispatch(self, handle) -> None:
        """The step is launched (a fused handle names its row count)."""
        self.dispatched = time.monotonic()
        if self.staged is None:                 # nothing staged apart
            self.staged = self.dispatched
        self.max_evals = getattr(handle, "max_evals", None)

    def note_result(self, handle, shed) -> None:
        """The step has landed: when the host first saw it complete, its
        evaluated items and its device time."""
        self.ready = getattr(handle, "wall_ready", None) or time.monotonic()
        self.n_evaluated = int(shed.n_evaluated)
        device_ms = getattr(handle, "device_ms", None)
        try:
            self.device_ms = device_ms() if device_ms is not None else None
        except RuntimeError:                    # an event never recorded
            self.device_ms = None

    def as_dict(self) -> Dict:
        return {k: getattr(self, k) for k in self.__slots__}


@dataclass
class MicroBatch:
    """A packed, padded batch. Valid items occupy the prefix
    ``[:n_valid]``; ``segments`` maps every row to its position in
    ``slices`` (-1 for padding)."""
    item_keys: np.ndarray               # (B,) uint32
    buckets: np.ndarray                 # (B,) int32
    features: Dict[str, np.ndarray]     # leading dim B
    valid: np.ndarray                   # (B,) bool
    segments: np.ndarray                # (B,) int32
    slices: List[Tuple[QueuedRequest, int, int]]   # (qreq, start, length)
    batch_id: Optional[int] = None         # set by the scheduler
    record: Optional[BatchRecord] = None   # the same, while tracing

    @property
    def capacity(self) -> int:
        return int(self.item_keys.shape[0])

    @property
    def n_valid(self) -> int:
        return int(self.valid.sum())


def _pad_rows(a: np.ndarray, n_pad: int) -> np.ndarray:
    if n_pad == 0:
        return a
    pad = np.zeros((n_pad,) + a.shape[1:], a.dtype)
    return np.concatenate([a, pad], axis=0)


class MicroBatcher:
    def __init__(self, capacity_items: int):
        if capacity_items <= 0:
            raise ValueError("capacity_items must be positive")
        self.capacity_items = int(capacity_items)

    @staticmethod
    def _needs_kv_slot(qreq: QueuedRequest) -> bool:
        return bool(getattr(qreq.request, "needs_kv_slot", False))

    @traced("batcher.form")
    def form(self, bank: PriorityQueueBank,
             kv_free: Optional[int] = None) -> Optional[MicroBatch]:
        """Pop whole requests from ``bank`` until the budget is full (or
        the next head does not fit). Returns None when the bank is empty.

        ``kv_free`` is the number of claimable ``KVCachePool`` slots: a
        decode request (``request.needs_kv_slot``) consumes one from the
        budget, and when none remain the head *stays queued* instead of
        occupying batch capacity it cannot use (packing stops there —
        never reorders past the head). ``None`` disables the check.
        """
        head = bank.peek_next()
        if head is None:
            return None
        if kv_free is not None and kv_free <= 0 \
                and self._needs_kv_slot(head):
            return None    # queueable but not batchable: no slot to claim

        picked: List[QueuedRequest] = []
        cap = self.capacity_items
        if head.n_items > cap:
            # Jumbo request: ship alone, padded to a capacity multiple.
            picked.append(bank.pop_next())
            cap = -(-head.n_items // self.capacity_items) \
                * self.capacity_items
        else:
            used = 0
            while True:
                head = bank.peek_next()
                if head is None or used + head.n_items > cap:
                    break
                if kv_free is not None and kv_free <= 0 \
                        and self._needs_kv_slot(head):
                    break     # slotless decode head: stays queued
                picked.append(bank.pop_next())
                used += picked[-1].n_items
                if kv_free is not None \
                        and self._needs_kv_slot(picked[-1]):
                    kv_free -= 1

        slices: List[Tuple[QueuedRequest, int, int]] = []
        start = 0
        for q in picked:
            slices.append((q, start, q.n_items))
            start += q.n_items
        n_valid = start

        keys = _pad_rows(np.concatenate(
            [np.asarray(q.request.item_keys, np.uint32)
             for q in picked]), cap - n_valid)
        buckets = _pad_rows(np.concatenate(
            [np.asarray(q.request.buckets, np.int32)
             for q in picked]), cap - n_valid)
        feat_keys = picked[0].request.features.keys()
        features = {
            k: _pad_rows(np.concatenate(
                [np.asarray(q.request.features[k]) for q in picked]),
                cap - n_valid)
            for k in feat_keys}
        valid = np.zeros((cap,), bool)
        valid[:n_valid] = True
        segments = np.full((cap,), -1, np.int32)
        for si, (_, s, ln) in enumerate(slices):
            segments[s:s + ln] = si
        return MicroBatch(item_keys=keys, buckets=buckets,
                          features=features, valid=valid,
                          segments=segments, slices=slices)


def to_fused_inputs(batch: MicroBatch, device=None):
    """Device-ready tensors of a micro-batch: ``(item_keys, buckets,
    valid, features)`` on ``device`` (``cuda`` unless named), shapes
    static at ``batch.capacity``. Keys are the uint32 bit patterns as
    int32, the layout the port's Trust DB and kernels take."""
    dev = resolve(device)

    def put(a):
        return torch.as_tensor(a).to(dev)

    return (put(keys_as_int32(batch.item_keys)),
            put(np.asarray(batch.buckets, np.int32)),
            put(np.asarray(batch.valid, bool)),
            {k: put(v) for k, v in batch.features.items()})
