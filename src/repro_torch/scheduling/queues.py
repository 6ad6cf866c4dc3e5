"""Earliest-deadline-first queues with static-capacity backpressure.

Counterpart of ``repro.scheduling.queues`` (host logic, copied).

One EDF heap per priority class. Within a class the request whose
*absolute deadline* (arrival + SLO) expires soonest is drained first —
the ordering that minimizes deadline misses for a work-conserving
server; across classes drain order is strict priority (CRITICAL before
HIGH before NORMAL before LOW).

Capacity is static (requests per class). ``push`` returns ``False``
when the class queue is full — callers turn that into an explicit
``queue_full`` rejection response, never a silent drop.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Tuple

from repro_torch.scheduling.priorities import Priority


@dataclass
class QueuedRequest:
    """A request waiting for batch capacity.

    ``request`` is the engine-level ``Request`` (items + features);
    ``deadline_t`` is absolute (arrival + SLO) — the EDF key.
    """
    request: Any
    priority: Priority
    tenant: str
    deadline_t: float
    enqueue_t: float
    hedged: bool = False
    n_hedges: int = 0         # times this request has been re-dispatched
    last_hedge_t: Optional[float] = None    # when the last twin launched

    @property
    def hedge_wait_base_t(self) -> float:
        """Re-hedges wait a full hedge interval since the LAST dispatch,
        not since enqueue (else every scan past the threshold fires)."""
        return (self.enqueue_t if self.last_hedge_t is None
                else self.last_hedge_t)

    def dispatch_twin(self, crit_push, fire_t: float) -> bool:
        """Escalate a hedge copy of this request via ``crit_push`` (a
        CRITICAL queue's ``push``); on success mark THIS entry hedged
        and stamp the dispatch time. Shared by engine-internal and
        cluster hedging so the twin bookkeeping cannot diverge."""
        twin = QueuedRequest(
            request=self.request, priority=self.priority,
            tenant=self.tenant, deadline_t=self.deadline_t,
            enqueue_t=self.enqueue_t, hedged=True,
            n_hedges=self.n_hedges + 1, last_hedge_t=fire_t)
        if not crit_push(twin):
            return False
        self.hedged = True
        self.n_hedges += 1
        self.last_hedge_t = fire_t
        return True

    @property
    def n_items(self) -> int:
        return int(len(self.request.item_keys))


class EDFQueue:
    """Bounded min-heap keyed by absolute deadline (FIFO tie-break)."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._heap: List[Tuple[float, int, QueuedRequest]] = []
        self._seq = itertools.count()
        self.n_items = 0          # queued candidate items (load estimate)

    def __len__(self) -> int:
        return len(self._heap)

    def push(self, qreq: QueuedRequest) -> bool:
        if len(self._heap) >= self.capacity:
            return False
        heapq.heappush(self._heap,
                       (qreq.deadline_t, next(self._seq), qreq))
        self.n_items += qreq.n_items
        return True

    def pop(self) -> Optional[QueuedRequest]:
        if not self._heap:
            return None
        _, _, qreq = heapq.heappop(self._heap)
        self.n_items -= qreq.n_items
        return qreq

    def peek(self) -> Optional[QueuedRequest]:
        return self._heap[0][2] if self._heap else None

    def fill_frac(self) -> float:
        return len(self._heap) / max(self.capacity, 1)

    def entries(self) -> Iterator[QueuedRequest]:
        """Heap-order iteration (NOT sorted); for scans, not draining."""
        return (q for _, _, q in self._heap)


class PriorityQueueBank:
    """Strict-priority bank of per-class EDF queues."""

    def __init__(self, capacity_per_class: int):
        self.queues: Dict[Priority, EDFQueue] = {
            p: EDFQueue(capacity_per_class) for p in Priority}

    def __len__(self) -> int:
        return sum(len(q) for q in self.queues.values())

    @property
    def n_items(self) -> int:
        return sum(q.n_items for q in self.queues.values())

    def push(self, qreq: QueuedRequest) -> bool:
        return self.queues[qreq.priority].push(qreq)

    def pop_next(self) -> Optional[QueuedRequest]:
        """Highest-priority class first; EDF within the class."""
        for p in Priority:
            q = self.queues[p].pop()
            if q is not None:
                return q
        return None

    def peek_next(self) -> Optional[QueuedRequest]:
        for p in Priority:
            head = self.queues[p].peek()
            if head is not None:
                return head
        return None

    def fill_frac(self, priority: Priority) -> float:
        return self.queues[priority].fill_frac()
