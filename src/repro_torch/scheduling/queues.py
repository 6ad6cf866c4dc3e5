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
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

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

    def pop_back(self, cost_fn: Optional[Callable] = None,
                 max_candidates: int = 8) -> Optional[QueuedRequest]:
        """Remove a non-head entry for a thief — the work-stealing
        primitive. Never touches the head, so the victim's EDF drain
        order is unchanged for every request that remains.

        Without ``cost_fn``: the entry with the LATEST deadline leaves
        (with >= 2 entries the max-key entry is never the min-key
        head). With ``cost_fn(qreq) -> float`` (cost-aware stealing):
        the HIGHEST-cost entry among the ``max_candidates`` LATEST-
        deadline non-head entries leaves — stealing a cache-cold
        request moves real work to the idle sibling, where stealing a
        cache-hot one would displace cold work only to re-evaluate warm
        items on a cold cache. Scoring is bounded to the back region
        because each cost probe may be a device lookup; deadline breaks
        ties (latest first), so ``cost_fn=None`` and a constant cost_fn
        pick identically.
        """
        if not self._heap:
            return None
        if cost_fn is None:
            i = max(range(len(self._heap)),
                    key=lambda j: self._heap[j][:2])
        else:
            head_j = min(range(len(self._heap)),
                         key=lambda j: self._heap[j][:2]) \
                if len(self._heap) > 1 else None
            back = heapq.nlargest(
                max(max_candidates, 1),
                (j for j in range(len(self._heap)) if j != head_j),
                key=lambda j: self._heap[j][:2])
            i = max(back, key=lambda j: (cost_fn(self._heap[j][2]),) +
                    self._heap[j][:2])
        _, _, qreq = self._heap[i]
        last = self._heap.pop()
        if i < len(self._heap):
            self._heap[i] = last
            heapq.heapify(self._heap)
        self.n_items -= qreq.n_items
        return qreq


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

    def steal_back(self, min_leave: int = 1,
                   cost_fn: Optional[Callable] = None
                   ) -> Optional[QueuedRequest]:
        """Pop from the back of the lowest-importance non-empty class.

        Victim-side work stealing: least-important work leaves first,
        and a class is only robbed while more than ``min_leave``
        entries remain — with the default of 1 the head of every class
        stays in place, so the victim's EDF drain order is never
        reordered by a steal. Within the robbed class, ``cost_fn``
        (estimated evaluation cost, e.g. items x Trust-DB miss
        probability on the victim) selects WHICH non-head entry leaves
        — cache-cold work migrates, cache-hot work stays where its
        cache is warm; without it the latest-deadline back entry leaves
        (the original policy, and the tie-break either way).

        The CRITICAL queue is never robbed: it is next to drain here
        anyway, and it may hold escalated hedge twins (entries whose
        ``priority`` is their ORIGINAL class) — a thief re-pushing one
        via ``push`` would silently demote it out of escalation.
        """
        for p in reversed(list(Priority)):
            if p is Priority.CRITICAL:
                continue
            q = self.queues[p]
            if len(q) > min_leave:
                return q.pop_back(cost_fn=cost_fn)
        return None
