"""Heap-indexed hot/cold replica tracking for fleet scans.

Counterpart of ``repro.cluster.loadindex`` (host logic, copied).

The coordinator's steal loop used to re-sort EVERY replica by queue
depth on EVERY steal iteration — O(steals x n log n) per drain round,
which at the ROADMAP's 32-64 replica fleet sizes makes the rebalance
scan itself a per-round cost comparable to a micro-batch. Each steal
only changes TWO replicas' loads (the donor and the receiver), so the
ordering is a textbook priority-queue workload:

* build once per round from the polled queue depths (O(n) heapify),
* read the coldest/hottest replica in O(1),
* update the two touched replicas in O(log n) per steal,
* keep serving autoscale victim picks and hedge-scan skips from the
  same index for the rest of the round.

Implemented as a lazy-deletion double heap (one min-heap, one
max-heap over the same load map): ``update`` pushes a fresh entry and
leaves the stale one in place; reads pop until the top entry matches
the live load map. Every entry is pushed at most once per update, so
the amortized cost stays O(log n) and no rebalancing pass exists.

Tie-breaking matches the ``sorted(..., key=(queued_items,
replica_id))`` order the scans used before — coldest = smallest
(load, id), hottest = largest (load, id) — so replacing the sorts
changes complexity, never behaviour.
"""
from __future__ import annotations

import heapq
from typing import Dict, Iterable, List, Optional, Tuple


class _RevStr:
    """String wrapper with inverted ordering, so the max-heap breaks
    load ties toward the LARGEST replica id — exactly the replica the
    old ``sorted(...)[-1]`` scan picked."""

    __slots__ = ("s",)

    def __init__(self, s: str) -> None:
        self.s = s

    def __lt__(self, other: "_RevStr") -> bool:
        return other.s < self.s

    def __eq__(self, other: object) -> bool:
        return isinstance(other, _RevStr) and self.s == other.s


class ReplicaLoadHeap:
    """Lazy-deletion min/max heap over ``{replica_id: load}``."""

    def __init__(self, loads: Optional[Dict[str, int]] = None) -> None:
        self._load: Dict[str, int] = dict(loads or {})
        self._minh: List[Tuple[int, str]] = [
            (ld, rid) for rid, ld in self._load.items()]
        self._maxh: List[Tuple[int, _RevStr]] = [
            (-ld, _RevStr(rid)) for rid, ld in self._load.items()]
        heapq.heapify(self._minh)
        heapq.heapify(self._maxh)

    def __len__(self) -> int:
        return len(self._load)

    def __contains__(self, rid: str) -> bool:
        return rid in self._load

    def load_of(self, rid: str) -> int:
        return self._load[rid]

    def update(self, rid: str, load: int) -> None:
        """Set ``rid``'s load (also inserts unseen ids): O(log n)."""
        load = int(load)
        if self._load.get(rid) == load:
            return
        self._load[rid] = load
        heapq.heappush(self._minh, (load, rid))
        heapq.heappush(self._maxh, (-load, _RevStr(rid)))

    def remove(self, rid: str) -> None:
        """Forget a departed replica (stale heap entries decay lazily)."""
        self._load.pop(rid, None)

    def coldest(self) -> Optional[Tuple[str, int]]:
        """(replica_id, load) with the smallest (load, id), or None."""
        while self._minh:
            ld, rid = self._minh[0]
            if self._load.get(rid) == ld:
                return rid, ld
            heapq.heappop(self._minh)       # stale: superseded/removed
        return None

    def hottest(self) -> Optional[Tuple[str, int]]:
        """(replica_id, load) with the largest (load, id), or None."""
        while self._maxh:
            negld, rev = self._maxh[0]
            if self._load.get(rev.s) == -negld:
                return rev.s, -negld
            heapq.heappop(self._maxh)
        return None

    def gap(self) -> int:
        """hottest load - coldest load (0 when fewer than 2 replicas)."""
        hot, cold = self.hottest(), self.coldest()
        if hot is None or cold is None:
            return 0
        return hot[1] - cold[1]
