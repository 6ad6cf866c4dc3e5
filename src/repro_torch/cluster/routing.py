"""Consistent-hash tenant routing: tenants -> replica shards.

Counterpart of ``repro.cluster.routing`` (host logic, copied).

Weighted-virtual-node consistent hashing (the Dynamo/Cassandra ring,
the standard answer vertical-search capacity planning gives for
balancing per-replica load): every replica owns
``round(weight * vnodes_per_weight)`` points on a 64-bit ring, a tenant
routes to the first replica point clockwise from the tenant's own hash.

Properties the cluster relies on (property-tested in
``tests/test_cluster.py``):

* **deterministic** — hashing is ``md5`` over stable strings, so the
  same membership maps the same tenants to the same replicas in every
  process, with no coordination;
* **minimal rebalancing** — removing a replica deletes only its own
  points: tenants previously routed to *other* replicas keep their
  mapping (only the removed replica's tenants remap, to the next point
  clockwise). Joins are symmetric;
* **weighted** — a replica with twice the weight owns ~twice the ring
  arc, hence ~twice the tenants in expectation.

``route_chain`` returns the first ``k`` *distinct* replicas clockwise —
the primary plus the backups hedged dispatch races against.

Elastic membership (runtime join/leave) adds two facilities:

* **fencing** — ``fence(replica_id)`` excludes a replica from every
  route/chain WITHOUT deleting its points: new traffic flows to the
  next point clockwise (exactly where a removal would send it) while
  the fenced replica drains, and ``unfence`` restores the original
  mapping bit for bit. A leaving replica is fenced first so the
  drain-and-handoff never races fresh arrivals.
* **remap diff** — ``remap_diff(tenants, remove=..., add=...)`` plans a
  membership change: the exact ``{tenant: (old_owner, new_owner)}`` set
  a join/leave would disturb, computed without mutating live state
  (points are deterministic, so apply-then-restore is exact).
"""
from __future__ import annotations

import bisect
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple


def stable_hash(s: str) -> int:
    """64-bit position on the ring; md5 so it is stable across
    processes and Python hash randomization."""
    return int.from_bytes(hashlib.md5(s.encode()).digest()[:8], "big")


class ConsistentHashRing:
    def __init__(self, vnodes_per_weight: int = 64):
        if vnodes_per_weight <= 0:
            raise ValueError("vnodes_per_weight must be positive")
        self.vnodes_per_weight = int(vnodes_per_weight)
        self.weights: Dict[str, float] = {}
        self.fenced: set = set()                    # ids excluded from routing
        self._points: List[Tuple[int, str]] = []    # sorted (hash, id)
        self._keys: List[int] = []                  # parallel hash keys

    def __len__(self) -> int:
        return len(self.weights)

    def __contains__(self, replica_id: str) -> bool:
        return replica_id in self.weights

    @property
    def replica_ids(self) -> List[str]:
        return sorted(self.weights)

    def _vnode_count(self, weight: float) -> int:
        return max(1, round(weight * self.vnodes_per_weight))

    def _rebuild_keys(self) -> None:
        self._keys = [h for h, _ in self._points]

    def add(self, replica_id: str, weight: float = 1.0) -> None:
        """Join: inserts only this replica's points (deterministic —
        every point is ``md5(id#vnode)`` — so rebalancing is identical
        no matter the join order)."""
        if weight <= 0:
            raise ValueError("replica weight must be positive")
        if replica_id in self.weights:
            raise ValueError(f"replica {replica_id!r} already on ring")
        self.weights[replica_id] = float(weight)
        for v in range(self._vnode_count(weight)):
            h = stable_hash(f"{replica_id}#{v}")
            bisect.insort(self._points, (h, replica_id))
        self._rebuild_keys()

    def remove(self, replica_id: str) -> None:
        """Leave: deletes only this replica's points, so only its
        tenants remap."""
        if replica_id not in self.weights:
            raise KeyError(replica_id)
        del self.weights[replica_id]
        self.fenced.discard(replica_id)
        self._points = [(h, r) for h, r in self._points
                        if r != replica_id]
        self._rebuild_keys()

    # -- fencing (elastic membership) ---------------------------------------
    def fence(self, replica_id: str) -> None:
        """Exclude ``replica_id`` from routing without touching its
        points: tenants flow to the next point clockwise — exactly the
        owners a removal would pick — while the replica drains."""
        if replica_id not in self.weights:
            raise KeyError(replica_id)
        self.fenced.add(replica_id)

    def unfence(self, replica_id: str) -> None:
        """Restore a fenced replica to routing (mapping returns to the
        pre-fence assignment exactly — the points never moved)."""
        self.fenced.discard(replica_id)

    @property
    def routable_ids(self) -> List[str]:
        return sorted(r for r in self.weights if r not in self.fenced)

    def route(self, tenant: str) -> str:
        """First unfenced replica point clockwise from the tenant's
        hash."""
        chain = self.route_chain(tenant, 1)
        if not chain:
            raise RuntimeError("ring has no routable replicas")
        return chain[0]

    def route_chain(self, tenant: str, k: int) -> List[str]:
        """First ``k`` *distinct* unfenced replicas clockwise:
        ``[primary, backup, ...]``. Shorter when fewer than ``k``
        routable replicas exist."""
        if not self._points:
            return []
        k = min(k, len(self.weights) - len(self.fenced))
        start = bisect.bisect_right(self._keys, stable_hash(tenant))
        chain: List[str] = []
        n = len(self._points)
        for i in range(n):
            _, rid = self._points[(start + i) % n]
            if rid not in chain and rid not in self.fenced:
                chain.append(rid)
                if len(chain) == k:
                    break
        return chain

    def backup_for(self, tenant: str) -> Optional[str]:
        """The hedge target: next distinct replica after the primary
        (None with a single replica — hedging degenerates away)."""
        chain = self.route_chain(tenant, 2)
        return chain[1] if len(chain) > 1 else None

    def sibling_for(self, key: str, *,
                    exclude: Sequence[str] = ()) -> Optional[str]:
        """First distinct unfenced replica clockwise from ``key`` that
        is not in ``exclude`` — where selective stripe replication
        places a slow shard's mirror (the same clockwise walk a
        removal of the excluded owner would route the key to)."""
        skip = set(exclude)
        for rid in self.route_chain(key, len(self.weights)):
            if rid not in skip:
                return rid
        return None

    def assignments(self, tenants: Sequence[str]) -> Dict[str, str]:
        """tenant -> replica map for a batch of tenants (observability
        and rebalance planning)."""
        return {t: self.route(t) for t in tenants}

    def remap_diff(self, tenants: Sequence[str], *,
                   remove: Optional[str] = None,
                   add: Optional[Tuple[str, float]] = None
                   ) -> Dict[str, Tuple[str, str]]:
        """Plan a membership change without committing it.

        Returns ``{tenant: (old_owner, new_owner)}`` for exactly the
        tenants whose owner WOULD change if ``remove`` (a replica id)
        left and/or ``add`` (an ``(id, weight)`` pair) joined. Points
        are deterministic (md5 of stable strings), so the hypothetical
        membership is applied and rolled back exactly; fencing state is
        preserved."""
        if remove is None and add is None:
            return {}
        # Validate BEFORE mutating: a failed hypothetical apply must
        # leave the live ring untouched.
        if remove is not None and remove not in self.weights:
            raise KeyError(remove)
        if add is not None and add[0] in self.weights \
                and add[0] != remove:
            raise ValueError(f"replica {add[0]!r} already on ring")
        before = self.assignments(tenants)
        removed_weight = None
        removed_fenced = False
        if remove is not None:
            removed_weight = self.weights[remove]
            removed_fenced = remove in self.fenced
            self.remove(remove)
        if add is not None:
            self.add(*add)
        after = self.assignments(tenants)
        if add is not None:
            self.remove(add[0])
        if remove is not None:
            self.add(remove, removed_weight)
            if removed_fenced:
                self.fenced.add(remove)
        return {t: (before[t], after[t]) for t in tenants
                if after[t] != before[t]}
