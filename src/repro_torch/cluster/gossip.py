"""Cross-replica Trust-DB gossip: cache-fill deltas on a bounded budget.

Counterpart of ``repro.cluster.gossip`` (host logic, copied).

Every replica evaluates, caches, and calibrates independently
(``cluster.replica``) — which means a correlated flood (the same hot
URLs arriving at many tenants at once) pays one full trust evaluation
PER replica for every hot URL. This module closes the ROADMAP open item
with the cheapest coordination that helps: when a replica's shedder
*freshly evaluates* a URL (a Trust-DB cache fill — the only moment new
information exists), it publishes the ``(url_key, trust)`` delta to a
coordinator-owned bus; once per drain round the bus broadcasts the
freshest deltas to every *other* replica's Trust-DB, so the next
replica to see that URL answers from cache (``TIER_CACHED``) instead of
re-evaluating.

Design constraints, in load-shedding spirit:

* **bounded budget** — at most ``budget_items_per_round`` ``(key,
  value)`` pairs are broadcast per drain round; overflow deltas are
  DROPPED (and counted), never queued unboundedly. Gossip is an
  optimization, not a correctness dependency: a dropped delta only
  costs a duplicate evaluation later.
* **generation-stamped** — each publish carries a monotonically
  increasing generation; a delta that is no longer the newest value for
  its key (a slower replica's stale re-evaluation, an out-of-order
  arrival) is dropped at broadcast time instead of overwriting fresher
  trust.
* **no echo** — deltas are never delivered back to their origin
  replica, and deliveries insert straight into sibling Trust-DB caches
  (``TC.insert``) without re-triggering the shed tap, so gossip cannot
  loop.

The bus is a coordinator-local object standing in for the lightweight
UDP/membership-protocol fanout a multi-host deployment would use; the
budget and staleness rules are the part that transfers.

Two delivery modes (``mode=``):

* ``"broadcast"`` (default, the original behaviour) — every kept delta
  reaches every non-origin replica in the same round. Exact and
  instant, but the per-round message count is ``deltas x (n-1)`` —
  an O(n^2) wall that caps fleet size (48 replicas = 47 messages per
  delta per round).
* ``"epidemic"`` — peer-sampled push + anti-entropy pull. Each kept
  delta is pushed to ``ceil(log2 n)`` deterministically sampled
  non-origin peers, and once per round every replica pulls from ONE
  sampled peer the recent deltas that peer holds and it lacks (the
  classic rumor-mongering + anti-entropy pair: push spreads a delta to
  most of the fleet in O(log n) rounds w.h.p., pull guarantees the
  stragglers converge). Messages per round are bounded by
  ``deltas x ceil(log2 n) + 2n`` = O(n log n) — measured in
  ``GossipStats.max_round_messages`` and asserted by
  ``benchmarks/bench_fleet.py`` at n=48. Sampling is seeded and keyed
  on (seed, generation) / (seed, round, replica), so a replayed trace
  gossips bit-identically.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class GossipStats:
    n_published: int = 0        # pairs offered by replicas (cache fills)
    n_broadcast: int = 0        # pairs actually broadcast (budget-bound)
    n_applied: int = 0          # pair-deliveries into sibling caches
    n_dropped_budget: int = 0   # overflow pairs shed by the round budget
    n_dropped_stale: int = 0    # superseded-generation pairs dropped
    # Message accounting (one "message" = one delta delivered to one
    # replica, or one anti-entropy pull exchange) — what a wire
    # protocol would actually send, and what the O(n log n) bench gate
    # measures.
    n_rounds: int = 0
    n_messages: int = 0
    n_push_messages: int = 0
    n_pull_messages: int = 0    # pull exchanges (request + any reply)
    n_pull_applied: int = 0     # pairs delivered via anti-entropy pull
    max_round_messages: int = 0
    # What broadcast WOULD have sent for the same kept deltas
    # (deltas x (n-1)) — the O(n^2) contrast the epidemic mode avoids.
    n_broadcast_equiv: int = 0

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


@dataclass
class TrustDelta:
    """One published cache-fill batch from ``origin``."""
    origin: str
    keys: np.ndarray            # (n,) uint32 url keys
    values: np.ndarray          # (n,) float32 trust
    gen: int                    # generation stamp (monotone per bus)


GOSSIP_MODES = ("broadcast", "epidemic")


@dataclass
class _RelayEntry:
    """A recently pushed delta still spreading through the fleet
    (epidemic mode): ``reached`` tracks which replicas hold it, so
    anti-entropy pulls only move what the target actually lacks."""
    gen: int
    keys: np.ndarray
    values: np.ndarray
    reached: set


class TrustGossipBus:
    """Coordinator-owned delta bus: publish on cache fill, deliver
    once per drain round under a bounded per-round budget (broadcast
    to all siblings, or epidemic peer-sampled push + anti-entropy
    pull — see the module docstring)."""

    def __init__(self, budget_items_per_round: int = 256,
                 mode: str = "broadcast", seed: int = 0,
                 relay_log: int = 256):
        if budget_items_per_round <= 0:
            raise ValueError("gossip budget must be positive")
        if mode not in GOSSIP_MODES:
            raise ValueError(f"unknown gossip mode {mode!r}")
        self.budget_items_per_round = int(budget_items_per_round)
        self.mode = mode
        self._seed = int(seed) & 0xFFFFFFFF
        self._relay_cap = int(relay_log)
        self._relay: List[_RelayEntry] = []
        self._pending: Deque[TrustDelta] = deque()
        self._gen = itertools.count(1)
        # key -> newest generation seen; older deltas for the key are
        # stale and must not overwrite fresher trust on delivery.
        self._latest_gen: Dict[int, int] = {}
        self.stats = GossipStats()

    @property
    def n_pending(self) -> int:
        return sum(len(d.keys) for d in self._pending)

    def publish(self, origin: str, keys: np.ndarray, values: np.ndarray,
                gen: Optional[int] = None) -> int:
        """Enqueue a cache-fill delta batch from ``origin``. ``gen``
        defaults to a fresh (newest) generation; an explicit lower
        generation models a delayed/out-of-order publish and will be
        dropped as stale at broadcast time."""
        keys = np.asarray(keys, np.uint32)
        values = np.asarray(values, np.float32)
        if len(keys) == 0:
            return 0
        if len(keys) != len(values):
            raise ValueError("keys/values length mismatch")
        g = next(self._gen) if gen is None else int(gen)
        for k in keys.tolist():
            if g >= self._latest_gen.get(int(k), -1):
                self._latest_gen[int(k)] = g
        self._pending.append(TrustDelta(origin, keys, values, g))
        self.stats.n_published += len(keys)
        return len(keys)

    def flush(self, replicas: Sequence) -> int:
        """Deliver up to ``budget_items_per_round`` of the freshest
        pending pairs (overflow pending pairs are dropped — bounded
        memory, bounded per-round work), then run the mode's delivery:
        broadcast to every non-origin replica, or epidemic push to
        ``ceil(log2 n)`` sampled peers plus one anti-entropy pull per
        replica. Returns the number of pairs that spent budget."""
        budget = self.budget_items_per_round
        n_broadcast = 0
        kept: List[TrustDelta] = []
        # Newest publishes spend the budget first: under a sustained
        # flood the keys most likely to recur next round are the ones
        # siblings must hear about; the oldest overflow is shed.
        while self._pending:
            delta = self._pending.pop()
            fresh = np.asarray(
                [self._latest_gen.get(int(k), -1) <= delta.gen
                 for k in delta.keys.tolist()])
            self.stats.n_dropped_stale += int((~fresh).sum())
            keys, vals = delta.keys[fresh], delta.values[fresh]
            if len(keys) == 0:
                continue
            if n_broadcast >= budget:
                self.stats.n_dropped_budget += len(keys)
                continue
            take = min(len(keys), budget - n_broadcast)
            self.stats.n_dropped_budget += len(keys) - take
            kept.append(TrustDelta(delta.origin, keys[:take],
                                   vals[:take], delta.gen))
            n_broadcast += take
        n_live = len(replicas)
        round_msgs = 0
        if n_live > 1:
            if self.mode == "broadcast":
                round_msgs += self._deliver_broadcast(kept, replicas)
            else:
                round_msgs += self._push_epidemic(kept, replicas)
                round_msgs += self._anti_entropy_pull(replicas)
                self._prune_relay(replicas)
        self.stats.n_broadcast += n_broadcast
        self.stats.n_broadcast_equiv += len(kept) * max(n_live - 1, 0)
        self.stats.n_rounds += 1
        self.stats.n_messages += round_msgs
        if round_msgs > self.stats.max_round_messages:
            self.stats.max_round_messages = round_msgs
        return n_broadcast

    # -- delivery modes ------------------------------------------------------

    def _deliver_broadcast(self, kept: List[TrustDelta],
                           replicas: Sequence) -> int:
        """Original O(n^2) wall: every kept delta to every non-origin
        replica, one apply per target per round."""
        per_target: Dict[str, List[Tuple[np.ndarray, np.ndarray]]] = {}
        msgs = 0
        for delta in kept:
            for rep in replicas:
                if rep.replica_id != delta.origin:
                    per_target.setdefault(rep.replica_id, []).append(
                        (delta.keys, delta.values))
                    msgs += 1
        self._apply_grouped(per_target, replicas)
        self.stats.n_push_messages += msgs
        return msgs

    def _push_epidemic(self, kept: List[TrustDelta],
                       replicas: Sequence) -> int:
        """Rumor-mongering push: each kept delta to ``ceil(log2 n)``
        sampled non-origin peers, sampling keyed on (seed, gen) so a
        replayed trace pushes to the same peers."""
        rids = sorted(rep.replica_id for rep in replicas)
        fanout = max(1, math.ceil(math.log2(max(len(rids), 2))))
        per_target: Dict[str, List[Tuple[np.ndarray, np.ndarray]]] = {}
        msgs = 0
        for delta in kept:
            peers = [r for r in rids if r != delta.origin]
            rng = np.random.default_rng(
                (self._seed, 0x505A11, delta.gen))
            idx = rng.choice(len(peers),
                             size=min(fanout, len(peers)),
                             replace=False)
            targets = [peers[i] for i in sorted(idx.tolist())]
            for t in targets:
                per_target.setdefault(t, []).append(
                    (delta.keys, delta.values))
            msgs += len(targets)
            self._relay.append(_RelayEntry(
                delta.gen, delta.keys, delta.values,
                {delta.origin, *targets}))
        self._apply_grouped(per_target, replicas)
        self.stats.n_push_messages += msgs
        return msgs

    def _anti_entropy_pull(self, replicas: Sequence) -> int:
        """Once per round each replica pulls from ONE sampled peer the
        relay-log deltas that peer holds and it lacks: the convergence
        guarantee behind the probabilistic push (a straggler the push
        sampling missed catches up in expected O(1) pulls once most of
        the fleet holds the delta)."""
        from repro_torch.cluster.routing import stable_hash
        rids = sorted(rep.replica_id for rep in replicas)
        by_id = {rep.replica_id: rep for rep in replicas}
        rnd = self.stats.n_rounds
        msgs = 0
        for rid in rids:
            peers = [r for r in rids if r != rid]
            rng = np.random.default_rng(
                (self._seed, 0xA17E, rnd,
                 stable_hash(rid) & 0xFFFFFFFF))
            peer = peers[int(rng.integers(len(peers)))]
            msgs += 1               # the digest request
            keys_l: List[np.ndarray] = []
            vals_l: List[np.ndarray] = []
            for e in self._relay:
                if peer not in e.reached or rid in e.reached:
                    continue
                fresh = np.asarray(
                    [self._latest_gen.get(int(k), -1) <= e.gen
                     for k in e.keys.tolist()])
                self.stats.n_dropped_stale += int((~fresh).sum())
                if fresh.any():
                    keys_l.append(e.keys[fresh])
                    vals_l.append(e.values[fresh])
                e.reached.add(rid)
            if keys_l:
                keys = np.concatenate(keys_l)
                vals = np.concatenate(vals_l)
                by_id[rid].apply_trust_deltas(keys, vals)
                msgs += 1           # the reply payload
                self.stats.n_applied += len(keys)
                self.stats.n_pull_applied += len(keys)
        self.stats.n_pull_messages += msgs
        return msgs

    def _apply_grouped(self, per_target: Dict[str, List[Tuple]],
                       replicas: Sequence) -> None:
        if not per_target:
            return
        by_id = {rep.replica_id: rep for rep in replicas}
        for rid, batches in per_target.items():
            keys = np.concatenate([k for k, _ in batches])
            vals = np.concatenate([v for _, v in batches])
            by_id[rid].apply_trust_deltas(keys, vals)
            self.stats.n_applied += len(keys)

    def _prune_relay(self, replicas: Sequence) -> None:
        """Drop fully-spread deltas; cap the log (oldest evicted — a
        delta nobody pulled in ``relay_log`` rounds of churn only
        costs a duplicate evaluation later, the gossip contract)."""
        live = {rep.replica_id for rep in replicas}
        self._relay = [e for e in self._relay
                       if not live.issubset(e.reached)]
        if len(self._relay) > self._relay_cap:
            self._relay = self._relay[-self._relay_cap:]
