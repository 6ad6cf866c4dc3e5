"""Selective stripe replication: mirror persistently slow shards.

Per-shard hedging needs somewhere to land — a sibling that actually
holds a copy of the slow shard's stripes. Replicating everything
everywhere would triple index residency for a tail problem that lives
on a handful of shards, so replication is *selective*:

* :class:`StripeReplicator` keeps a per-shard EWMA of PRIMARY probe
  service times (hedged completions are excluded on purpose — a shard
  rescued by its mirror must still look slow, or the mirror would be
  dropped the moment it starts working);
* a shard whose EWMA exceeds ``slow_factor x`` the fleet median for at
  least ``min_probes`` probes is **due** for replication, bounded at
  ``max_mirrors`` concurrent mirrors fleet-wide (slowest first);
* a mirrored shard whose EWMA falls back under ``recover_factor x``
  the median has **recovered** and its mirror is dropped.

Mirror stripes travel the existing handoff path: each stripe is carved
out of the primary with ``IndexShard.export_docs``, a deep copy is
``absorb``-ed into the mirror, and the original postings are absorbed
straight back — the round trip is lossless (postings stay doc-id
sorted), and because every shard scores with the SAME collection-global
``CollectionStats``, the mirror's BM25 scores are bit-identical to the
primary's.

Counterpart of ``repro.fanout.replication``. The mirror lives on its
primary's device: each replication rebuilds two dense forms there, the
primary's (the round trip invalidates it; it rebuilds at its next
probe) and the mirror's (through ``FanoutSearcher.add_mirror``'s warm
probe). Its float64 weights, slots sorted by doc id and shared
statistics make it rank bit-identically to the primary on either
device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Set

import numpy as np

from repro_torch.retrieval.index import InvertedIndex
from repro_torch.retrieval.shard import IndexShard


@dataclass
class ReplicationPolicy:
    ewma_alpha: float = 0.25         # per-shard service-time EWMA gain
    slow_factor: float = 2.5         # due when ewma > slow x median
    recover_factor: float = 1.4      # drop when ewma < recover x median
    min_probes: int = 6              # observations before any decision
    max_mirrors: int = 2             # concurrent mirrors, fleet-wide


class StripeReplicator:
    """Per-shard latency EWMAs + the due/recovered policy."""

    def __init__(self, policy: Optional[ReplicationPolicy] = None):
        self.policy = policy or ReplicationPolicy()
        self._ewma: Dict[str, float] = {}
        self._n: Dict[str, int] = {}

    def observe(self, key: str, service_s: float) -> None:
        """Fold one PRIMARY probe completion into ``key``'s EWMA."""
        a = self.policy.ewma_alpha
        prev = self._ewma.get(key)
        self._ewma[key] = (float(service_s) if prev is None
                           else (1.0 - a) * prev + a * float(service_s))
        self._n[key] = self._n.get(key, 0) + 1

    def ewma_of(self, key: str) -> float:
        return self._ewma.get(key, 0.0)

    def forget(self, key: str) -> None:
        self._ewma.pop(key, None)
        self._n.pop(key, None)

    def baseline(self) -> float:
        """Fleet median EWMA — robust to the stragglers themselves."""
        if len(self._ewma) < 2:
            return 0.0
        return float(np.median(list(self._ewma.values())))

    def _mature(self, key: str) -> bool:
        return self._n.get(key, 0) >= self.policy.min_probes

    def due(self, mirrored: Set[str]) -> List[str]:
        """Shards to replicate now: mature, persistently over the slow
        threshold, unmirrored — slowest first, bounded so the total
        mirror count never exceeds ``max_mirrors``."""
        base = self.baseline()
        budget = self.policy.max_mirrors - len(mirrored)
        if base <= 0.0 or budget <= 0:
            return []
        slow = [k for k, e in self._ewma.items()
                if k not in mirrored and self._mature(k)
                and e > self.policy.slow_factor * base]
        slow.sort(key=lambda k: (-self._ewma[k], k))
        return slow[:budget]

    def recovered(self, mirrored: Iterable[str]) -> List[str]:
        """Mirrored shards whose EWMA came back to the pack."""
        base = self.baseline()
        if base <= 0.0:
            return []
        return sorted(k for k in mirrored
                      if self._mature(k) and self._ewma.get(k) is not None
                      and self._ewma[k] < self.policy.recover_factor * base)


def clone_stripe(sub: InvertedIndex) -> InvertedIndex:
    """Deep-copy a handoff stripe (postings tuples are immutable, the
    containers are not — a mirror must never alias the primary)."""
    out = InvertedIndex()
    out.doc_len = dict(sub.doc_len)
    out.postings = {t: list(pl) for t, pl in sub.postings.items()}
    return out


def mirror_shard_of(primary: IndexShard,
                    stripes: Optional[Sequence[Sequence[int]]] = None
                    ) -> IndexShard:
    """Build a mirror of ``primary`` via the existing
    ``export_docs -> absorb`` handoff path: each stripe is exported,
    deep-copied into the mirror, and absorbed straight back into the
    primary (lossless round trip). Default: one stripe of everything.
    Same ``CollectionStats``/k1/b, so the mirror ranks bit-identically.
    The mirror lives on ``primary.device``.
    """
    if stripes is None:
        stripes = [list(primary.index.doc_len)]
    mirror = IndexShard(InvertedIndex(), k1=primary.k1, b=primary.b,
                        stats=primary.stats, device=primary.device)
    for docs in stripes:
        sub = primary.export_docs(docs)
        mirror.absorb(clone_stripe(sub))
        primary.absorb(sub)
    return mirror
