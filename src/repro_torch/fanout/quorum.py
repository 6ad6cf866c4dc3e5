"""First-k-of-n quorum over the shard fan-out.

:class:`QuorumGather` decides *when* a scatter-gather may answer: as
soon as ``quorum_k`` of the ``n`` live shards have completed, instead
of waiting for the slowest one. The gather time is the ``quorum_k``-th
order statistic of the per-shard completion times; every shard at or
under that threshold is **answered** (ties included — answering more
than ``quorum_k`` is free), everything past it is **late**. With
``quorum_k >= n`` (or ``<= 0``) the threshold is the maximum, every
shard is answered, and the merge is bit-identical to the synchronous
full gather — the parity anchor the property tests pin.

Late shards are never silently dropped: the searcher prior-answers
them from the stripe answer cache (their last candidates, whose trust
already sits in the Trust-DB) or, failing that, leaves them to the
downstream trust prior — the paper's overload answer ("respond from
the prior rather than miss the deadline") applied to stragglers. The
merge itself is :func:`retrieval.shard.merge_topk`, the SAME
(score desc, doc id asc) lexsort the synchronous gather uses.

Counterpart of ``repro.fanout.quorum`` (host logic, copied).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

from repro_torch.retrieval.shard import merge_topk  # noqa: F401 (re-export)


@dataclass
class GatherReport:
    """Per-query gather observability (one per ``retrieve``)."""
    n_shards: int = 0
    quorum_k: int = 0                # effective k (clamped to n)
    t_quorum_s: float = 0.0          # simulated gather completion
    t_full_s: float = 0.0            # slowest shard (full-gather time)
    late_keys: List[str] = field(default_factory=list)
    n_cache_fills: int = 0           # late stripes answered from cache
    n_prior_answered: int = 0        # late stripes left to the prior
    n_hedges: int = 0                # shard probes hedged to a mirror
    n_hedge_wins: int = 0            # mirror answered first


class QuorumGather:
    """First-k-of-n split of per-shard completion times.

    ``floor_k`` is the loosest quorum the operator configured; the
    regime-ladder adaptation (:meth:`adapt`) moves ``quorum_k`` between
    that floor and the live fan-out ``n``, so under Normal load the
    gather converges to the bit-exact full gather and under Very-Heavy
    load it pays only the configured minimum of stragglers."""

    def __init__(self, quorum_k: int = 0, *, floor_k: int = None):
        self.quorum_k = int(quorum_k)
        self.floor_k = int(quorum_k if floor_k is None else floor_k)
        self.n_adapts = 0

    def effective_k(self, n: int) -> int:
        """Clamp to the live fan-out: 0 (or >= n) waits for everyone."""
        return self.quorum_k if 0 < self.quorum_k < n else n

    def adapt(self, regime: int, n: int) -> int:
        """One regime-ladder step: tighten ``quorum_k`` toward ``n``
        (full gather) under Normal, loosen toward the configured
        ``floor_k`` under Very-Heavy, hold under Heavy. One step per
        call, so the quorum walks the ladder instead of flapping
        between its extremes. Inert while quorum is disabled
        (``floor_k <= 0``: the synchronous full gather, whose bit
        parity the property tests pin). ``regime`` is
        ``core.regimes.Regime`` (or its int value)."""
        if self.floor_k <= 0 or n <= 0:
            return self.quorum_k
        k = self.quorum_k
        if int(regime) == 0:                     # Normal
            k = min(k + 1, n)
        elif int(regime) >= 2:                   # Very-Heavy
            k = max(k - 1, self.floor_k)
        k = max(min(k, max(n, self.floor_k)), self.floor_k)
        if k != self.quorum_k:
            self.n_adapts += 1
            self.quorum_k = k
        return self.quorum_k

    def split(self, times: Sequence[float]
              ) -> Tuple[float, List[bool]]:
        """``(t_quorum, answered_mask)``: the gather completes at the
        ``effective_k``-th smallest completion time; a shard is
        answered iff it completed by then (ties answer with it)."""
        n = len(times)
        if n == 0:
            return 0.0, []
        kq = self.effective_k(n)
        t_quorum = sorted(times)[kq - 1]
        return t_quorum, [t <= t_quorum for t in times]
