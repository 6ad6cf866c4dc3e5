"""``repro_torch.fanout`` — tail-tolerant scatter-gather (counterpart of
``repro.fanout``).

The doc-partitioned index fans every query out to ALL live
shards; a synchronous gather makes p99 the latency of the single
slowest shard — the canonical tail problem (PAPERS.md: Tail-Tolerant
Distributed Search). This subsystem makes the gather tail-tolerant
while preserving the fleet invariants:

* :mod:`service_model` — deterministic, seeded per-shard service times
  with heavy-tailed straggler injection (transient Pareto tails +
  persistent multipliers), pure per ``(seed, shard, probe#)`` so
  churn/chaos tests stay bit-reproducible;
* :mod:`quorum` — first-``k``-of-``n`` partial aggregation with the
  exact (score desc, doc id asc) merge of the synchronous gather;
  ``quorum_k == n`` is bit-identical to it, late shards are
  prior-answered (stripe answer cache / trust prior), never dropped;
* per-shard **hedging** (:class:`FanoutSearcher`) — a slow stripe
  probe races a twin on a sibling's mirror, first completion wins with
  exactly-one-answer-per-shard dedup, charged to the fleet
  ``HedgedDispatch`` budget;
* :mod:`replication` — per-stripe latency EWMAs pick the persistently
  slow shards and mirror their stripes to siblings over the existing
  ``export_docs -> absorb`` handoff (bounded mirror count, dropped on
  EWMA recovery) so those hedges have somewhere to land.
"""
from repro_torch.fanout.quorum import GatherReport, QuorumGather
from repro_torch.fanout.replication import (ReplicationPolicy,
                                            StripeReplicator, clone_stripe,
                                            mirror_shard_of)
from repro_torch.fanout.searcher import FanoutSearcher
from repro_torch.fanout.service_model import ShardServiceModel

__all__ = [
    "FanoutSearcher", "GatherReport", "QuorumGather",
    "ReplicationPolicy", "ShardServiceModel", "StripeReplicator",
    "clone_stripe", "mirror_shard_of",
]
