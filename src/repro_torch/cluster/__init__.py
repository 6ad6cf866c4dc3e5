"""Multi-replica serving fleet on top of ``scheduling`` (counterpart of
``repro.cluster``).

Fleet request lifecycle (who owns each hop):

    route      cluster.routing                consistent-hash ring maps
       |                                      tenant -> replica shard
       |                                      (weighted vnodes, minimal
       |                                      remap on join/leave,
       |                                      fencing for drains)
    admit      replica's own Scheduler        admission ladder vs THAT
       |                                      replica's regime; explicit
       |                                      prior-answered rejections
    steal      cluster.coordinator            hot bank -> idle sibling,
       |                                      from the BACK of the lowest
       |                                      non-empty class (EDF heads
       |                                      never reorder)
    drain      cluster.coordinator            one micro-batch per replica
       |                                      per round (round-robin)
    hedge      distribution.fault_tolerance   stuck requests race a twin
       |                                      on a REAL backup replica;
       |                                      first completion wins,
       |                                      loser deduplicated
    gossip     cluster.gossip                 fresh Trust-DB cache fills
       |                                      reach siblings on a bounded
       |                                      per-round budget (hot URLs
       |                                      evaluated once fleet-wide):
       |                                      O(n^2) broadcast, or
       |                                      epidemic peer-sampling push
       |                                      (O(log n) fanout, relayed)
       |                                      + anti-entropy pull —
       |                                      O(n log n) per round
    forecast   cluster.capacity               feedforward planner: NHPP
       |                                      arrival-rate extrapolation
       |                                      warmup_lead_s ahead ->
       |                                      forecast pressure folded
       |                                      into the SAME autoscaler
       |                                      vote (shared cooldown);
       |                                      per-stage ServiceTimeModel
       |                                      fitted from live drain
       |                                      stats feeds what-if
       |                                      predict(n, depth, batch)
    prewarm    cluster.replica                planner-triggered joins
       |                                      warm the batch
       |                                      shape on synthetic keys
       |                                      BEFORE the ring unfences
       |                                      them (cache/prior/clock
       |                                      snapshot-restored, so
       |                                      prewarm leaves no state)
    adapt      cluster.autoscale_watermarks   fleet LoadMonitor EWMA ->
       |                                      adaptive AdmissionPolicy
       |                                      watermarks + tenant quotas;
       |                                      steal/hedge/autoscale scans
       |                                      read hot/cold replicas from
       |                                      one per-round
       |                                      ``ReplicaLoadHeap``
       |                                      (O(log n) per steal, not a
       |                                      full re-sort)
    restart    cluster.coordinator            coordinated rolling
       |                                      restarts in ring-disjoint
       |                                      waves: fence + handoff,
       |                                      engine rebuilt in place,
       |                                      membership held steady
    join/leave cluster.coordinator            runtime membership: joins
                                              rebalance minimally; a
                                              leave fences + drains its
                                              backlog to the ring's new
                                              owners (EDF order, hedge
                                              twins deduped); a crash
                                              replays the admission
                                              journal; the autoscaler's
                                              membership vote drives
                                              both between min/max
                                              replica bounds

Every replica is a full independent serving stack (own shedder, cache,
prior, monitor — ``cluster.replica``); ``n_replicas=1`` degenerates to
the single-host behaviour exactly.
"""
from repro_torch.cluster.autoscale_watermarks import (ClusterLoadSnapshot,
                                                      WatermarkAutoscaler)
from repro_torch.cluster.capacity import (CapacityPrediction,
                                          ForecastPlanner, ForecastSnapshot,
                                          ServiceTimeModel, StageStats,
                                          predict)
from repro_torch.cluster.coordinator import (ClusterConfig,
                                             ClusterCoordinator,
                                             ClusterStats)
from repro_torch.cluster.gossip import (GOSSIP_MODES, GossipStats,
                                        TrustDelta, TrustGossipBus)
from repro_torch.cluster.loadindex import ReplicaLoadHeap
from repro_torch.cluster.replica import ReplicaHandle
from repro_torch.cluster.routing import ConsistentHashRing, stable_hash

__all__ = [
    "ConsistentHashRing", "stable_hash",
    "ReplicaHandle", "ReplicaLoadHeap",
    "ClusterConfig", "ClusterCoordinator", "ClusterStats",
    "WatermarkAutoscaler", "ClusterLoadSnapshot",
    "ServiceTimeModel", "StageStats", "CapacityPrediction", "predict",
    "ForecastPlanner", "ForecastSnapshot",
    "TrustGossipBus", "TrustDelta", "GossipStats", "GOSSIP_MODES",
]
