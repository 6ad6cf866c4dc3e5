"""The cluster event loop: route -> admit -> steal -> drain -> hedge.

``ClusterCoordinator`` turns N independent ``ReplicaHandle`` stacks
into one serving fleet:

* **route** — tenants map to replicas through the consistent-hash ring
  (``routing``): sticky (per-tenant cache/prior locality), weighted,
  and minimally disturbed by membership changes.
* **admit** — the chosen replica's own scheduler applies the
  admission ladder against *its* regime; rejections surface through the
  coordinator as the same explicit prior-answered ``Response``.
* **steal** — when one replica's ``PriorityQueueBank`` runs hot while a
  sibling idles, queued work migrates out of the victim's
  lowest-importance non-empty class (``PriorityQueueBank.steal_back``):
  cost-aware by default (``ClusterConfig.cost_aware_steal``), the
  non-head entry with the highest estimated eval cost on the victim —
  items x Trust-DB miss probability (``ReplicaHandle.steal_cost``) —
  moves, so cache-cold work migrates while cache-hot work stays where
  its cache is warm; the victim's EDF heads never reorder.
* **drain** — micro-batches execute round-robin across replicas, one
  batch per replica per round (fair progress; on simulated clocks the
  replicas genuinely overlap in time). Each replica keeps ONE
  ``DrainExecutor`` window alive ACROSS rounds (``pipeline_depth >=
  2``, wall clocks): its fused device steps overlap the next round's
  scans and batch formation, and every round begins by POLLING the
  completed in-flight batches so the steal/hedge/autoscale decisions
  below read stats as fresh as the hardware allows — not one batch
  late.
* **hedge** — requests stuck past the hedge latency are re-dispatched
  to a REAL backup replica (the ring's next distinct replica for the
  tenant) at CRITICAL priority and the twins race; the first completed
  copy wins and the loser is deduplicated fleet-wide by the
  coordinator, so the no-drop invariant stays "exactly one Response
  per request" across the fleet. Re-hedging (a backup that is itself
  overloaded) is allowed up to ``max_hedges``, all of it token-bucket
  capped at a fraction of admitted traffic (``HedgedDispatch``).

Closing the loop, a ``WatermarkAutoscaler`` periodically aggregates
per-replica ``LoadMonitor`` EWMA rates into fleet (Ucapacity,
Uthreshold) and pushes adaptive admission watermarks + tenant quotas
back onto every replica.

**Elastic membership** (runtime join/leave/crash):

* ``add_replica`` joins a fresh (or caller-built) replica at the
  fleet's current simulated time; the ring rebalances minimally, so
  only the tenants the new replica claims move.
* ``remove_replica(rid, drain=True)`` is the graceful leave: the
  replica is *fenced* from routing first, then its queued backlog
  hands off to the ring's new owners in drain order (strict priority,
  EDF within class — no surviving EDF head reorders), with hedge twins
  deduplicated across the handoff (a copy whose twin is already queued
  on a surviving replica is dropped, not double-served).
* ``remove_replica(rid, drain=False)`` is a crash: the replica's
  engine state (queues, cache, prior) is lost wholesale. The
  coordinator recovers from its **admission journal** — every admitted
  request is journaled until its response lands — by re-dispatching
  each unanswered request that has no live copy on a surviving replica
  to the ring's new owner. The fleet-wide no-drop invariant survives
  both paths.
* With ``ClusterConfig.max_replicas > 0`` the autoscaler's
  ``membership_decision`` (fleet pressure vs per-replica capacity
  watermarks, hysteresis + cooldown) drives joins and graceful leaves
  from inside the drain loop instead of only pushing quotas.

**Trust-DB gossip** (``ClusterConfig.gossip``): replicas tap their
shedder's fresh evaluations (cache fills); once per drain round the
coordinator harvests the ``(url_key, trust)`` deltas, publishes them to
a bounded-budget ``TrustGossipBus``, and broadcasts the freshest to
every sibling's Trust-DB — so a hot URL flooding every tenant is
evaluated once fleet-wide instead of once per replica. The coordinator
also counts fleet-wide duplicate evaluations (the same key freshly
evaluated on more than one replica) whether or not gossip is on, which
is the benchmark's measured quantity.

``TrustIRConfig.n_replicas = 1`` is the degenerate case: one replica,
no stealing, hedging disabled (no backup exists) — behaviour identical
to a bare ``ServingEngine``.

Counterpart of ``repro.cluster.coordinator`` (host logic, copied). Every
replica's engine, Trust DB and index shard live on ``device`` (``cuda``
unless named): a fleet on one card is a software fleet. So do the
fan-out's mirror stripes, which live on their primary's device.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.configs.base import TrustIRConfig
from repro_torch.distribution.fault_tolerance import HedgedDispatch
from repro_torch.fanout import (FanoutSearcher, ReplicationPolicy,
                                StripeReplicator, mirror_shard_of)
from repro_torch.scheduling import (Priority, QueuedRequest, Request,
                                    Response, SchedulerConfig)
from repro_torch.scheduling.priorities import REASON_QUEUE_FULL
from repro_torch.serving.engine import slo_stats_of

from repro_torch.cluster.autoscale_watermarks import (ClusterLoadSnapshot,
                                                      WatermarkAutoscaler)
from repro_torch.cluster.capacity import ForecastPlanner, ServiceTimeModel
from repro_torch.cluster.gossip import TrustGossipBus
from repro_torch.cluster.loadindex import ReplicaLoadHeap
from repro_torch.cluster.replica import ReplicaHandle
from repro_torch.cluster.routing import ConsistentHashRing


@dataclass
class ClusterConfig:
    """Fleet-level policy knobs (per-replica policy stays in
    ``SchedulerConfig``)."""
    steal_threshold_items: int = 1      # min queued-item imbalance
    max_steals_per_round: int = 8
    hedge_after_s: float = 0.0          # 0 disables cluster hedging
    max_hedges: int = 1                 # re-dispatches per request
    hedge_budget_frac: float = 0.05     # hedge tokens per admitted req
    autoscale: bool = False             # adaptive watermarks + quotas
    autoscale_every: int = 4            # drain rounds between updates
    vnodes_per_weight: int = 64
    # Elastic membership: with max_replicas > 0 (and autoscale on) the
    # autoscaler's membership_decision drives runtime joins/graceful
    # leaves between min_replicas and max_replicas; 0 = fixed fleet.
    min_replicas: int = 0
    max_replicas: int = 0
    # Cross-replica Trust-DB gossip (cache-fill delta broadcast on a
    # bounded per-round budget). "broadcast" delivers every kept delta
    # to every sibling (O(n^2) messages/round); "epidemic" pushes each
    # delta to ceil(log2 n) sampled peers with a per-round
    # anti-entropy pull — O(n log n), the 48+ replica mode.
    gossip: bool = False
    gossip_budget_items: int = 256
    gossip_mode: str = "broadcast"
    # Warm Trust-DB handoff on graceful leave: the leaving replica's
    # top-K freshest (url, trust) cache entries ship to the ring's new
    # owners via apply_trust_deltas (0 disables — the cache then
    # re-warms purely through gossip / duplicate evaluations).
    warm_handoff_top_k: int = 1024
    # Cost-aware stealing: rank steal candidates by estimated eval
    # cost on the victim (items x Trust-DB miss probability), so
    # cache-cold work migrates and cache-hot work stays warm.
    cost_aware_steal: bool = True
    # Feedforward capacity planning (cluster.capacity): forecast
    # the arrival curve, feed predicted utilization into the
    # autoscaler's membership vote, and prewarm planner-initiated
    # joins at production shapes before the ring routes to them.
    forecast: bool = False
    warmup_lead_s: float = 0.5
    forecast_window_s: float = 2.0


@dataclass
class ClusterStats:
    n_enqueued: int = 0
    n_steals: int = 0
    n_hedges: int = 0                   # cross-replica re-dispatches
    n_twin_drops: int = 0               # hedge losers deduplicated
    n_drain_rounds: int = 0
    # elastic membership
    n_joins: int = 0
    n_leaves: int = 0                   # graceful (drain-and-handoff)
    n_crashes: int = 0
    n_handoffs: int = 0                 # requests migrated on leave
    n_handoff_twin_drops: int = 0       # hedge twins deduped at handoff
    n_warm_handoff_entries: int = 0     # (url, trust) pairs shipped on
                                        # a graceful leave (warm cache)
    n_crash_recovered: int = 0          # journal-replayed after a crash
    # doc-partitioned retrieval shards (retrieval)
    n_partition_moves: int = 0          # stripes handed off (join/leave)
    n_partition_rebuilds: int = 0       # stripes re-indexed after crash
    # tail-tolerant fan-out (fanout)
    n_stripe_replications: int = 0      # slow shards mirrored to a sib
    n_mirror_drops: int = 0             # mirrors dropped on recovery
    # coordinated rolling restarts
    n_restarts: int = 0                 # replicas restarted in place
    n_restart_waves: int = 0            # ring-disjoint waves executed
    # fleet-wide evaluation accounting (gossip's measured quantity)
    n_eval_items: int = 0               # fresh evaluations, fleet-wide
    n_duplicate_evals: int = 0          # same key evaluated again
    # feedforward capacity planning (cluster.capacity)
    n_prewarm_joins: int = 0            # joins primed before unfencing
    n_cold_joins: int = 0               # prewarmed joins whose FIRST
                                        # real batch still hit a fresh
                                        # first-sight shape (should stay 0)

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


@dataclass
class _JournalEntry:
    """Admission journal record: everything needed to re-dispatch an
    admitted request after its replica crashes (the WAL a multi-host
    control plane would keep)."""
    item_keys: np.ndarray
    buckets: np.ndarray
    features: Dict[str, np.ndarray]
    arrival_s: float
    slo_s: float
    priority: Priority
    tenant: str
    needs_kv_slot: bool


class ClusterCoordinator:
    def __init__(self, cfg: TrustIRConfig, evaluate_chunk: Callable,
                 cluster_cfg: Optional[ClusterConfig] = None,
                 sched_cfg: Optional[SchedulerConfig] = None,
                 sim_rate_items_per_s: Optional[float] = None,
                 autoscaler: Optional[WatermarkAutoscaler] = None,
                 kv_pools: Optional[List] = None,
                 drain_mode: Optional[str] = None,
                 evaluate_batch: Optional[Callable] = None,
                 retrieval=None,
                 fanout_model=None, feature_sharding=None, device=None):
        """``retrieval`` (a ``retrieval.CorpusRetrieval``)
        attaches the sharded inverted-index front end: doc-partition
        stripes route through THIS ring under ``"docpart:p"`` keys,
        each replica's shard is built from the stripes it owns, and
        :meth:`enqueue_query` accepts raw query strings.

        ``fanout_model`` (a ``fanout.ShardServiceModel``) — or
        any of ``cfg.fanout_quorum_k`` / ``cfg.fanout_hedge_after_s``
        — upgrades the fleet searcher to the tail-tolerant
        :class:`FanoutSearcher`: first-k-of-n quorum gather, per-shard
        hedges onto mirror stripes (charged to the cluster hedge
        budget when cluster hedging is on), and EWMA-driven selective
        stripe replication run from the drain loop.

        ``device`` (``cuda`` unless named) is where every replica's
        engine and shard live."""
        self.cfg = cfg
        if cluster_cfg is None:
            # Bare coordinators inherit the system config's elastic
            # membership bounds and gossip switch; an explicit
            # ClusterConfig is authoritative. Elastic bounds imply the
            # autoscaler (membership_decision is its vote).
            cluster_cfg = ClusterConfig(
                min_replicas=getattr(cfg, "min_replicas", 0),
                max_replicas=getattr(cfg, "max_replicas", 0),
                autoscale=getattr(cfg, "max_replicas", 0) > 0,
                gossip=getattr(cfg, "gossip", False),
                gossip_mode=getattr(cfg, "gossip_mode", "broadcast"),
                forecast=getattr(cfg, "forecast", False),
                warmup_lead_s=getattr(cfg, "warmup_lead_s", 0.5),
                forecast_window_s=getattr(cfg, "forecast_window_s", 2.0))
        self.cluster_cfg = cluster_cfg
        n = max(1, int(cfg.n_replicas))
        weights = (tuple(cfg.replica_weights) if cfg.replica_weights
                   else (1.0,) * n)
        if len(weights) != n:
            raise ValueError(
                f"replica_weights has {len(weights)} entries for "
                f"n_replicas={n}")

        cc = self.cluster_cfg
        if cc.max_replicas > 0 and \
                max(cc.min_replicas, 1) > cc.max_replicas:
            raise ValueError("min_replicas exceeds max_replicas")
        hedging = cc.hedge_after_s > 0 and n > 1
        self.hedge = (HedgedDispatch(cc.hedge_after_s,
                                     max_hedges=cc.max_hedges,
                                     budget_frac=cc.hedge_budget_frac)
                      if hedging else None)
        base_sched = sched_cfg or SchedulerConfig()
        if cc.hedge_after_s > 0 and (n > 1 or cc.max_replicas > 0):
            # The cluster owns hedging (twins race REAL replicas);
            # engine-internal same-queue hedging would double-dispatch.
            # Zeroed even at n == 1 when the fleet is ELASTIC: a backup
            # can join at runtime, and the engines' config cannot
            # change then. A permanently single-replica fleet keeps its
            # engine-internal hedging.
            base_sched = dataclasses.replace(base_sched,
                                             hedge_after_s=0.0)

        self._ids = itertools.count()   # fleet-unique request ids
        # Factory state for replicas joined at runtime (add_replica).
        self._base_sched = base_sched
        self._evaluate_chunk = evaluate_chunk
        self._sim_rate = sim_rate_items_per_s
        self._drain_mode = drain_mode
        self._evaluate_batch = evaluate_batch
        self._feature_sharding = feature_sharding
        self._device = device
        self._replica_seq = itertools.count(n)

        self.ring = ConsistentHashRing(cc.vnodes_per_weight)
        self.replicas: List[ReplicaHandle] = []
        for i, w in enumerate(weights):
            rid = f"r{i}"
            self.replicas.append(ReplicaHandle(
                rid, cfg, evaluate_chunk, weight=w,
                sched_cfg=base_sched,
                sim_rate_items_per_s=sim_rate_items_per_s,
                kv_pool=(kv_pools[i] if kv_pools else None),
                request_ids=self._ids,
                drain_mode=drain_mode,
                evaluate_batch=evaluate_batch,
                feature_sharding=feature_sharding,
                device=device))
            self.ring.add(rid, w)
        self.by_id: Dict[str, ReplicaHandle] = {
            r.replica_id: r for r in self.replicas}

        # Default autoscaler construction threads the hysteresis knobs
        # through TrustIRConfig (autoscale_*: documented defaults match
        # the previously hard-coded values) so chaos traces can
        # exercise tight vs loose dead-band/cooldown without a
        # hand-built autoscaler.
        self.autoscaler = autoscaler or (WatermarkAutoscaler(
            scale_up_pressure=getattr(cfg, "autoscale_up_pressure",
                                      0.75),
            scale_down_pressure=getattr(cfg, "autoscale_down_pressure",
                                        0.15),
            scale_cooldown_ticks=getattr(cfg, "autoscale_cooldown_ticks",
                                         2))
            if cc.autoscale else None)
        self.gossip = (TrustGossipBus(cc.gossip_budget_items,
                                      mode=cc.gossip_mode)
                       if cc.gossip else None)
        # Capacity planning: the ServiceTimeModel is always on (its
        # taps are O(1) appends on paths that already fire) so any run
        # — reactive or feedforward — yields a fit the what-if
        # `capacity.predict` can consume. The ForecastPlanner (and with
        # it pre-warmed, feedforward-voted joins) only activates with
        # cc.forecast.
        self.capacity = ServiceTimeModel(
            cfg,
            drain_mode=(drain_mode or getattr(cfg, "drain_mode", "host")),
            pipeline_depth=getattr(cfg, "pipeline_depth", 1),
            batch_items=self.max_batch_items)
        self.planner = (ForecastPlanner(
            warmup_lead_s=cc.warmup_lead_s,
            window_s=cc.forecast_window_s,
            model=self.capacity) if cc.forecast else None)
        # (t, replica_id, forecast_pressure) per planner-initiated join
        # — surfaced through scheduler_stats()["forecast"]["log"] and
        # merged into chaos churn timelines by the trace driver.
        self.planner_log: List[Dict] = []
        # Feature schema of live traffic (leaf trailing-shapes+dtypes),
        # captured at first enqueue: what a prewarm batch must look
        # like for the warmup signatures to match production.
        self._feature_schema: Optional[Dict] = None
        # replica_id -> warmup-exclusion count right after its prewarm;
        # consumed when its first real batch lands (cold-join gate).
        self._prewarm_watch: Dict[str, int] = {}
        for rep in self.replicas:
            self._attach_capacity(rep)
        self.last_snapshot: Optional[ClusterLoadSnapshot] = None
        self.tenants_seen: set = set()
        # Latest arrival timestamp observed: the fleet's notion of
        # "now" for membership events (a busy replica's clock runs
        # AHEAD of now while it chews backlog, so makespan is not it).
        self._now_hint = 0.0
        self.stats = ClusterStats()
        self.completed: List[Response] = []
        self._responded: set = set()    # fleet-wide answered rids
        # Admission journal: rid -> replayable record, cleared when the
        # response lands (crash recovery reads it; see remove_replica).
        self._journal: Dict[int, _JournalEntry] = {}
        # Final scheduler stats of departed replicas: fleet-lifetime
        # counters (submissions, batches, rejections) must survive
        # membership churn — the control plane scrapes them
        # continuously, so a leave/crash does not erase history.
        self._departed_sched: Dict[str, Dict] = {}
        # Pre-restart scheduler counters of LIVE replicas (a rolling
        # restart rebuilds the engine, zeroing its stats, but the id
        # stays in the fleet — the lifetime aggregate must not dip).
        self._restart_sched_base: Dict[str, Dict] = {}
        # While a rolling restart executes, the autoscaler's membership
        # vote is suppressed: restart waves must not race joins/leaves.
        self._restart_hold = False
        # key -> fleet-wide fresh-evaluation count (duplicate-eval
        # accounting: the quantity gossip exists to reduce).
        self._eval_counts: Dict[int, int] = {}
        # Retrieval front end: build each replica's shard from the
        # doc-partition stripes the ring assigns it, then point every
        # engine at ONE fleet searcher (queries scatter-gather across
        # all live shards; ownership governs residency + handoff).
        self.retrieval = retrieval
        self.searcher = None
        self._part_owner: Dict[int, str] = {}
        if retrieval is not None:
            for rep in self.replicas:
                owned = [p for p in range(retrieval.n_partitions)
                         if self.ring.route(retrieval.partition_key(p))
                         == rep.replica_id]
                rep.shard = retrieval.build_shard(owned)
                for p in owned:
                    self._part_owner[p] = rep.replica_id
            fan_on = (fanout_model is not None
                      or getattr(cfg, "fanout_quorum_k", 0) > 0
                      or getattr(cfg, "fanout_hedge_after_s", 0.0) > 0)
            if fan_on:
                probe_after = getattr(cfg, "fanout_hedge_after_s", 0.0)
                # With cluster hedging on, shard-probe hedges spend the
                # SAME fleet bucket as whole-request twins (their own,
                # shorter fuse; budget refills from admitted traffic).
                # Otherwise the searcher owns a probe-granularity
                # bucket and earns per probe dispatched.
                fan_hedge = (self.hedge.probe_view(probe_after)
                             if probe_after > 0 and self.hedge is not None
                             else None)
                self.searcher = FanoutSearcher(
                    retrieval.corpus,
                    feature_fn=retrieval.feature_fn,
                    quorum_k=getattr(cfg, "fanout_quorum_k", 0),
                    service_model=fanout_model,
                    hedge=fan_hedge,
                    hedge_after_s=probe_after,
                    replicator=StripeReplicator(ReplicationPolicy(
                        slow_factor=getattr(cfg, "fanout_slow_factor",
                                            2.5),
                        recover_factor=getattr(
                            cfg, "fanout_recover_factor", 1.4),
                        max_mirrors=getattr(cfg, "fanout_max_mirrors",
                                            2))))
            else:
                self.searcher = retrieval.searcher([])
            self._attach_searcher()

    # -- fleet views ---------------------------------------------------------
    @property
    def n_replicas(self) -> int:
        return len(self.replicas)

    @property
    def queued_items(self) -> int:
        return sum(r.queued_items for r in self.replicas)

    @property
    def max_batch_items(self) -> int:
        return self.replicas[0].scheduler.max_batch_items

    def makespan_s(self) -> float:
        """Latest replica clock (simulated fleets): total time the fleet
        needed — replicas run in parallel, so the slowest one bounds
        throughput."""
        return max((r.clock.t for r in self.replicas
                    if r.clock is not None), default=0.0)

    # -- capacity-model taps -------------------------------------------------
    def _attach_capacity(self, rep: ReplicaHandle) -> None:
        """Wire one replica's measurement taps into the fleet
        ServiceTimeModel. Re-run after a restart — the rebuilt engine
        carries a fresh monitor and shedder."""
        rep.monitor.on_observe = self.capacity.observe_device
        rep.stats_tap = self._capacity_shed_tap
        # Adaptive pipeline depth: the coordinator sets depth per
        # replica through each scheduler's DepthController — point its
        # latency signal at the fleet's per-stage fits so every replica
        # shallows/deepens off the same queue-delay model the capacity
        # planner maintains (local queue-delay EWMAs take over once the
        # replica has landed responses of its own).
        ctrl = getattr(rep.scheduler, "depth_controller", None)
        if ctrl is not None:
            ctrl.model = self.capacity

    def _capacity_shed_tap(self, result, warm: bool) -> None:
        self.capacity.observe_batch(result.uload, result.n_evaluated,
                                    result.response_time_s,
                                    n_cached=result.n_cached, warm=warm)

    # -- route + admit -------------------------------------------------------
    def route(self, tenant: str) -> ReplicaHandle:
        return self.by_id[self.ring.route(tenant)]

    def enqueue(self, item_keys: np.ndarray, buckets: np.ndarray,
                features: Dict[str, np.ndarray],
                slo_s: Optional[float] = None,
                priority: Priority = Priority.NORMAL,
                tenant: str = "default",
                needs_kv_slot: bool = False,
                t_arrival: Optional[float] = None) -> int:
        """Route by tenant, then admit on that replica. Returns the
        fleet-unique request id; a rejection completes immediately into
        ``self.completed``."""
        rep = self.route(tenant)
        if t_arrival is not None:
            rep.advance_to(t_arrival)
        self.tenants_seen.add(tenant)
        n_before = len(rep.engine.completed)
        arrival = rep.now()             # what the engine will stamp
        self._now_hint = max(self._now_hint,
                             t_arrival if t_arrival is not None
                             else arrival)
        if self.planner is not None:
            self.planner.observe_arrival(
                t_arrival if t_arrival is not None else arrival,
                len(item_keys))
        if self._feature_schema is None:
            # Remember what a work batch looks like, so a prewarm pass
            # can warm the exact serving shapes later.
            self._feature_schema = {
                k: (tuple(np.asarray(v).shape[1:]),
                    str(np.asarray(v).dtype))
                for k, v in features.items()}
        rid = rep.engine.enqueue(item_keys, buckets, features,
                                 slo_s=slo_s, priority=priority,
                                 tenant=tenant,
                                 needs_kv_slot=needs_kv_slot)
        self.stats.n_enqueued += 1
        admitted = len(rep.engine.completed) == n_before
        if admitted:
            # Journal every admitted request until its response lands:
            # crash recovery replays unanswered entries onto the ring's
            # surviving owners (the no-drop invariant must not depend
            # on a single replica's memory).
            self._journal[rid] = _JournalEntry(
                item_keys=item_keys, buckets=buckets, features=features,
                arrival_s=arrival,
                slo_s=(self.cfg.overload_deadline_s if slo_s is None
                       else slo_s),
                priority=priority, tenant=tenant,
                needs_kv_slot=needs_kv_slot)
        # A rejection completes immediately; only ADMITTED traffic
        # earns hedge budget (rejected floods must not raise the cap).
        if self.hedge is not None and admitted:
            self.hedge.note_request()
        self._collect()                 # surface immediate rejections
        return rid

    # -- retrieval front end -------------------------------------------------
    def _attach_searcher(self) -> None:
        """Refresh the fleet searcher's shard list and point every live
        engine at it (a replica handles raw query strings by scatter-
        gathering across ALL live shards — its own stripe is just the
        part it stores and hands off)."""
        if self.searcher is None:
            return
        if hasattr(self.searcher, "set_fleet"):
            # FanoutSearcher: shard keys ARE replica ids (service
            # model, EWMAs, and mirrors key on them); membership
            # changes invalidate the stripe answer cache and drop
            # mirrors whose slow shard or host departed.
            self.searcher.set_fleet(
                [(r.replica_id, r.shard) for r in self.replicas
                 if r.shard is not None])
            live = self.searcher.mirrors
            for rep in self.replicas:
                rep.mirrors = {key: m for key, (host, m) in live.items()
                               if host == rep.replica_id}
        else:
            self.searcher.shards = [r.shard for r in self.replicas
                                    if r.shard is not None]
        for rep in self.replicas:
            rep.engine.retriever = self.searcher

    def partition_owners(self) -> Dict[int, str]:
        """Current doc-partition -> replica-id map (observability and
        the shard-ownership tests)."""
        return dict(self._part_owner)

    def set_shard_slowdown(self, replica_id: str, mult: float) -> None:
        """Chaos hook: pin (``mult > 1``) or clear (``mult <= 1``) a
        persistent service-time multiplier on one replica's shard —
        the degraded-disk scenario selective replication exists for.
        No-op without a fanout service model."""
        if hasattr(self.searcher, "set_slowdown"):
            self.searcher.set_slowdown(replica_id, mult)

    def _adapt_quorum(self) -> None:
        """Regime-ladder quorum adaptation, once per drain round: read
        the fleet's worst offered regime off the live schedulers and
        walk ``quorum_k`` one step — toward the full fan-out under
        Normal (converging to the bit-exact full gather), toward the
        configured floor under Very-Heavy (paying only the configured
        minimum of stragglers when every evaluation slot matters)."""
        q = getattr(self.searcher, "quorum", None)
        if q is None or not getattr(self.cfg, "fanout_adaptive_quorum",
                                    False):
            return
        regime = max((r.scheduler.offered_regime()
                      for r in self.replicas), default=0)
        n_shards = sum(1 for r in self.replicas if r.shard is not None)
        q.adapt(regime, n_shards)

    def _fanout_maintenance(self) -> None:
        """Selective stripe replication, run once per drain round: a
        replica whose probe EWMA marks it persistently slow gets its
        owned stripes mirrored onto its ring sibling (the existing
        ``export_docs -> absorb`` handoff path, deep-copied — the
        primary keeps serving), so shard-probe hedges have somewhere
        to land; mirrors drop once the EWMA recovers."""
        self._adapt_quorum()
        s = self.searcher
        if self.retrieval is None or not hasattr(s, "replication_due"):
            return
        for key in s.replication_due():
            rep = self.by_id.get(key)
            if rep is None or rep.shard is None or rep.shard.n_docs == 0:
                continue
            owned = sorted(p for p, r in self._part_owner.items()
                           if r == key)
            if not owned:
                continue
            sib = self.ring.sibling_for(
                self.retrieval.partition_key(owned[0]), exclude=(key,))
            if sib is None or sib not in self.by_id:
                continue
            mirror = mirror_shard_of(
                rep.shard,
                [self.retrieval.partition_doc_ids(p) for p in owned])
            self.by_id[sib].mirrors[key] = mirror
            s.add_mirror(key, sib, mirror)
            self.stats.n_stripe_replications += 1
        for key in s.mirrors_recovered():
            host = self.by_id.get(s.mirrors[key][0])
            if host is not None:
                host.mirrors.pop(key, None)
            s.drop_mirror(key)
            self.stats.n_mirror_drops += 1

    def enqueue_query(self, query: str, n_results: Optional[int] = None,
                      slo_s: Optional[float] = None,
                      priority: Priority = Priority.NORMAL,
                      tenant: str = "default",
                      needs_kv_slot: bool = False,
                      t_arrival: Optional[float] = None) -> int:
        """The full lifecycle front half, fleet edition: parse ->
        retrieve (scatter-gather across every live shard) -> route by
        tenant -> admit. Retrieval latency folds into the routed
        replica's LoadMonitor under the WarmupGate rule (wall clocks
        only), so its Ucapacity reflects the retrieve stage too."""
        if self.searcher is None:
            raise RuntimeError(
                "enqueue_query needs a retrieval front end (pass "
                "retrieval= to the coordinator)")
        k = (n_results if n_results is not None
             else getattr(self.cfg, "retrieve_top_k", 64))
        t0 = time.perf_counter()
        res = self.searcher.search(query, k)
        elapsed = time.perf_counter() - t0
        feats = dict(res.features)
        feats["trust"] = res.exact_trust
        self.route(tenant).engine.note_retrieval(
            len(res.url_ids), elapsed, feats)
        return self.enqueue(res.url_ids, res.buckets, feats,
                            slo_s=slo_s, priority=priority,
                            tenant=tenant, needs_kv_slot=needs_kv_slot,
                            t_arrival=t_arrival)

    def _partition_diff(self, *, remove: Optional[str] = None,
                        add=None) -> Dict[int, tuple]:
        """Doc-partitions a membership change would move:
        ``{partition: (old_owner, new_owner)}``. Must run BEFORE the
        ring mutates (and before fencing — a fenced replica no longer
        owns anything to diff)."""
        if self.retrieval is None:
            return {}
        diff = self.ring.remap_diff(self.retrieval.partition_keys(),
                                    remove=remove, add=add)
        return {self.retrieval.partition_index(key): owners
                for key, owners in diff.items()}

    def _move_partitions(self, moved: Dict[int, tuple],
                         joining=None, leaving=None,
                         rebuild: bool = False) -> None:
        """Commit a partition-ownership diff: each moved stripe leaves
        its old owner's shard and lands in the new owner's. On a
        graceful move the postings themselves travel
        (``export_docs``/``absorb`` — the index handoff next to the
        warm Trust-DB one); after a crash (``rebuild=True``) the dead
        shard is gone and the new owner re-indexes the stripe from the
        corpus."""
        if not moved or self.retrieval is None:
            return
        for p, (old_rid, new_rid) in sorted(moved.items()):
            docs = self.retrieval.partition_doc_ids(p)
            old = leaving if (leaving is not None
                              and leaving.replica_id == old_rid) \
                else self.by_id.get(old_rid)
            new = joining if (joining is not None
                              and joining.replica_id == new_rid) \
                else self.by_id.get(new_rid)
            if new is None or new.shard is None:   # pragma: no cover
                continue
            if rebuild or old is None or old.shard is None:
                sub = self.retrieval.build_partition(p)
                self.stats.n_partition_rebuilds += 1
            else:
                sub = old.shard.export_docs(docs)
                if len(sub.doc_len) != len(docs):  # pragma: no cover
                    sub = self.retrieval.build_partition(p)
            new.shard.absorb(sub)
            self._part_owner[p] = new.replica_id
            self.stats.n_partition_moves += 1
        self._attach_searcher()

    # -- elastic membership --------------------------------------------------
    def _next_replica_id(self) -> str:
        while True:
            rid = f"r{next(self._replica_seq)}"
            # Departed ids are not recycled either — their final stats
            # live on in the fleet aggregate under that name.
            if rid not in self.by_id and rid not in self._departed_sched:
                return rid

    def add_replica(self, handle: Optional[ReplicaHandle] = None, *,
                    weight: float = 1.0,
                    replica_id: Optional[str] = None,
                    now_t: Optional[float] = None,
                    prewarm: bool = False) -> ReplicaHandle:
        """Join a replica at runtime. With no ``handle`` a fresh one is
        built from the coordinator's own factory state (same config,
        evaluator, scheduler policy, and simulated rate as the seed
        fleet — and the SHARED request-id source, so fleet-unique ids
        survive the join). A caller-built handle must share that id
        source itself.

        The ring rebalances minimally (only the tenants the new replica
        claims move), and on simulated fleets the newcomer's clock
        fast-forwards to ``now_t`` (default: the latest arrival
        timestamp the fleet has seen) — a replica joining now cannot
        complete work in the past, but it also does not inherit a busy
        sibling's backlog-inflated clock.

        ``prewarm=True`` (the feedforward-join path) primes the
        newcomer's evaluator at the live fleet's production shapes
        BEFORE the ring can route a tenant to it, so its first real
        batch runs warm. Skipped silently when no traffic has been
        seen yet (there is no schema to warm against — and nothing to
        be slow for either)."""
        if handle is None:
            rid = replica_id or self._next_replica_id()
            handle = ReplicaHandle(
                rid, self.cfg, self._evaluate_chunk, weight=weight,
                sched_cfg=self._base_sched,
                sim_rate_items_per_s=self._sim_rate,
                request_ids=self._ids,
                drain_mode=self._drain_mode,
                evaluate_batch=self._evaluate_batch,
                feature_sharding=self._feature_sharding,
                device=self._device)
        if handle.replica_id in self.by_id:
            raise ValueError(
                f"replica {handle.replica_id!r} already in the fleet")
        if handle.replica_id in self._departed_sched:
            raise ValueError(
                f"replica id {handle.replica_id!r} belonged to a "
                f"departed replica whose stats live on under that name")
        # Plan the stripe moves BEFORE the ring mutates: "which
        # partitions does the newcomer claim" is a diff against the
        # pre-join membership.
        moved = self._partition_diff(
            add=(handle.replica_id, handle.weight))
        handle.advance_to(self._now_hint if now_t is None else now_t)
        self._attach_capacity(handle)
        if prewarm and self._feature_schema is not None:
            # Warm BEFORE ring.add: once the id is on the ring a tenant
            # can route here, and the whole point is that no real
            # request ever meets a cold first-use build.
            handle.prewarm(self._feature_schema, self.max_batch_items)
            self.stats.n_prewarm_joins += 1
            self._prewarm_watch[handle.replica_id] = \
                handle.warmup_exclusions()
        self.ring.add(handle.replica_id, handle.weight)
        self.replicas.append(handle)
        self.by_id[handle.replica_id] = handle
        self.stats.n_joins += 1
        if self.retrieval is not None:
            # Build/load the newcomer's shard: exactly the stripes the
            # ring hands it, loaded from their old owners' postings.
            handle.shard = self.retrieval.build_shard([])
            self._move_partitions(moved, joining=handle)
        cc = self.cluster_cfg
        if self.hedge is None and cc.hedge_after_s > 0 \
                and self.n_replicas > 1:
            # A backup exists now: cluster hedging switches on.
            self.hedge = HedgedDispatch(cc.hedge_after_s,
                                        max_hedges=cc.max_hedges,
                                        budget_frac=cc.hedge_budget_frac)
        return handle

    def remove_replica(self, replica_id: str, drain: bool = True) -> int:
        """Leave (``drain=True``) or crash (``drain=False``) a replica
        at runtime; returns the number of queued requests migrated.

        Graceful leave: the replica is fenced from routing, then its
        backlog hands off to the ring's new owners in drain order
        (strict priority, EDF within class). A handed-off copy whose
        hedge twin is already queued on a surviving replica is dropped
        — deduplicated at the handoff instead of racing twice.

        Crash: the engine state is lost wholesale; the admission
        journal replays every unanswered request with no live copy on a
        surviving replica onto the ring's new owner. Responses the dead
        replica already produced were already delivered (collected
        first), so they count — but its queues, Trust-DB, and prior are
        gone."""
        if replica_id not in self.by_id:
            raise KeyError(replica_id)
        if self.n_replicas == 1:
            raise ValueError("cannot remove the last replica")
        rep = self.by_id[replica_id]
        # In-flight pipelined batches land first: a graceful leave waits
        # for its window (those responses are about to be collected); a
        # crash loses a real machine's in-flight work too, but THIS
        # in-process stand-in has already mutated the shared Trust-DB
        # arrays, so finalizing keeps the accounting consistent.
        rep.engine.flush()
        # Responses the replica already produced left the building
        # before the leave/crash — collect them while the cursor lives.
        # Its un-harvested cache-fill deltas likewise: they happened,
        # so they count (and gossip) before the member disappears.
        self._collect()
        self._harvest_cache_deltas()
        # Warm-state handoff plan must be computed BEFORE fencing: the
        # new owners are "who the ring gives this replica's tenants
        # to", and a fenced replica no longer owns anything to diff.
        new_owner_ids: set = set()
        if drain and self.cluster_cfg.warm_handoff_top_k > 0:
            diff = self.ring.remap_diff(sorted(self.tenants_seen),
                                        remove=replica_id)
            new_owner_ids = {new for old, new in diff.values()
                             if old == replica_id}
        # Same pre-fence rule for the index stripes: the handoff plan
        # is "who inherits this replica's partitions", and a fenced
        # replica owns none.
        part_moved = self._partition_diff(remove=replica_id)
        self.ring.fence(replica_id)     # no fresh routes from here on
        migrated = 0
        if drain:
            migrated = self._handoff_queue(rep)
            self._handoff_warm_cache(rep, new_owner_ids)
            # Index handoff rides next to the warm Trust-DB one: the
            # leaving shard's postings travel to the stripes' new
            # owners instead of being re-indexed.
            self._move_partitions(part_moved, leaving=rep)
            self.stats.n_leaves += 1
        # Drop the member BEFORE journal replay so recovery routes and
        # twin-scans only see survivors.
        self._departed_sched[replica_id] = rep.scheduler.stats.as_dict()
        self.ring.remove(replica_id)
        self.replicas.remove(rep)
        del self.by_id[replica_id]
        if not drain:
            migrated = self._crash_recover()
            # The dead shard is gone wholesale: survivors re-index the
            # crashed stripes from the corpus (the corpus is durable
            # shared storage; only the built postings were lost).
            self._move_partitions(part_moved, rebuild=True)
            self.stats.n_crashes += 1
        if self.autoscaler is not None:
            self.autoscaler.forget(replica_id)
        self._attach_searcher()         # drop the departed shard
        return migrated

    def _queued_rids(self, exclude: Optional[ReplicaHandle] = None
                     ) -> set:
        """Request ids with a live queued copy anywhere in the fleet
        (optionally excluding one replica) — the hedge-twin scan."""
        return {q.request.request_id
                for rep in self.replicas if rep is not exclude
                for p in Priority
                for q in rep.bank.queues[p].entries()}

    def _handoff_queue(self, leaving: ReplicaHandle) -> int:
        """Drain-and-handoff: pop the leaving replica's queue in drain
        order and push each request to the ring's new owner for its
        tenant. EDF keys (absolute deadlines) travel with the requests,
        so every surviving queue stays EDF-ordered and no surviving
        head is displaced by anything later-deadlined."""
        twins = self._queued_rids(exclude=leaving)
        migrated = 0
        for qreq in leaving.export_queue():
            rid = qreq.request.request_id
            if rid in twins:
                # A hedge twin of this request is already queued on a
                # surviving replica — the race is decided by the leave:
                # keep the survivor, drop this copy.
                self.stats.n_handoff_twin_drops += 1
                self.stats.n_twin_drops += 1
                continue
            owner = self.by_id[self.ring.route(qreq.tenant)]
            # Same timeline rule as stealing: the request has been
            # queued since enqueue_t — the new owner's clock only lags
            # because nothing happened on it.
            owner.advance_to(qreq.enqueue_t)
            if owner.import_queued(qreq):
                migrated += 1
                self.stats.n_handoffs += 1
            else:                       # receiver full: explicit reject
                self._reject_overflow(owner, qreq)
        return migrated

    def _handoff_warm_cache(self, leaving: ReplicaHandle,
                            new_owner_ids: set) -> None:
        """Warm Trust-DB handoff (graceful leave): ship the leaving
        replica's top-K freshest ``(url, trust)`` cache entries to the
        ring's new owners through the existing ``apply_trust_deltas``
        path — the tenants' hot URLs keep answering from cache instead
        of re-warming one duplicate evaluation at a time through
        gossip. Inserts only, prior stays local (same poisoning
        isolation as gossip)."""
        if not new_owner_ids:
            return
        keys, vals = leaving.export_cache(
            self.cluster_cfg.warm_handoff_top_k)
        if len(keys) == 0:
            return
        delivered = False
        for rid in sorted(new_owner_ids):
            owner = self.by_id.get(rid)
            if owner is not None and owner is not leaving:
                owner.apply_trust_deltas(keys, vals)
                delivered = True
        if delivered:
            # Distinct (url, trust) pairs that left the replica — NOT
            # multiplied by the receiving fan-out.
            self.stats.n_warm_handoff_entries += len(keys)

    def _reject_overflow(self, owner: ReplicaHandle,
                         qreq: QueuedRequest) -> None:
        """Backpressure during a handoff: the receiving queue is full,
        so the request completes as an explicit prior-answered
        rejection (never a silent drop) on the receiving replica."""
        sched = owner.scheduler
        resp = sched._reject(qreq.request, qreq.priority,
                             sched.offered_regime(qreq.n_items),
                             REASON_QUEUE_FULL)
        sched.stats.n_rejected += 1
        sched.stats.rejected_by_reason[REASON_QUEUE_FULL] = \
            sched.stats.rejected_by_reason.get(REASON_QUEUE_FULL, 0) + 1
        owner.engine.completed.append(resp)

    def _crash_recover(self) -> int:
        """Journal replay after a crash: re-dispatch every admitted,
        unanswered request that has no live copy on a surviving replica
        (a queued hedge twin counts as the live copy) to the ring's new
        owner for its tenant. Re-entry happens at the fleet's current
        time — the latest arrival timestamp, not a busy sibling's
        backlog-inflated clock — with the ORIGINAL arrival and
        deadline, so recovered requests keep their EDF position and
        their latency accounting stays honest."""
        still_queued = self._queued_rids()
        now_t = self._now_hint
        recovered = 0
        for rid, e in sorted(self._journal.items()):
            if rid in self._responded or rid in still_queued:
                continue
            req = Request(rid, e.item_keys, e.buckets, e.features,
                          arrival_s=e.arrival_s, slo_s=e.slo_s,
                          needs_kv_slot=e.needs_kv_slot)
            qreq = QueuedRequest(request=req, priority=e.priority,
                                 tenant=e.tenant,
                                 deadline_t=e.arrival_s + e.slo_s,
                                 enqueue_t=now_t)
            owner = self.by_id[self.ring.route(e.tenant)]
            owner.advance_to(now_t)
            if owner.import_queued(qreq):
                recovered += 1
                self.stats.n_crash_recovered += 1
            else:
                self._reject_overflow(owner, qreq)
        return recovered

    def _autoscale_membership(
            self, heap: Optional[ReplicaLoadHeap] = None,
            forecast_pressure: Optional[float] = None) -> None:
        """Let the autoscaler's fleet-pressure vote change membership
        (bounded by [min_replicas, max_replicas], hysteresis inside the
        policy). Scale-down drains the lightest-loaded replica out —
        picked from the round's load heap in O(1) when one is live.
        Held steady while a rolling restart executes (fencing waves
        must not race membership changes).

        ``forecast_pressure`` (the planner's predicted utilization) is
        folded into the SAME vote, so a feedforward join shares the
        reactive cooldown window instead of bypassing it. A join voted
        while the planner is active is pre-warmed before it can serve
        and logged with the forecast that triggered it."""
        cc = self.cluster_cfg
        if self.autoscaler is None or cc.max_replicas <= 0 \
                or self._restart_hold:
            return
        vote = self.autoscaler.membership_decision(
            self.n_replicas, cc.min_replicas, cc.max_replicas,
            forecast_pressure=forecast_pressure)
        if vote > 0:
            rep = self.add_replica(prewarm=self.planner is not None)
            if self.planner is not None:
                self.planner_log.append({
                    "t": self._now_hint,
                    "event": "prewarm_join",
                    "replica": rep.replica_id,
                    "forecast_pressure": float(forecast_pressure or 0.0),
                    "pressure": float(self.autoscaler.pressure),
                    "n_replicas": self.n_replicas})
        elif vote < 0:
            victim_id = None
            if heap is not None and len(heap) == self.n_replicas:
                cold = heap.coldest()
                if cold is not None and cold[0] in self.by_id:
                    victim_id = cold[0]
            if victim_id is None:
                victim_id = min(
                    self.replicas,
                    key=lambda r: (r.queued_items, r.replica_id)
                ).replica_id
            self.remove_replica(victim_id, drain=True)

    # -- coordinated rolling restarts -----------------------------------------
    def plan_restart_waves(self, max_wave_frac: float = 0.25
                           ) -> List[List[str]]:
        """Pack the fleet into ring-disjoint restart waves.

        No replica shares a wave with one of its ring *inheritors*
        (the replicas its tenants and doc-partitions would route to
        while it is fenced): fencing a replica together with its
        successor would bounce the handed-off backlog twice and leave
        a tenant's whole route chain dark. Waves are additionally
        capped at ``max_wave_frac`` of the fleet (at least 1, at most
        n-1 — someone must stay up to serve)."""
        rids = sorted(self.by_id)
        n = len(rids)
        if n <= 1:
            raise ValueError(
                "rolling restart needs at least 2 replicas")
        cap = min(max(1, int(n * max_wave_frac)), n - 1)
        tenants = sorted(self.tenants_seen)
        succ: Dict[str, set] = {}
        for rid in rids:
            inheritors: set = set()
            if tenants:
                diff = self.ring.remap_diff(tenants, remove=rid)
                inheritors |= {new for old, new in diff.values()
                               if old == rid}
            if self.retrieval is not None:
                pdiff = self.ring.remap_diff(
                    self.retrieval.partition_keys(), remove=rid)
                inheritors |= {new for old, new in pdiff.values()
                               if old == rid}
            if not inheritors:
                # Owns no known tenant/partition: still keep its ring
                # sibling out of the wave (whoever WOULD inherit).
                sib = self.ring.sibling_for(rid, exclude=(rid,))
                if sib is not None:
                    inheritors.add(sib)
            succ[rid] = inheritors
        waves: List[List[str]] = []
        for rid in rids:
            placed = False
            for wave in waves:
                if len(wave) >= cap:
                    continue
                if all(rid not in succ[w] and w not in succ[rid]
                       for w in wave):
                    wave.append(rid)
                    placed = True
                    break
            if not placed:
                waves.append([rid])
        return waves

    def rolling_restart(self, downtime_s: float = 0.0,
                        max_wave_frac: float = 0.25
                        ) -> List[List[str]]:
        """Restart every replica in ring-disjoint waves without losing
        a request or a membership slot.

        Per wave: fence all members -> flush + collect their in-flight
        work -> hand the queued backlog off to the (unfenced) ring
        owners -> rebuild each member's engine in place (fresh
        scheduler/shedder/cache/prior — the index shard survives, it
        lives on durable storage; the warm cache does not, which is
        what a real process restart costs) -> unfence. The autoscaler
        holds membership steady for the whole plan
        (``_autoscale_membership`` is suppressed), and each member's
        pre-restart scheduler counters fold into the fleet-lifetime
        aggregate so ``scheduler_stats`` never dips. Returns the
        executed waves."""
        waves = self.plan_restart_waves(max_wave_frac)
        self._restart_hold = True
        try:
            for wave in waves:
                members = [self.by_id[r] for r in wave
                           if r in self.by_id]
                for rep in members:
                    self.ring.fence(rep.replica_id)
                for rep in members:
                    rep.engine.flush()
                self._collect()
                self._harvest_cache_deltas()
                for rep in members:
                    # Fenced => the ring routes every handed-off
                    # request to a surviving (unfenced) replica; hedge
                    # twins dedup exactly as on a graceful leave.
                    self._handoff_queue(rep)
                for rep in members:
                    self._bank_restart_stats(rep)
                    rep.restart(now_t=self._now_hint,
                                downtime_s=downtime_s)
                    self._attach_capacity(rep)
                    if self.autoscaler is not None:
                        self.autoscaler.forget(rep.replica_id)
                    self.stats.n_restarts += 1
                for rep in members:
                    self.ring.unfence(rep.replica_id)
                self._attach_searcher()
                self.stats.n_restart_waves += 1
        finally:
            self._restart_hold = False
        return waves

    _SCHED_INT_KEYS = ("n_submitted", "n_admitted", "n_rejected",
                       "n_batches", "n_batched_items", "n_hedges",
                       "n_executor_errors", "n_quarantined")

    @classmethod
    def _merge_sched_stats(cls, dst: Dict, src: Dict) -> None:
        for k in cls._SCHED_INT_KEYS:
            dst[k] = dst.get(k, 0) + src.get(k, 0)
        rbr = dst.setdefault("rejected_by_reason", {})
        for reason, c in src.get("rejected_by_reason", {}).items():
            rbr[reason] = rbr.get(reason, 0) + c

    def _bank_restart_stats(self, rep: ReplicaHandle) -> None:
        """Fold a replica's pre-restart scheduler counters into its
        lifetime base (the rebuilt engine starts from zero, the fleet
        aggregate must not)."""
        base = self._restart_sched_base.setdefault(
            rep.replica_id, {"rejected_by_reason": {}})
        self._merge_sched_stats(base, rep.scheduler.stats.as_dict())

    # -- Trust-DB gossip -----------------------------------------------------
    def _harvest_cache_deltas(self) -> None:
        """Collect every replica's fresh-evaluation taps: account
        fleet-wide duplicate evaluations, and (with gossip on) publish
        the deltas for this round's bounded broadcast."""
        for rep in self.replicas:
            for keys, vals in rep.take_cache_deltas():
                self.stats.n_eval_items += len(keys)
                for k in keys.tolist():
                    c = self._eval_counts.get(k, 0)
                    if c:
                        self.stats.n_duplicate_evals += 1
                    self._eval_counts[k] = c + 1
                if self.gossip is not None:
                    self.gossip.publish(rep.replica_id, keys, vals)

    # -- steal ---------------------------------------------------------------
    def _steal_rebalance(self,
                         heap: Optional[ReplicaLoadHeap] = None) -> None:
        """Migrate work from the hottest bank to the idlest while the
        imbalance exceeds the threshold. Steals come off the BACK of the
        victim's lowest-importance non-empty class and a class is never
        robbed below 2 entries, so every EDF head stays put. With
        ``cost_aware_steal`` the non-head candidate with the highest
        estimated eval cost on the victim (items x Trust-DB miss
        probability) leaves — a stolen chunk of cache-hot requests
        would displace cache-cold work only to re-evaluate warm items
        on the thief's cold cache.

        Hot/cold picks read the round's :class:`ReplicaLoadHeap` (each
        steal touches exactly two replicas, updated in O(log n))
        instead of re-sorting the fleet per iteration — the former
        O(steals x n log n) per-round scan cost, which is what capped
        the rebalancer at 32-64 replicas. Tie-breaks match the old
        ``sorted`` order exactly, so only the complexity changed."""
        if self.n_replicas < 2:
            return
        if heap is None:
            heap = ReplicaLoadHeap({r.replica_id: r.queued_items
                                    for r in self.replicas})
        # Per-scan cost memo: a candidate scored but left behind this
        # round keeps its score on the next steal_back call (a victim's
        # cache only changes when a batch lands, not mid-scan) —
        # scoring is a device lookup, so pay it once per (victim,
        # thief, entry). Keyed by victim too: the same request
        # re-scored on a different replica after a move sees THAT
        # replica's cache — and by thief, because decode KV-slot
        # pressure is a property of where the work would LAND.
        memo: Dict[tuple, float] = {}

        def _costed(rep, thief):
            def fn(qreq):
                key = (rep.replica_id, thief.replica_id, id(qreq))
                if key not in memo:
                    memo[key] = rep.steal_cost(qreq, thief=thief)
                return memo[key]
            return fn

        for _ in range(self.cluster_cfg.max_steals_per_round):
            cold, hot_top = heap.coldest(), heap.hottest()
            if cold is None or hot_top is None:
                break
            idle, hot = self.by_id[cold[0]], self.by_id[hot_top[0]]
            gap = hot_top[1] - cold[1]
            if gap < self.cluster_cfg.steal_threshold_items:
                break
            qreq = hot.bank.steal_back(
                cost_fn=(_costed(hot, idle)
                         if self.cluster_cfg.cost_aware_steal
                         else None))
            if qreq is None:            # nothing stealable (heads only)
                break
            if getattr(qreq.request, "needs_kv_slot", False):
                free = idle.kv_free_slots()
                if free is not None and free <= 0:
                    # Decode work cannot progress on a thief with no
                    # claimable KV slots — the cost fold already steers
                    # the picker away, but when every stealable entry
                    # is decode (the picker had nothing else), veto the
                    # migration outright: undo and stop this round.
                    hot.bank.push(qreq)
                    break
            if qreq.n_items >= gap:
                # Moving it would leave the gap as large or larger
                # (just inverted) — the same jumbo request would be
                # stolen straight back next iteration. Undo and stop.
                hot.bank.push(qreq)
                break
            # The request has been queued (hence stealable) since its
            # enqueue time — the victim's clock being further ahead only
            # means the victim already worked deep into ITS backlog.
            idle.advance_to(qreq.enqueue_t)
            if not idle.bank.push(qreq):
                hot.bank.push(qreq)     # thief full: undo, stop trying
                break
            self.stats.n_steals += 1
            heap.update(hot.replica_id, hot.queued_items)
            heap.update(idle.replica_id, idle.queued_items)

    # -- hedge ---------------------------------------------------------------
    def _backup_for(self, tenant: str, current: ReplicaHandle,
                    n_prior_hedges: int = 0
                    ) -> Optional[ReplicaHandle]:
        """Hedge target for the ``n_prior_hedges + 1``-th dispatch of a
        ``tenant`` request waiting on ``current``.

        The k-th hedge walks to the k-th distinct ring replica past the
        primary, so a RE-hedge (the backup is itself overloaded)
        escalates to a replica that does not already hold a copy
        instead of bouncing between the primary/backup pair. Skips
        ``current`` (a stolen copy may sit off its chain position);
        None once the chain is exhausted — every replica has a copy."""
        chain = self.ring.route_chain(tenant, self.n_replicas)
        for rid in chain[n_prior_hedges + 1:]:
            if rid != current.replica_id:
                return self.by_id[rid]
        return None

    def _hedge_scan(self) -> None:
        """Re-dispatch requests stuck past the hedge latency onto a real
        backup replica at CRITICAL priority. Twins race; ``_collect``
        keeps the first completion and drops the loser."""
        if self.hedge is None or self.hedge.budget_available < 1.0:
            return          # tokens only refill on enqueue, not mid-scan
        for rep in self.replicas:
            if rep.queued_items == 0:
                continue    # nothing waiting: skip the class walk
            now = rep.now()
            for p in Priority:
                for qreq in rep.bank.queues[p].entries():
                    if not self.hedge.should_hedge(
                            now - qreq.hedge_wait_base_t,
                            qreq.n_hedges):
                        continue
                    backup = self._backup_for(qreq.tenant, rep,
                                              qreq.n_hedges)
                    if backup is None:      # every replica has a copy
                        continue
                    # In continuous time the hedge fires the moment the
                    # wait (since the last dispatch) crosses the hedge
                    # latency.
                    fire_t = qreq.hedge_wait_base_t \
                        + self.hedge.hedge_after_s
                    backup.advance_to(fire_t)
                    if qreq.dispatch_twin(
                            backup.bank.queues[Priority.CRITICAL].push,
                            fire_t):
                        self.hedge.record_hedge()
                        self.stats.n_hedges += 1

    # -- drain ---------------------------------------------------------------
    def drain(self, max_rounds: Optional[int] = None) -> List[Response]:
        """Round-robin drain: poll + steal + hedge scans, then one
        micro-batch per replica, until every bank is empty and every
        pipeline window has landed (or ``max_rounds``). Returns the NEW
        responses produced (deduplicated).

        Fused replicas with ``pipeline_depth >= 2`` dispatch their
        batch and return WITHOUT syncing (``flush=False``): the device
        steps of round N overlap round N+1's steal/hedge scans and
        batch formation, instead of the fleet paying one full device
        round-trip per replica per round. The ``poll`` at the top of
        each round folds every batch that has since landed back into
        its replica's LoadMonitor / Trust-DB tap / response log FIRST,
        so the steal, hedge, autoscale, and gossip decisions that
        follow read stats as fresh as the hardware can make them —
        not one batch late (the former ROADMAP gap)."""
        produced: List[Response] = []
        rounds = 0
        while max_rounds is None or rounds < max_rounds:
            # Fold completed in-flight batches back BEFORE deciding
            # anything: steal/hedge/autoscale read fresh stats.
            for rep in self.replicas:
                rep.engine.poll()
            # ONE load index per round (O(n) heapify over the polled
            # queue depths): the steal loop updates it per steal and
            # the autoscale victim pick reads it, instead of each scan
            # re-sorting the fleet.
            heap = ReplicaLoadHeap({r.replica_id: r.queued_items
                                    for r in self.replicas})
            self._steal_rebalance(heap)
            self._hedge_scan()
            self._fanout_maintenance()
            any_batch = False
            for rep in list(self.replicas):
                # n_submitted counts rescued batches too: a batch whose
                # dispatch raised still consumed queue work (and was
                # prior-answered), so the round made progress.
                before = rep.scheduler.executor.n_submitted
                rep.engine.drain(max_batches=1, flush=False)
                any_batch |= \
                    rep.scheduler.executor.n_submitted > before
                if rep.replica_id in heap:
                    heap.update(rep.replica_id, rep.queued_items)
                if rep.replica_id in self._prewarm_watch \
                        and rep.scheduler.stats.n_batches > 0:
                    # First real batch after a pre-warmed join: any NEW
                    # warmup exclusion means a shape the prewarm
                    # missed — the join was cold after all.
                    if rep.warmup_exclusions() > \
                            self._prewarm_watch.pop(rep.replica_id):
                        self.stats.n_cold_joins += 1
            # Gossip: harvest this round's cache fills (duplicate-eval
            # accounting either way), then broadcast the freshest
            # deltas to siblings under the per-round budget.
            self._harvest_cache_deltas()
            if self.gossip is not None:
                self.gossip.flush(self.replicas)
            produced.extend(self._collect())
            rounds += 1
            self.stats.n_drain_rounds += 1
            if self.autoscaler is not None and \
                    self.stats.n_drain_rounds \
                    % max(self.cluster_cfg.autoscale_every, 1) == 0:
                self.last_snapshot = self.autoscaler.update(
                    self.replicas, self.tenants_seen)
                fp = None
                if self.planner is not None:
                    fp = self.planner.forecast_pressure(
                        self._now_hint,
                        rate_items_per_s=(
                            self.last_snapshot.rate_items_per_s))
                self._autoscale_membership(heap, forecast_pressure=fp)
            if not any_batch:
                # Queues are empty; land whatever is still in flight
                # (their fold-backs may gossip) and finish.
                for rep in self.replicas:
                    rep.engine.flush()
                self._harvest_cache_deltas()
                if self.gossip is not None:
                    self.gossip.flush(self.replicas)
                produced.extend(self._collect())
                break
        return produced

    def _collect(self) -> List[Response]:
        """Pull new responses off every replica, keeping the FIRST
        completion per request id (hedge losers are dropped here — the
        fleet-wide dedup).

        When both twins complete within the same collection window,
        "first" is decided by completion time — twins share an arrival,
        so lower latency IS earlier completion — not by replica scan
        order (the hedge exists precisely because the primary is slow,
        and scan order would keep the loser)."""
        window: List[Response] = []
        for rep in self.replicas:
            comp = rep.engine.completed
            while rep.n_collected < len(comp):
                window.append(comp[rep.n_collected])
                rep.n_collected += 1
        by_rid: Dict[int, Response] = {}
        order: List[int] = []
        for resp in window:
            rid = resp.request_id
            if rid in self._responded:      # twin answered last window
                self.stats.n_twin_drops += 1
                continue
            if rid in by_rid:               # both twins in this window
                self.stats.n_twin_drops += 1
                if resp.latency_s < by_rid[rid].latency_s:
                    by_rid[rid] = resp
                continue
            by_rid[rid] = resp
            order.append(rid)
        fresh = [by_rid[rid] for rid in order]
        for resp in fresh:
            self._responded.add(resp.request_id)
            self.completed.append(resp)
            self._journal.pop(resp.request_id, None)    # answered
            if resp.admitted:
                self.capacity.observe_queue(resp.queue_delay_s)
        return fresh

    # -- observability -------------------------------------------------------
    def slo_stats(self) -> Dict[str, float]:
        return slo_stats_of(self.completed)

    def scheduler_stats(self) -> Dict:
        """Fleet aggregate in the single-engine stats shape (drivers and
        reports consume both interchangeably), plus cluster extras."""
        agg: Dict = {k: 0 for k in self._SCHED_INT_KEYS}
        agg["rejected_by_reason"] = {}
        per_replica: Dict[str, Dict] = {}
        live = {rep.replica_id: rep.scheduler.stats.as_dict()
                for rep in self.replicas}
        # Departed replicas' final counters stay in the fleet aggregate
        # (membership churn must not erase submission history), and a
        # restarted replica's pre-restart base folds back under its
        # still-live id (the rebuilt engine counts from zero).
        for rid, s in list(self._departed_sched.items()) \
                + list(live.items()):
            entry: Dict = {"rejected_by_reason": {}}
            self._merge_sched_stats(entry, s)
            base = self._restart_sched_base.get(rid)
            if base is not None:
                self._merge_sched_stats(entry, base)
            entry["mean_batch_fill"] = (entry["n_batched_items"]
                                        / max(entry["n_batches"], 1))
            per_replica[rid] = entry
            self._merge_sched_stats(agg, entry)
        agg["n_hedges"] += self.stats.n_hedges
        agg["mean_batch_fill"] = (agg["n_batched_items"]
                                  / max(agg["n_batches"], 1))
        agg["cluster"] = self.stats.as_dict()
        agg["per_replica"] = per_replica
        if self.last_snapshot is not None:
            agg["autoscale"] = self.last_snapshot.as_dict()
        if self.gossip is not None:
            agg["gossip"] = self.gossip.stats.as_dict()
        if hasattr(self.searcher, "gather_stats"):
            agg["fanout"] = self.searcher.gather_stats()
        agg["capacity"] = self.capacity.fitted()
        if self.planner is not None:
            agg["forecast"] = {
                **self.planner.stats(),
                "n_prewarm_joins": self.stats.n_prewarm_joins,
                "n_cold_joins": self.stats.n_cold_joins,
                "log": list(self.planner_log)}
        return agg
