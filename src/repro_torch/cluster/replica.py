"""One serving replica: an independent engine the coordinator can hold.

``ReplicaHandle`` wraps a full single-host serving stack — its own
``ServingEngine`` and therefore its own ``Scheduler`` /
``PriorityQueueBank`` / ``LoadShedder`` / ``LoadMonitor`` / Trust-DB
cache / average-trust prior, plus an optional ``KVCachePool`` for LM
decode — so replicas shed, cache, and calibrate *independently* (one
hot replica extending its deadline never slows a cold sibling, and a
cache poisoned on one host stays on that host).

Simulated fleets give every replica its **own** ``SimClock``
(independent hardware runs in parallel; a shared clock would serialize
the fleet). The coordinator keeps the timelines coherent by
fast-forwarding a replica's clock to each event's global timestamp
(``advance_to``) — an idle replica's clock only lags because nothing
has happened on it.

Elastic membership needs two more facilities per replica:

* **queue snapshot export** (``export_queue``) — pops every queued
  request in drain order (strict priority, EDF within class) so a
  leaving replica's backlog hands off to the ring's new owners without
  reordering any EDF head; ``import_queued`` is the receiving side.
* **cache delta tap** — the shedder's ``on_shed`` hook records the
  ``(url_key, trust)`` pairs of every FRESH evaluation (a Trust-DB
  cache fill); ``take_cache_deltas`` drains them for the coordinator's
  gossip bus and ``apply_trust_deltas`` folds a sibling's broadcast
  into this replica's Trust-DB (cache-only — the prior stays local, so
  a poisoned sibling can at worst pre-warm cache entries that evict).

With a retrieval front end attached (``retrieval``), a replica
additionally OWNS an inverted-index ``shard`` — the merge of the
doc-partition stripes the ring assigns it under ``"docpart:p"`` keys.
Shards load on join, hand their postings off on graceful leave (next
to the warm Trust-DB handoff), and rebuild from the corpus after a
crash; the coordinator keeps the fleet-wide searcher pointed at the
live set.

Counterpart of ``repro.cluster.replica``. The replica's engine, Trust DB
and prior live on ``device`` (``cuda`` unless named). Its two Trust-DB
touch points, ``steal_cost`` (``TC.lookup``) and ``apply_trust_deltas``
(``TC.insert``), run there on the key arrays as they come: the
reference pads them to a power of two for its jit cache, and since key 0
never hits in ``lookup`` and is masked by ``insert``, the results are
the same without the padding.

Snapshots by reference (``prewarm`` restores ``sh.cache, sh.prior``) are
safe because ``TC.insert`` and ``AT.update`` return new tensors and
never write the ones they were given.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import TrustIRConfig
from repro_torch.core import trust_cache as TC
from repro_torch.core.load_monitor import LoadMonitor
from repro_torch.core.shedder import (ShedResult, SimClock, TIER_EVAL,
                                      keys_as_int32)
from repro_torch.scheduling import (PriorityQueueBank, QueuedRequest,
                                    Scheduler, SchedulerConfig)
from repro_torch.serving.engine import ServingEngine


class ReplicaHandle:
    def __init__(self, replica_id: str, cfg: TrustIRConfig,
                 evaluate_chunk: Callable, weight: float = 1.0,
                 sched_cfg: Optional[SchedulerConfig] = None,
                 sim_rate_items_per_s: Optional[float] = None,
                 kv_pool=None, request_ids=None,
                 drain_mode: Optional[str] = None,
                 evaluate_batch: Optional[Callable] = None,
                 retriever=None, feature_sharding=None, device=None):
        self.replica_id = replica_id
        self.weight = float(weight)
        # Doc-partitioned index shard this replica OWNS (the merge of
        # its ring stripes); None until the coordinator attaches one.
        # Ownership is about residency + handoff accounting — queries
        # scatter-gather across every live shard via the fleet searcher.
        self.shard = None
        # Mirror stripes this replica HOSTS for persistently slow
        # siblings (fanout selective replication): slow replica
        # id -> its mirrored IndexShard. Hedged shard probes land
        # here; regular fan-out never queries a mirror (the primary
        # already answers for those docs — exactly one answer per
        # shard enters the merge).
        self.mirrors: Dict[str, object] = {}
        self.clock = (SimClock(sim_rate_items_per_s)
                      if sim_rate_items_per_s is not None else None)
        # Construction state kept for in-place restarts (rolling
        # restarts rebuild the engine under the same id/weight/shard).
        self._ctor = dict(cfg=cfg, evaluate_chunk=evaluate_chunk,
                          sched_cfg=sched_cfg,
                          sim_rate_items_per_s=sim_rate_items_per_s,
                          kv_pool=kv_pool, request_ids=request_ids,
                          drain_mode=drain_mode,
                          evaluate_batch=evaluate_batch,
                          feature_sharding=feature_sharding,
                          device=device)
        # drain_mode/evaluate_batch pass straight through: a fused
        # replica runs ONE device step per micro-batch
        # (``core.fused_shedder``) instead of the host chunk loop.
        self.engine = self._build_engine(retriever)
        # Responses the coordinator has already collected from
        # ``engine.completed`` (consumption cursor).
        self.n_collected = 0
        # Fresh-evaluation (key, trust) batches awaiting gossip pickup.
        self._cache_deltas: List[Tuple[np.ndarray, np.ndarray]] = []
        # Optional per-batch measurement tap (the coordinator's
        # ServiceTimeModel): called with (shed_result, warm) where warm
        # is False when the batch met a first-sight shape — the
        # same exclusion rule the LoadMonitor applies.
        self.stats_tap: Optional[Callable[[ShedResult, bool], None]] = None
        self._excl_seen = self.warmup_exclusions()
        self.engine.shedder.on_shed = self._tap_shed

    def _build_engine(self, retriever) -> ServingEngine:
        c = self._ctor
        return ServingEngine(c["cfg"], c["evaluate_chunk"],
                             sim_clock=self.clock,
                             sched_cfg=c["sched_cfg"],
                             kv_pool=c["kv_pool"],
                             request_ids=c["request_ids"],
                             drain_mode=c["drain_mode"],
                             evaluate_batch=c["evaluate_batch"],
                             retriever=retriever,
                             feature_sharding=c["feature_sharding"],
                             device=c["device"])

    # -- forwarding accessors ------------------------------------------------
    @property
    def scheduler(self) -> Scheduler:
        return self.engine.scheduler

    @property
    def bank(self) -> PriorityQueueBank:
        return self.scheduler.bank

    @property
    def monitor(self) -> LoadMonitor:
        return self.engine.monitor

    @property
    def queued_requests(self) -> int:
        return len(self.bank)

    @property
    def queued_items(self) -> int:
        return self.bank.n_items

    # -- queue snapshot (drain-and-handoff) ----------------------------------
    def export_queue(self) -> List[QueuedRequest]:
        """Pop EVERY queued request in drain order (strict priority,
        EDF within each class) — the leaving replica's backlog snapshot.
        The bank is empty afterwards."""
        out: List[QueuedRequest] = []
        while True:
            qreq = self.bank.pop_next()
            if qreq is None:
                return out
            out.append(qreq)

    def import_queued(self, qreq: QueuedRequest) -> bool:
        """Receive a handed-off request into this replica's bank (same
        priority class, original deadline — the EDF key travels with
        the request)."""
        return self.bank.push(qreq)

    # -- Trust-DB gossip taps ------------------------------------------------
    def _tap_shed(self, item_keys: np.ndarray, result: ShedResult
                  ) -> None:
        """``on_shed`` hook: record the cache fills (freshly EVALuated
        keys and their trust) this shed produced, and feed the batch's
        service measurement to the capacity tap (warmup-flagged by
        whether the WarmupGate excluded a fresh signature during it)."""
        evald = result.tier == TIER_EVAL
        if evald.any():
            self._cache_deltas.append(
                (np.asarray(item_keys)[evald].astype(np.uint32),
                 result.trust[evald].astype(np.float32)))
        if self.stats_tap is not None:
            excl = self.warmup_exclusions()
            warm = excl == self._excl_seen
            self._excl_seen = excl
            self.stats_tap(result, warm)

    def take_cache_deltas(self) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Drain the pending cache-fill deltas (coordinator-side gossip
        harvest; also resets the tap buffer)."""
        out, self._cache_deltas = self._cache_deltas, []
        return out

    def kv_free_slots(self) -> Optional[int]:
        """Claimable decode KV slots on this replica (None when no
        ``KVCachePool`` is attached — non-decode serving)."""
        return self.scheduler._kv_free_slots()

    def steal_cost(self, qreq: QueuedRequest,
                   thief: Optional["ReplicaHandle"] = None) -> float:
        """Estimated evaluation cost of serving ``qreq`` HERE: items
        that would miss this replica's Trust-DB (a hit costs a probe, a
        miss costs a full evaluator forward). Cost-aware stealing ranks
        steal candidates by this, so a chunk of cache-hot requests is
        not shipped to a sibling whose cold cache would re-evaluate it
        while cache-cold work stays behind.

        With a ``thief`` named, decode KV-slot pressure folds in: a
        decode request (``needs_kv_slot``) scored against a thief with
        zero claimable ``KVCachePool`` slots costs ``-inf`` — it can
        make no progress there (the thief's batcher would just re-queue
        it), so the steal picker always prefers any other candidate,
        and the coordinator vetoes the migration outright if the picker
        had nothing else to offer."""
        if thief is not None \
                and getattr(qreq.request, "needs_kv_slot", False):
            free = thief.kv_free_slots()
            if free is not None and free <= 0:
                return float("-inf")
        keys = np.asarray(qreq.request.item_keys)
        if len(keys) == 0:
            return 0.0
        sh = self.engine.shedder
        _, hit = TC.lookup(sh.cache, torch.from_numpy(
            keys_as_int32(keys)).to(sh.device))
        return float(len(keys) - int(hit.sum()))

    # -- warm-state handoff (graceful leave) ---------------------------------
    def export_cache(self, top_k: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """The ``top_k`` FRESHEST ``(url_key, trust)`` Trust-DB entries
        (by insertion age) — the warm-state complement of
        ``export_queue``. A gracefully leaving replica ships these to
        the ring's new owners through the same ``apply_trust_deltas``
        path gossip uses, so its tenants' hot URLs stay answered from
        cache instead of re-warming one duplicate evaluation at a
        time."""
        cache = self.engine.shedder.cache
        keys = cache["keys"].reshape(-1).cpu().numpy().view(np.uint32)
        vals = cache["values"].reshape(-1).cpu().numpy()
        age = cache["age"].reshape(-1).cpu().numpy()
        live = keys != 0
        keys, vals, age = keys[live], vals[live], age[live]
        if len(keys) > top_k:
            sel = np.argpartition(-age, top_k - 1)[:top_k]
            keys, vals = keys[sel], vals[sel]
        return keys.astype(np.uint32), vals.astype(np.float32)

    def apply_trust_deltas(self, keys: np.ndarray,
                           values: np.ndarray) -> None:
        """Fold a sibling's gossiped (key, trust) pairs into this
        replica's Trust-DB cache. Inserts only — the average-trust
        prior stays strictly local."""
        if len(keys) == 0:
            return
        sh = self.engine.shedder
        dev = sh.device
        sh.cache = TC.insert(
            sh.cache, torch.from_numpy(keys_as_int32(keys)).to(dev),
            torch.from_numpy(np.asarray(values, np.float32)).to(dev),
            torch.ones((len(keys),), dtype=torch.bool, device=dev))

    # -- rolling restart -----------------------------------------------------
    def restart(self, *, now_t: float, downtime_s: float = 0.0) -> None:
        """Rebuild the serving stack in place (coordinated rolling
        restart). The handle keeps its identity — ``replica_id``,
        ``weight``, its ring-owned ``shard`` and hosted ``mirrors`` —
        but the engine comes back cold: fresh scheduler/bank/shedder/
        monitor state, empty Trust-DB cache, reset local prior, and a
        clean completed-responses log (the coordinator banks the old
        scheduler counters BEFORE calling this). The fresh simulated
        clock lands at ``now_t + downtime_s`` so post-restart work is
        stamped after the outage window, never before it.

        One thing deliberately SURVIVES the rebuild: the poison
        quarantine's breaker state. Forgetting it would make every
        rolling-restart wave re-eat ``k`` poison strikes per known-bad
        signature, so the old breakers are banked across the rebuild
        (next to the coordinator's scheduler-counter banking) and
        adopted by the fresh quarantine."""
        c = self._ctor
        rate = c["sim_rate_items_per_s"]
        old_quarantine = self.engine.scheduler.quarantine
        self.clock = SimClock(rate) if rate is not None else None
        retriever = getattr(self.engine, "retriever", None)
        self.engine = self._build_engine(retriever)
        new_quarantine = self.engine.scheduler.quarantine
        if old_quarantine is not None and new_quarantine is not None:
            new_quarantine.adopt(old_quarantine)
        self.n_collected = 0
        self._cache_deltas = []
        self._excl_seen = self.warmup_exclusions()
        self.engine.shedder.on_shed = self._tap_shed
        self.advance_to(float(now_t) + float(downtime_s))

    # -- prewarm (feedforward joins) ------------------------------------------
    def warmup_exclusions(self) -> int:
        """Lifetime count of WarmupGate first-sight exclusions on this
        replica's shedder — zero NEW exclusions across a batch means the
        batch ran entirely warm."""
        gate = getattr(self.engine.shedder, "_warmup", None)
        return int(gate.n_excluded) if gate is not None else 0

    def prewarm(self, feature_schema: Dict[str, Tuple[Tuple[int, ...], str]],
                n_items: int) -> None:
        """Prime the evaluator at production shapes BEFORE the ring
        routes real traffic here, so a feedforward join never lands
        cold mid-wave.

        Runs one synthetic full batch (``n_items`` at the live fleet's
        feature schema) straight through the shedder — deliberately NOT
        via the scheduler, so submit/enqueue counters and the no-drop
        accounting never see it. Serving state the synthetic batch
        would dirty is snapshotted and restored: Trust-DB cache, local
        prior, gossip delta tap, and the simulated clock (prewarm work
        is not real work). What survives is exactly the point — the
        first-use kernel builds and the WarmupGate's seen-signature
        set."""
        sh = self.engine.shedder
        n = max(int(n_items), 1)
        # Key range far above organic url_ids, so the synthetic lookup/
        # insert can never alias a real entry mid-call (the cache
        # snapshot is restored afterwards regardless).
        keys = (np.arange(n, dtype=np.int64) % 0x0FFFFFFF
                + 0xF0000000).astype(np.uint32)
        buckets = np.zeros(n, np.int32)
        feats = {k: np.zeros((n,) + tuple(shape), dtype=dtype)
                 for k, (shape, dtype) in feature_schema.items()}
        cache_snap, prior_snap = sh.cache, sh.prior
        deltas_snap, self._cache_deltas = self._cache_deltas, []
        t_snap = self.clock.t if self.clock is not None else None
        try:
            sh.process(keys, buckets, feats)
        finally:
            sh.cache, sh.prior = cache_snap, prior_snap
            self._cache_deltas = deltas_snap
            if self.clock is not None and t_snap is not None:
                self.clock.t = t_snap
            self._excl_seen = self.warmup_exclusions()

    # -- time -----------------------------------------------------------------
    def now(self) -> float:
        return self.engine._now()

    def advance_to(self, t: float) -> None:
        """Fast-forward a simulated clock to global time ``t`` (no-op on
        wall clocks, and never rewinds)."""
        if self.clock is not None:
            self.clock.t = max(self.clock.t, t)

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        return (f"ReplicaHandle({self.replica_id!r}, w={self.weight}, "
                f"queued={self.queued_requests})")
