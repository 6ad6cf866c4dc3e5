"""The scheduling event loop: admit -> enqueue -> drain micro-batches.

Counterpart of ``repro.scheduling.scheduler`` (host logic, near
verbatim). The shedder's cache and prior live on its device; the one
place the scheduler reads them, the prior answer, copies the prior's
means to the host explicitly.

Ties the subsystem together in front of the Load Shedder:

  1. **Admit** (``submit``): classify the *offered* load (queued items +
     incoming candidates) into the paper's three regimes and apply the
     per-regime priority ladder (``priorities.AdmissionPolicy``) plus
     per-tenant token buckets (``ratelimit``). Rejections return an
     explicit ``Response`` answered from the average-trust prior —
     ``admitted=False``, machine-readable ``reason`` — never a silent
     drop.
  2. **Enqueue**: admitted requests enter per-priority EDF queues with
     static-capacity backpressure (``queues``).
  3. **Drain** (``drain``): the batcher coalesces queued requests into
     padded, budget-shaped micro-batches (``batcher``) and each batch
     goes through the :class:`~repro_torch.scheduling.executor.DrainExecutor`
     — a depth-k in-flight window over the shedder (host chunk loop or
     fused device step) that finalizes each batch as it lands, splits
     per-request responses, and rescues a batch whose executor raised
     by answering it from the average-trust prior. Requests that have
     waited past the hedge latency are re-dispatched at CRITICAL
     priority via ``distribution.fault_tolerance.HedgedDispatch``
     (first completion wins, twin is deduplicated).

The paper's no-drop invariant survives end to end: every *admitted*
request leaves ``drain`` with a trust value per item (property-tested
under all three regimes in ``tests/test_scheduling.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.configs.base import TrustIRConfig
from repro_torch.core.regimes import Regime, classify
from repro_torch.core.shedder import (LoadShedder, ShedResult, TIER_CACHED,
                                      TIER_EVAL, TIER_PRIOR)
from repro_torch.distribution.fault_tolerance import HedgedDispatch
from repro_torch.scheduling.batcher import MicroBatch, MicroBatcher
from repro_torch.scheduling.executor import DrainExecutor
from repro_torch.scheduling.priorities import (AdmissionPolicy, Priority,
                                               REASON_QUARANTINED,
                                               REASON_QUEUE_FULL,
                                               REASON_RATE_LIMITED)
from repro_torch.scheduling.quarantine import (PoisonQuarantine,
                                               work_signature)
from repro_torch.scheduling.queues import PriorityQueueBank, QueuedRequest
from repro_torch.scheduling.ratelimit import TenantRateLimiter


@dataclass
class Request:
    request_id: int
    item_keys: np.ndarray
    buckets: np.ndarray
    features: Dict[str, np.ndarray]
    arrival_s: float
    slo_s: float
    # LM decode requests must claim a KVCachePool slot to make progress;
    # the batcher keeps them queued while no slot is claimable instead of
    # spending batch budget they cannot use.
    needs_kv_slot: bool = False


@dataclass
class Response:
    request_id: int
    trust: np.ndarray
    tier: np.ndarray
    latency_s: float
    met_slo: bool
    shed: ShedResult
    priority: Priority = Priority.NORMAL
    admitted: bool = True
    reason: str = ""                 # rejection reason when not admitted
    queue_delay_s: float = 0.0
    hedged: bool = False


@dataclass
class SchedulerConfig:
    # Items per micro-batch; 0 derives Ucapacity + Uthreshold rounded up
    # to the evaluator chunk size (the budget `shed_plan` shapes to).
    max_batch_items: int = 0
    queue_capacity_requests: int = 1024      # per priority class
    low_watermark: float = 0.5
    normal_watermark: float = 0.9
    tenant_rate_items_per_s: float = float("inf")
    tenant_burst_items: float = float("inf")
    hedge_after_s: float = 0.0               # 0 disables hedging


def _round_up(n: int, mult: int) -> int:
    return -(-n // max(mult, 1)) * max(mult, 1)


@dataclass
class SchedulerStats:
    n_submitted: int = 0
    n_admitted: int = 0
    n_rejected: int = 0
    rejected_by_reason: Dict[str, int] = field(default_factory=dict)
    n_batches: int = 0
    n_batched_items: int = 0
    n_hedges: int = 0
    n_executor_errors: int = 0      # batches rescued from the prior
    n_quarantined: int = 0          # requests blocked by an open breaker

    def as_dict(self) -> Dict:
        return {"n_submitted": self.n_submitted,
                "n_admitted": self.n_admitted,
                "n_rejected": self.n_rejected,
                "rejected_by_reason": dict(self.rejected_by_reason),
                "n_batches": self.n_batches,
                "n_batched_items": self.n_batched_items,
                "n_hedges": self.n_hedges,
                "n_executor_errors": self.n_executor_errors,
                "n_quarantined": self.n_quarantined,
                "mean_batch_fill": (self.n_batched_items
                                    / max(self.n_batches, 1))}


class Scheduler:
    """Priority-aware admission + EDF queueing + micro-batched shedding.

    ``now`` is the clock (``time.monotonic`` or a ``SimClock.now``
    bound method) — shared with the shedder so queue delays and shed
    response times add up on one timeline.
    """

    def __init__(self, cfg: TrustIRConfig, shedder: LoadShedder,
                 sched_cfg: Optional[SchedulerConfig] = None,
                 now: Optional[Callable[[], float]] = None,
                 kv_pool=None):
        self.cfg = cfg
        # KVCachePool (or bare SlotAllocator) consulted by drain so
        # decode requests without a claimable slot stay queued; duck-
        # typed (anything with ``.alloc.free`` or ``.free``).
        self.kv_pool = kv_pool
        self.sched_cfg = sched_cfg or SchedulerConfig()
        self._now = now or shedder._now
        self.policy = AdmissionPolicy(
            low_watermark=self.sched_cfg.low_watermark,
            normal_watermark=self.sched_cfg.normal_watermark)
        self.bank = PriorityQueueBank(
            self.sched_cfg.queue_capacity_requests)
        self.limiter = TenantRateLimiter(
            self.sched_cfg.tenant_rate_items_per_s,
            self.sched_cfg.tenant_burst_items)
        self.max_batch_items = self.sched_cfg.max_batch_items or \
            _round_up(cfg.u_capacity + cfg.u_threshold, cfg.chunk_size)
        self.batcher = MicroBatcher(self.max_batch_items)
        self.hedge = (HedgedDispatch(self.sched_cfg.hedge_after_s)
                      if self.sched_cfg.hedge_after_s > 0 else None)
        self.stats = SchedulerStats()
        self._answered: set = set()   # rids whose hedged twin is queued
        # Poison-pill circuit breakers in front of the evaluator
        # (quarantine.PoisonQuarantine): quarantine_k = 0 disables and
        # keeps the pre-chaos submit path untouched.
        qk = getattr(cfg, "quarantine_k", 0)
        self.quarantine = (
            PoisonQuarantine(qk,
                             getattr(cfg, "quarantine_probe_after_s", 2.0),
                             self._now)
            if qk > 0 else None)
        # ONE execution pipeline for every drain path (host chunk loop,
        # fused device step, cluster round-robin): the executor owns
        # the depth-k in-flight window, per-batch completion, and
        # exception-mid-window rescue.
        self.executor = DrainExecutor(
            shedder, self._split_responses,
            depth=getattr(cfg, "pipeline_depth", 1),
            rescue=self._rescue_responses,
            on_error=(self._note_executor_error
                      if self.quarantine is not None else None))
        # Adaptive pipeline depth (cluster.depth): None when disabled —
        # the static-depth drain is then untouched. The coordinator
        # points ``depth_controller.model`` at the fleet's
        # ServiceTimeModel so the latency signal reads the same
        # per-stage fits the capacity planner maintains; standalone the
        # controller runs on the scheduler's own queue-delay EWMA.
        from repro_torch.cluster.depth import controller_from_config
        self.depth_controller = controller_from_config(cfg)
        self._queue_delay_ewma: Optional[float] = None

    # The executor runs whatever shedder the scheduler carries; keeping
    # the reference in ONE place lets baseline drivers swap shedders
    # (``engine.shedder = ProcessAll(...)``) without the pipeline and
    # the admission layer diverging.
    @property
    def shedder(self) -> LoadShedder:
        return self.executor.shedder

    @shedder.setter
    def shedder(self, s: LoadShedder) -> None:
        self.executor.shedder = s

    # -- admission ----------------------------------------------------------
    @property
    def queued_items(self) -> int:
        return self.bank.n_items

    def offered_regime(self, incoming_items: int = 0) -> Regime:
        ucap, uthr = self.shedder.monitor.parameters()
        return classify(self.bank.n_items + incoming_items, ucap, uthr)

    def submit(self, request: Request,
               priority: Priority = Priority.NORMAL,
               tenant: str = "default") -> Optional[Response]:
        """Admit or reject ``request``. Returns ``None`` when the request
        was queued, or the explicit rejection ``Response`` otherwise."""
        self.stats.n_submitted += 1
        now = self._now()
        n = len(request.item_keys)
        regime = self.offered_regime(n)
        reason = None
        # Poison quarantine runs FIRST (even CRITICAL traffic: a query
        # of death is toxic regardless of who asks) — but only once a
        # breaker exists, so un-struck traffic never pays the hash.
        if self.quarantine is not None and self.quarantine.any_tracked \
                and not self.quarantine.check(
                    work_signature(request.item_keys)):
            reason = REASON_QUARANTINED
            self.stats.n_quarantined += 1
        if reason is None:
            reason = self.policy.decide(priority, regime,
                                        self.bank.fill_frac(priority))
        if reason is None and \
                len(self.bank.queues[priority]) >= \
                self.bank.queues[priority].capacity:
            reason = REASON_QUEUE_FULL
        if reason is None and priority is not Priority.CRITICAL \
                and not self.limiter.allow(tenant, n, now):
            # Checked last (after the shed ladder AND backpressure) so
            # tokens are only consumed by requests that actually enter
            # the queue.
            reason = REASON_RATE_LIMITED
        if reason is None:
            qreq = QueuedRequest(request=request, priority=priority,
                                 tenant=tenant,
                                 deadline_t=request.arrival_s
                                 + request.slo_s,
                                 enqueue_t=now)
            admitted = self.bank.push(qreq)
            assert admitted          # capacity checked above
            self.stats.n_admitted += 1
            if self.hedge is not None:
                self.hedge.note_request()   # earn hedge budget
            return None
        self.stats.n_rejected += 1
        self.stats.rejected_by_reason[reason] = \
            self.stats.rejected_by_reason.get(reason, 0) + 1
        return self._reject(request, priority, regime, reason)

    def _prior_answer(self, request: Request, regime: Regime
                      ) -> tuple:
        """Answer a whole request from the average-trust prior (the
        shedder's own fallback tier): the shared construction behind
        explicit rejections AND executor-error rescues, so the two
        degraded paths can never diverge. Returns (trust, tier, shed,
        latency, met_slo) as of now."""
        n = len(request.item_keys)
        # the prior lives on the shedder's device: one explicit copy
        means = self.shedder.prior["mean"].cpu().numpy()
        trust = means[np.asarray(request.buckets) % len(means)
                      ].astype(np.float32)
        tier = np.full((n,), TIER_PRIOR, np.int32)
        shed = ShedResult(trust=trust, tier=tier, regime=regime,
                          response_time_s=0.0, deadline_eff_s=0.0,
                          n_evaluated=0, n_cached=0, n_prior=n, uload=n)
        latency = max(self._now() - request.arrival_s, 0.0)
        return trust, tier, shed, latency, \
            latency <= request.slo_s + 1e-9

    def _reject(self, request: Request, priority: Priority,
                regime: Regime, reason: str) -> Response:
        """Explicit rejection: answered from the average-trust prior,
        so even shed traffic leaves with a trust value per item."""
        trust, tier, shed, latency, met = self._prior_answer(request,
                                                             regime)
        return Response(request_id=request.request_id, trust=trust,
                        tier=tier, latency_s=latency, met_slo=met,
                        shed=shed, priority=priority, admitted=False,
                        reason=reason)

    # -- hedging ------------------------------------------------------------
    def _hedge_scan(self) -> None:
        """Re-dispatch long-waiting non-CRITICAL requests at CRITICAL
        priority (first completion wins; twin deduplicated in
        ``_execute``). Bounded by the hedge budget: ``max_hedges``
        re-issues per request, token-bucket capped as a fraction of
        admitted traffic."""
        if self.hedge.budget_available < 1.0:
            return          # tokens only refill on submit, not mid-scan
        now = self._now()
        crit = self.bank.queues[Priority.CRITICAL]
        for p in (Priority.HIGH, Priority.NORMAL, Priority.LOW):
            for qreq in self.bank.queues[p].entries():
                # The twin goes straight into the CRITICAL queue but
                # keeps its original priority for response accounting.
                if self.hedge.should_hedge(now - qreq.hedge_wait_base_t,
                                           qreq.n_hedges) \
                        and qreq.dispatch_twin(crit.push, now):
                    self.hedge.record_hedge()
                    self.stats.n_hedges += 1

    # -- drain --------------------------------------------------------------
    def _kv_free_slots(self) -> Optional[int]:
        """Claimable KV slots (None when no pool is attached). Accepts a
        ``KVCachePool`` or a bare ``SlotAllocator``."""
        if self.kv_pool is None:
            return None
        alloc = getattr(self.kv_pool, "alloc", self.kv_pool)
        return len(alloc.free)

    def drain(self, max_batches: Optional[int] = None,
              flush: Optional[bool] = None) -> List[Response]:
        """Form micro-batches and feed them through the
        :class:`~repro_torch.scheduling.executor.DrainExecutor` until the
        queues are empty (or ``max_batches`` is reached, or the head is
        a decode request with no claimable KV slot — which stays
        queued). Batches are dispatched with full padded arrays +
        ``n_valid`` so shapes stay static across drains and device ops
        reuse cached executables instead of recompiling per fill level.

        ``flush`` controls what happens to the executor's in-flight
        window on return. Default (``None``): flush — every response
        for the batches formed here is returned, the pre-executor
        contract. ``flush=False`` (honored only at ``pipeline_depth >=
        2``; depth 1 keeps the historical sync-on-return behaviour
        bit-for-bit) leaves up to depth batches in flight so a serving
        loop draining one batch per iteration overlaps device compute
        with the next iteration's admission and batch formation —
        their responses surface from a later ``drain``/``poll``/
        ``flush`` call."""
        out: List[Response] = []
        n_done = 0
        if self.depth_controller is not None:
            # One control tick per drain call: backlog in formable
            # batches vs the freshest queue-delay signal (local EWMA,
            # or the attached ServiceTimeModel's queue-stage fit when
            # no response has landed here yet).
            self.executor.set_depth(self.depth_controller.tick(
                backlog_batches=self.queued_items
                / max(self.max_batch_items, 1),
                queue_delay_s=self._queue_delay_ewma))
        # KV budget threads across the whole drain: slots are claimed by
        # the decode executor after responses land, so batches formed in
        # one drain must share the snapshot taken here.
        kv_budget = self._kv_free_slots()
        while max_batches is None or n_done < max_batches:
            if self.hedge is not None:
                self._hedge_scan()
            batch = self.batcher.form(self.bank, kv_free=kv_budget)
            if batch is None:
                break
            if kv_budget is not None:
                kv_budget -= sum(
                    1 for q, _, _ in batch.slices
                    if MicroBatcher._needs_kv_slot(q))
            out.extend(self.executor.submit(batch))
            n_done += 1
        if flush is None or flush or self.executor.depth <= 1:
            out.extend(self.executor.flush())
        return out

    def poll(self) -> List[Response]:
        """Finalize already-completed in-flight batches without
        blocking (fresh stats for steal/hedge/autoscale scans)."""
        return self.executor.poll()

    def flush(self) -> List[Response]:
        """Block until every in-flight batch has landed."""
        return self.executor.flush()

    def _note_executor_error(self, batch: MicroBatch,
                             exc: Exception) -> None:
        """Executor ``on_error`` observer: strike every distinct work
        signature in the failed batch. Innocent requests co-batched
        with a poison pill collect strikes too, but their signatures
        decay back to zero the next time they complete cleanly
        (``record_success``) — only work that fails persistently
        crosses the k-strike threshold."""
        sigs = {work_signature(qreq.request.item_keys)
                for qreq, _, _ in batch.slices}
        for sig in sorted(sigs):
            self.quarantine.record_failure(sig)

    def _rescue_responses(self, batch: MicroBatch,
                          exc: Exception) -> List[Response]:
        """Exception-mid-window recovery: a batch whose dispatch or
        finalize raised is answered from the average-trust prior —
        degraded service, never a dropped request (and never a torn
        window: the executor still finalizes every other in-flight
        batch). The error is counted, not re-raised: overload systems
        shed work, they don't shed the rest of the window."""
        self.stats.n_executor_errors += 1
        end = self._now()
        regime = self.offered_regime()
        responses: List[Response] = []
        for qreq, s, ln in batch.slices:
            rid = qreq.request.request_id
            if rid in self._answered:       # hedged twin already served
                self._answered.discard(rid)
                continue
            trust, tier, shed, latency, met = self._prior_answer(
                qreq.request, regime)
            responses.append(Response(
                request_id=rid, trust=trust, tier=tier,
                latency_s=latency, met_slo=met,
                shed=shed, priority=qreq.priority,
                reason=f"executor_error:{type(exc).__name__}",
                queue_delay_s=max(end - qreq.enqueue_t, 0.0),
                hedged=qreq.hedged))
            if qreq.hedged and self.hedge is not None:
                self._answered.add(rid)
        return responses

    def _split_responses(self, batch: MicroBatch,
                         shed: ShedResult) -> List[Response]:
        nv = batch.n_valid
        end = self._now()
        batch_start = end - shed.response_time_s
        self.stats.n_batches += 1
        self.stats.n_batched_items += nv
        if self.quarantine is not None and self.quarantine.any_tracked:
            # Clean completion: decay strikes / close half-open probes
            # for every signature this batch carried.
            for sig in sorted({work_signature(qreq.request.item_keys)
                               for qreq, _, _ in batch.slices}):
                self.quarantine.record_success(sig)
        if self.depth_controller is not None and batch.slices:
            # Latency signal for the adaptive-depth controller: EWMA of
            # per-batch queue delay (batch start - earliest enqueue).
            delay = max(batch_start
                        - min(q.enqueue_t for q, _, _ in batch.slices),
                        0.0)
            self._queue_delay_ewma = (
                delay if self._queue_delay_ewma is None
                else 0.7 * self._queue_delay_ewma + 0.3 * delay)
        responses: List[Response] = []
        for qreq, s, ln in batch.slices:
            rid = qreq.request.request_id
            if rid in self._answered:       # hedged twin already served
                self._answered.discard(rid)
                continue
            tier = shed.tier[s:s + ln]
            sub = ShedResult(
                trust=shed.trust[s:s + ln], tier=tier,
                regime=shed.regime,
                response_time_s=shed.response_time_s,
                deadline_eff_s=shed.deadline_eff_s,
                n_evaluated=int((tier == TIER_EVAL).sum()),
                n_cached=int((tier == TIER_CACHED).sum()),
                n_prior=int((tier == TIER_PRIOR).sum()),
                uload=shed.uload)
            latency = end - qreq.request.arrival_s
            responses.append(Response(
                request_id=rid, trust=sub.trust, tier=tier,
                latency_s=latency,
                met_slo=latency <= qreq.request.slo_s + 1e-9,
                shed=sub, priority=qreq.priority,
                queue_delay_s=max(batch_start - qreq.enqueue_t, 0.0),
                hedged=qreq.hedged))
            if qreq.hedged and self.hedge is not None:
                # Skip the twin queued in THIS scheduler later. When the
                # twin lives on another replica (cluster hedging, where
                # self.hedge is None), the ClusterCoordinator owns the
                # fleet-wide dedup instead.
                self._answered.add(rid)
        return responses
