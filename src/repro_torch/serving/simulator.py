"""Overload simulator: the experimental driver behind the paper figures.

Counterpart of ``repro.serving.simulator`` (host logic, copied). It
generates a query stream with Poisson arrivals; each query retrieves a
Zipf-distributed number of result URLs (common keywords like "book" pull
hundreds of thousands — paper §6). The simulator advances a
deterministic clock, feeds each query through a pipeline variant, and
collects response-time / trust-fidelity / recall distributions.

* :func:`run_workload` — the single-stream pipeline driver behind the
  paper figures (synchronous, one query at a time).
* :func:`run_scheduled_workload` — multi-tenant Poisson arrivals with a
  priority mix per tenant, driven through the scheduled
  ``ServingEngine``: requests enqueue as they arrive and drain in
  micro-batches, reporting per-priority latency, admission outcomes,
  and regime mix.

* :func:`run_cluster_workload` — the same arrival model against an
  N-replica ``ClusterCoordinator`` (``cluster``): tenants route through
  the consistent-hash ring, replicas drain round-robin on independent
  simulated clocks, queues rebalance by work-stealing, and stuck
  requests hedge onto real backup replicas.
* :func:`run_churn_workload` — the cluster driver under *membership
  churn*: a deterministic schedule of join / graceful-leave / crash
  events fires as the arrival clock passes each event time.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.pipeline import SyntheticSearcher, TrustIRPipeline
from repro_torch.scheduling import Priority


@dataclass
class WorkloadConfig:
    n_queries: int = 50
    arrival_rate_qps: float = 5.0
    zipf_a: float = 1.5                 # result-count distribution
    min_results: int = 50
    max_results: int = 5000
    seed: int = 0


@dataclass
class SimReport:
    response_times: np.ndarray
    fidelities: np.ndarray
    recalls: np.ndarray
    regimes: List[str]
    n_eval: np.ndarray
    n_cached: np.ndarray
    n_prior: np.ndarray

    def percentile(self, p: float) -> float:
        return float(np.percentile(self.response_times, p))

    def summary(self) -> Dict[str, float]:
        return {
            "p50_rt_s": self.percentile(50),
            "p99_rt_s": self.percentile(99),
            "mean_rt_s": float(self.response_times.mean()),
            "mean_fidelity": float(self.fidelities.mean()),
            "mean_recall": float(self.recalls.mean()),
            "frac_heavy+": float(np.mean([r != "NORMAL"
                                          for r in self.regimes])),
        }


def run_workload(pipeline: TrustIRPipeline, wl: WorkloadConfig
                 ) -> SimReport:
    r = np.random.default_rng(wl.seed)
    rts, fids, recalls, regimes = [], [], [], []
    n_eval, n_cached, n_prior = [], [], []
    queries = [f"query_{int(q)}"
               for q in r.zipf(1.3, size=wl.n_queries) % 50]
    for qi, q in enumerate(queries):
        n_res = int(np.clip(r.zipf(wl.zipf_a) * wl.min_results,
                            wl.min_results, wl.max_results))
        out = pipeline.run_query(q, n_res)
        rts.append(out.response_time_s)
        fids.append(out.trust_fidelity)
        recalls.append(out.recall)
        regimes.append(out.shed.regime.name)
        n_eval.append(out.shed.n_evaluated)
        n_cached.append(out.shed.n_cached)
        n_prior.append(out.shed.n_prior)
    return SimReport(
        response_times=np.asarray(rts), fidelities=np.asarray(fids),
        recalls=np.asarray(recalls), regimes=regimes,
        n_eval=np.asarray(n_eval), n_cached=np.asarray(n_cached),
        n_prior=np.asarray(n_prior))


# ---------------------------------------------------------------------------
# Multi-tenant scheduled workloads (scheduling driver)
# ---------------------------------------------------------------------------


@dataclass
class TenantSpec:
    """One traffic source: Poisson arrivals at ``qps`` with a priority
    mix (weights need not be normalized)."""
    name: str
    qps: float
    priority_mix: Dict[Priority, float] = field(
        default_factory=lambda: {Priority.NORMAL: 1.0})
    zipf_a: float = 1.5
    min_results: int = 50
    max_results: int = 5000
    slo_s: Optional[float] = None       # None -> engine default


@dataclass
class MultiTenantWorkload:
    tenants: List[TenantSpec]
    n_queries: int = 200                # total, split by tenant qps share
    seed: int = 0
    # A ``retrieval.ZipfQueryModel`` (or any ``sample(rng) -> str``):
    # arrivals then carry query strings drawn from the SAME Zipf vocab
    # the corpus generator used, so hot-term floods hit the same docs
    # across tenants. None keeps the legacy per-arrival unique query
    # string.
    query_model: Optional[object] = None


@dataclass
class SchedSimReport:
    responses: List                      # scheduling.Response, completion order
    scheduler_stats: Dict
    # (t, action, replica_id, n_replicas_after) rows from churn runs.
    churn_log: List[Tuple] = field(default_factory=list)

    def _admitted(self):
        return [r for r in self.responses if r.admitted]

    def latency_by_priority(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for p in Priority:
            lat = np.asarray([r.latency_s for r in self._admitted()
                              if r.priority == p])
            if len(lat):
                out[p.name] = {"n": int(len(lat)),
                               "p50_s": float(np.percentile(lat, 50)),
                               "p99_s": float(np.percentile(lat, 99))}
        return out

    def summary(self) -> Dict:
        adm = self._admitted()
        rej = [r for r in self.responses if not r.admitted]
        lat = np.asarray([r.latency_s for r in adm])
        regimes = [r.shed.regime.name for r in adm]
        return {
            "n_responses": len(self.responses),
            "n_admitted": len(adm),
            "n_rejected": len(rej),
            # None (not a fake 0.0) when nothing was admitted — a fully
            # throttled run must not report a perfect scoreboard.
            "p50_s": float(np.percentile(lat, 50)) if adm else None,
            "p99_s": float(np.percentile(lat, 99)) if adm else None,
            "slo_met_frac": float(np.mean([r.met_slo for r in adm]))
            if adm else None,
            "frac_heavy+": float(np.mean([g != "NORMAL"
                                          for g in regimes]))
            if regimes else 0.0,
            "by_priority": self.latency_by_priority(),
            "rejected_by_reason": self.scheduler_stats
            .get("rejected_by_reason", {}),
            "n_hedges": self.scheduler_stats.get("n_hedges", 0),
        }


def _draw_priority(rng: np.random.Generator,
                   mix: Dict[Priority, float]) -> Priority:
    ps = list(mix.keys())
    w = np.asarray([mix[p] for p in ps], np.float64)
    return ps[int(rng.choice(len(ps), p=w / w.sum()))]


def make_arrivals(wl: MultiTenantWorkload
                  ) -> List[Tuple[float, TenantSpec, Priority, int, str]]:
    """Merged per-tenant Poisson processes:
    ``[(t_arrival, tenant, priority, n_results, query), ...]``
    time-sorted. Queries come from ``wl.query_model`` when set (drawn
    in arrival order from a separate rng stream, so attaching a model
    never perturbs the timing/priority/size draws); the default is the
    legacy per-arrival unique string ``"{tenant}_{t:.6f}"``."""
    rng = np.random.default_rng(wl.seed)
    total_qps = sum(t.qps for t in wl.tenants)
    events = []
    for tn in wl.tenants:
        n = max(1, round(wl.n_queries * tn.qps / max(total_qps, 1e-9)))
        t = 0.0
        for _ in range(n):
            t += float(rng.exponential(1.0 / max(tn.qps, 1e-9)))
            n_res = int(np.clip(rng.zipf(tn.zipf_a) * tn.min_results,
                                tn.min_results, tn.max_results))
            events.append((t, tn, _draw_priority(rng, tn.priority_mix),
                           n_res))
    events.sort(key=lambda e: e[0])
    # Query strings assign AFTER the sort so the draw order (and thus
    # which arrival gets which hot term) is the global arrival order —
    # deterministic and independent of the per-tenant loop above.
    qrng = np.random.default_rng(wl.seed + 0x5eed)
    return [(t, tn, prio, n_res,
             (wl.query_model.sample(qrng) if wl.query_model is not None
              else f"{tn.name}_{t:.6f}"))
            for t, tn, prio, n_res in events]


def run_scheduled_workload(engine, searcher: SyntheticSearcher,
                           wl: MultiTenantWorkload) -> SchedSimReport:
    """Drive a scheduled ``ServingEngine`` with multi-tenant Poisson
    arrivals. Under a ``SimClock`` the clock fast-forwards to each
    arrival; a micro-batch drains whenever the queued candidate count
    reaches the batch budget, plus a final flush."""
    clock = engine.sim_clock
    n0 = len(engine.completed)
    for t_arr, tenant, prio, n_res, query in make_arrivals(wl):
        if clock is not None:
            clock.t = max(clock.t, t_arr)
        res = searcher.search(query, n_res)
        feats = dict(res.features)
        feats["trust"] = res.exact_trust    # oracle evaluators may use it
        engine.enqueue(res.url_ids, res.buckets, feats,
                       slo_s=tenant.slo_s, priority=prio,
                       tenant=tenant.name)
        if engine.scheduler.queued_items >= \
                engine.scheduler.max_batch_items:
            # The serving-loop drain pattern: with pipeline_depth >= 2
            # (wall-clock fused engines) the batch stays in flight and
            # its device step overlaps the next arrivals; simulated
            # clocks are sequential, so there flush=False is a no-op.
            engine.drain(max_batches=1, flush=False)
    engine.drain()
    return SchedSimReport(responses=list(engine.completed[n0:]),
                          scheduler_stats=engine.scheduler_stats())


def run_cluster_workload(coordinator, searcher: SyntheticSearcher,
                         wl: MultiTenantWorkload) -> SchedSimReport:
    """Drive an N-replica ``ClusterCoordinator`` with the same
    multi-tenant Poisson arrival stream as
    :func:`run_scheduled_workload` (``n_replicas=1`` reproduces it).

    Arrivals carry their global timestamp so each routed replica's
    simulated clock fast-forwards onto the shared timeline; a drain
    round (one micro-batch per replica, preceded by steal + hedge
    scans) fires whenever the fleet backlog reaches one per-replica
    batch budget, plus a final flush."""
    n0 = len(coordinator.completed)
    for t_arr, tenant, prio, n_res, query in make_arrivals(wl):
        res = searcher.search(query, n_res)
        feats = dict(res.features)
        feats["trust"] = res.exact_trust
        coordinator.enqueue(res.url_ids, res.buckets, feats,
                            slo_s=tenant.slo_s, priority=prio,
                            tenant=tenant.name, t_arrival=t_arr)
        # One round drains up to one batch per replica: let a full
        # round's worth of backlog build (keeps batches full AND gives
        # the steal scan material to rebalance with).
        if coordinator.queued_items >= coordinator.max_batch_items \
                * coordinator.n_replicas:
            coordinator.drain(max_rounds=1)
    coordinator.drain()
    return SchedSimReport(responses=list(coordinator.completed[n0:]),
                          scheduler_stats=coordinator.scheduler_stats())


# ---------------------------------------------------------------------------
# Membership churn (elastic cluster driver)
# ---------------------------------------------------------------------------


@dataclass
class ChurnEvent:
    """One scheduled membership change.

    ``replica_id=None`` lets the driver pick deterministically: a
    graceful ``leave`` drains out the lightest-loaded replica (cheapest
    handoff), a ``crash`` kills the heaviest-loaded one (worst-case
    journal replay), and a ``slow``/``recover`` pair degrades (then
    heals) the lexicographically-first live replica.

    ``slow`` pins a persistent service-time multiplier (``mult``) on
    the replica's index shard through the coordinator's fanout service
    model (``set_shard_slowdown``) — the degraded-disk scenario that
    drives selective stripe replication; ``recover`` clears it. Both
    are no-ops on fleets without a fanout model."""
    t: float
    action: str       # "join" | "leave" | "crash" | "slow" | "recover"
    replica_id: Optional[str] = None
    weight: float = 1.0
    mult: float = 8.0                    # "slow" service multiplier

    def __post_init__(self) -> None:
        if self.action not in ("join", "leave", "crash", "slow",
                               "recover"):
            raise ValueError(f"unknown churn action {self.action!r}")


def apply_churn_event(coordinator, ev: ChurnEvent) -> Tuple:
    """Fire one :class:`ChurnEvent` against a live coordinator and
    return a ``(t, action, replica_id, n_replicas)`` log row. Public so
    scripted fault timelines (``chaos``) reuse the exact same
    deterministic victim picks as the churn driver."""
    if ev.action == "join":
        h = coordinator.add_replica(weight=ev.weight,
                                    replica_id=ev.replica_id,
                                    now_t=ev.t)
        return (ev.t, "join", h.replica_id, coordinator.n_replicas)
    if ev.action in ("slow", "recover"):
        rid = ev.replica_id or min(r.replica_id
                                   for r in coordinator.replicas)
        coordinator.set_shard_slowdown(
            rid, ev.mult if ev.action == "slow" else 1.0)
        return (ev.t, ev.action, rid, coordinator.n_replicas)
    if coordinator.n_replicas <= 1:      # never kill the last replica
        return (ev.t, f"{ev.action}-skipped", None,
                coordinator.n_replicas)
    rid = ev.replica_id
    if rid is None:
        key = (min if ev.action == "leave" else max)
        rid = key(coordinator.replicas,
                  key=lambda r: (r.queued_items, r.replica_id)
                  ).replica_id
    coordinator.remove_replica(rid, drain=(ev.action == "leave"))
    return (ev.t, ev.action, rid, coordinator.n_replicas)


def run_churn_workload(coordinator, searcher: SyntheticSearcher,
                       wl: MultiTenantWorkload,
                       schedule: List[ChurnEvent],
                       round_s: Optional[float] = None
                       ) -> SchedSimReport:
    """:func:`run_cluster_workload` under membership churn: each
    :class:`ChurnEvent` fires once the arrival clock passes its ``t``
    (events with ``t`` past the last arrival fire before the final
    flush). Deterministic end to end — same seed, same schedule, same
    responses — which is what makes the chaos tests assertable.

    Unlike :func:`run_cluster_workload`'s backlog-size drain trigger
    (whose threshold scales with fleet size — a bigger fleet would wait
    for a DEEPER backlog, penalizing joins), drains here fire on a time
    cadence: one round per ``round_s`` of arrival time (default: one
    per-replica batch service time), the way a continuously-busy
    serving loop behaves. Membership-size effects then show up as real
    capacity, not as driver batching artifacts. An empty ``schedule``
    makes this the churn-free baseline driver."""
    churn = sorted(schedule, key=lambda e: e.t)
    ci = 0
    log: List[Tuple] = []
    n0 = len(coordinator.completed)
    if round_s is None:
        clock = coordinator.replicas[0].clock
        rate = clock.rate if clock is not None else None
        round_s = (coordinator.max_batch_items / rate
                   if rate else 0.05)
    next_drain = round_s
    for t_arr, tenant, prio, n_res, query in make_arrivals(wl):
        while ci < len(churn) and churn[ci].t <= t_arr:
            log.append(apply_churn_event(coordinator, churn[ci]))
            ci += 1
        res = searcher.search(query, n_res)
        feats = dict(res.features)
        feats["trust"] = res.exact_trust
        coordinator.enqueue(res.url_ids, res.buckets, feats,
                            slo_s=tenant.slo_s, priority=prio,
                            tenant=tenant.name, t_arrival=t_arr)
        while next_drain <= t_arr:
            coordinator.drain(max_rounds=1)
            next_drain += round_s
    while ci < len(churn):               # events past the last arrival
        log.append(apply_churn_event(coordinator, churn[ci]))
        ci += 1
    coordinator.drain()
    return SchedSimReport(responses=list(coordinator.completed[n0:]),
                          scheduler_stats=coordinator.scheduler_stats(),
                          churn_log=log)
