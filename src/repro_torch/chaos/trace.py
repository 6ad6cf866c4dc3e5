"""Trace-driven chaos workload engine (seeded, deterministic).

The churn driver (``serving.simulator.run_churn_workload``) replays a
hand-written schedule against homogeneous Poisson arrivals. Real
overload is shaped: daily rate curves, flash crowds that multiply the
arrival rate for a window, a handful of tenants sending most of the
traffic, and hot URLs that every tenant floods at once. This module
generates that shape from ONE seed, as a concrete list of
:class:`TraceArrival` rows plus a scripted fault timeline — so a chaos
run is a pure function of its :class:`TraceConfig` and replays
bit-identically (the reference's determinism gate in
``benchmarks/bench_fleet.py`` hashes two replays of the same trace and
asserts equality).

Rate model — a non-homogeneous Poisson process sampled by thinning:

    rate(t) = base_qps * (1 + amplitude * sin(2*pi*t / period))
              * prod(flash.mult for flash windows containing t)

Candidate arrivals are drawn at the conservative upper bound ``rmax``
and accepted with probability ``rate(t)/rmax`` — textbook thinning, one
rng, draws in a fixed order, hence deterministic.

Fault timeline — heterogeneous event rows sorted by time:

* :class:`PoisonSpec` windows inject **query-of-death** arrivals:
  requests whose feature column ``POISON_FEATURE`` makes a
  :func:`poisonable`-wrapped evaluator raise (``POISON_RAISE``) or hang
  (``POISON_HANG``, surfaced as a watchdog :class:`EvaluatorHangError`
  — simulated serving has no preemption, so a detected hang and a
  crash reach the executor the same way: as an exception). Each window
  cycles ``n_signatures`` fixed ``death_query_*`` strings, so repeats
  share a work signature — exactly what the per-signature quarantine
  breaker keys on.
* :class:`RegionalFailure` crashes ``n_crash`` replicas on the same
  tick (heaviest-loaded first, the churn driver's worst case).
* :class:`RollingRestartEvent` triggers a coordinated fence+drain
  restart sweep (``ClusterCoordinator.rolling_restart``).
* :class:`SlowShardEvent` pins/clears a persistent shard slowdown.

Counterpart of ``repro.chaos.trace``: the same seeds give the same
arrivals and events. ``poisonable`` reads the poison column of a chunk
of tensors (the port's evaluator protocol) or of numpy arrays.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

from repro_torch.scheduling import Priority

# Reserved feature column carried by every chaos arrival (the batcher
# requires uniform feature keys across co-batched requests, so normal
# arrivals carry zeros rather than omitting the column).
POISON_FEATURE = "poison"
POISON_RAISE = 1.0                    # evaluator raises on this batch
POISON_HANG = 2.0                     # evaluator "hangs" (watchdog kill)


class PoisonPillError(RuntimeError):
    """The evaluator crashed on a query-of-death feature row."""


class EvaluatorHangError(RuntimeError):
    """The evaluator hung on a query-of-death feature row and was
    killed by the (simulated) watchdog."""


def poisonable(evaluate_chunk):
    """Wrap an evaluator so chaos traces can poison it: any chunk whose
    ``POISON_FEATURE`` column contains ``POISON_HANG`` raises
    :class:`EvaluatorHangError`; ``POISON_RAISE`` raises
    :class:`PoisonPillError`; clean chunks pass straight through. The
    wrapper is what makes a *request* lethal rather than a replica —
    wherever the batch lands (steal, hedge, handoff), it kills that
    evaluation, which is the behaviour the quarantine breaker exists to
    contain."""
    def wrapped(chunk):
        col = chunk.get(POISON_FEATURE)
        if col is not None and len(col):
            peak = float(col.max())         # numpy or torch alike
            if peak >= POISON_HANG:
                raise EvaluatorHangError(
                    "evaluator hang (watchdog kill) on poisoned batch")
            if peak >= POISON_RAISE:
                raise PoisonPillError(
                    "evaluator crash on poisoned batch")
        return evaluate_chunk(chunk)
    return wrapped


# ---------------------------------------------------------------------------
# Trace schema
# ---------------------------------------------------------------------------


@dataclass
class FlashCrowd:
    """Rate multiplier window (breaking-news spike)."""
    t_start: float
    t_end: float
    mult: float = 4.0


@dataclass
class PoisonSpec:
    """Query-of-death injection window: Poisson arrivals at ``qps``
    cycling ``n_signatures`` fixed death-query strings, concentrated on
    the first few tenants (a botnet flood hammers one entry point, so
    the quarantine-vs-baseline error contrast stays sharp)."""
    t_start: float
    t_end: float
    qps: float = 2.0
    n_signatures: int = 2
    mode: float = POISON_RAISE           # or POISON_HANG
    n_results: int = 256


@dataclass
class RegionalFailure:
    """``n_crash`` replicas crash on the same tick (correlated regional
    outage). Victims are the heaviest-loaded replicas — the churn
    driver's worst-case journal-replay pick — and the fleet never drops
    below one replica."""
    t: float
    n_crash: int = 3


@dataclass
class RollingRestartEvent:
    """Coordinated rolling restart sweep: fence + drain handoff in
    ring-disjoint waves (``ClusterCoordinator.rolling_restart``)."""
    t: float
    downtime_s: float = 0.0
    max_wave_frac: float = 0.25


@dataclass
class SlowShardEvent:
    """Pin (``action="slow"``) or clear (``"recover"``) a persistent
    service-time multiplier on a replica's index shard."""
    t: float
    action: str                          # "slow" | "recover"
    mult: float = 8.0

    def __post_init__(self) -> None:
        if self.action not in ("slow", "recover"):
            raise ValueError(f"unknown slow action {self.action!r}")


@dataclass
class TraceArrival:
    """One concrete arrival: everything the driver needs to enqueue it
    (``poison`` is the feature value the whole request carries —
    0.0 for clean traffic)."""
    t: float
    tenant: str
    priority: Priority
    n_results: int
    query: str
    poison: float = 0.0


@dataclass
class TraceConfig:
    duration_s: float = 10.0
    base_qps: float = 50.0
    # Diurnal curve: rate(t) = base * (1 + amplitude*sin(2*pi*t/period)).
    diurnal_amplitude: float = 0.5
    diurnal_period_s: float = 10.0
    # Zipf tenant skew: tenant of each arrival ~ min(Zipf(a), n)-1, so
    # tenant0 dominates and the tail is thin (multi-tenant fairness and
    # per-tenant rate limits see realistic imbalance).
    n_tenants: int = 8
    tenant_zipf_a: float = 1.4
    # Correlated hot-URL floods: this fraction of arrivals draws one of
    # ``n_hot_queries`` shared query strings — identical candidate URLs
    # fleet-wide, the load the Trust-DB gossip/cache layer absorbs.
    hot_url_frac: float = 0.3
    n_hot_queries: int = 4
    # Per-arrival result-count distribution (paper Zipf result sizes).
    zipf_a: float = 1.5
    min_results: int = 50
    max_results: int = 2000
    slo_s: float = 2.0
    critical_frac: float = 0.05
    seed: int = 0
    flash_crowds: List[FlashCrowd] = field(default_factory=list)
    poison: List[PoisonSpec] = field(default_factory=list)
    failures: List[RegionalFailure] = field(default_factory=list)
    restarts: List[RollingRestartEvent] = field(default_factory=list)
    slow_events: List[SlowShardEvent] = field(default_factory=list)

    def rate_at(self, t: float) -> float:
        r = self.base_qps * (1.0 + self.diurnal_amplitude
                             * np.sin(2.0 * np.pi * t
                                      / self.diurnal_period_s))
        for fc in self.flash_crowds:
            if fc.t_start <= t < fc.t_end:
                r *= fc.mult
        return max(float(r), 0.0)

    def rate_max(self) -> float:
        """Conservative thinning bound: peak diurnal rate times the
        product of every flash multiplier (windows may overlap)."""
        r = self.base_qps * (1.0 + abs(self.diurnal_amplitude))
        for fc in self.flash_crowds:
            r *= max(fc.mult, 1.0)
        return max(float(r), 1e-9)


def make_trace(cfg: TraceConfig
               ) -> Tuple[List[TraceArrival], List[object]]:
    """Materialize the trace: ``(arrivals, events)``, both time-sorted.
    Pure function of ``cfg`` — every rng is seeded from ``cfg.seed``
    and drawn in a fixed order, so two calls return identical lists
    (the bit-determinism the replay gate asserts)."""
    rng = np.random.default_rng(cfg.seed)
    rmax = cfg.rate_max()
    arrivals: List[TraceArrival] = []
    t = 0.0
    while True:
        t += float(rng.exponential(1.0 / rmax))
        if t >= cfg.duration_s:
            break
        # Thinning: draw accept + shape variates unconditionally so the
        # rng stream consumed per candidate is fixed-length (keeps the
        # trace stable under small config edits elsewhere).
        accept = rng.random() < cfg.rate_at(t) / rmax
        tenant = int(min(rng.zipf(cfg.tenant_zipf_a),
                         cfg.n_tenants)) - 1
        crit = rng.random() < cfg.critical_frac
        n_res = int(np.clip(rng.zipf(cfg.zipf_a) * cfg.min_results,
                            cfg.min_results, cfg.max_results))
        hot = rng.random() < cfg.hot_url_frac
        hot_id = int(rng.integers(cfg.n_hot_queries))
        if not accept:
            continue
        query = (f"hot_{hot_id}" if hot
                 else f"q_t{tenant}_{t:.6f}")
        arrivals.append(TraceArrival(
            t=t, tenant=f"tenant{tenant}",
            priority=Priority.CRITICAL if crit else Priority.NORMAL,
            n_results=n_res, query=query))
    # Query-of-death windows: independent sub-streams so adding or
    # resizing a window never perturbs the clean-traffic draws above.
    for si, spec in enumerate(cfg.poison):
        prng = np.random.default_rng((cfg.seed, 0xDEAD, si))
        pt, i = float(spec.t_start), 0
        while True:
            pt += float(prng.exponential(1.0 / max(spec.qps, 1e-9)))
            if pt >= min(spec.t_end, cfg.duration_s):
                break
            sig = i % max(spec.n_signatures, 1)
            arrivals.append(TraceArrival(
                t=pt,
                tenant=f"tenant{sig % min(3, cfg.n_tenants)}",
                priority=Priority.NORMAL,
                n_results=spec.n_results,
                query=f"death_query_{sig}",
                poison=spec.mode))
            i += 1
    arrivals.sort(key=lambda a: (a.t, a.query))
    events: List[object] = [*cfg.failures, *cfg.restarts,
                            *cfg.slow_events]
    events.sort(key=lambda e: e.t)
    return arrivals, events
