"""Feedforward capacity planning: measured service times -> what-if -> joins.

Counterpart of ``repro.cluster.capacity`` (host logic, copied).

The watermark autoscaler (``autoscale_watermarks.py``) is reactive: it
votes on a pressure EWMA that only rises once queues have already
built, so a diurnal ramp is served one EWMA lag late and the join lands
cold (first-use kernel builds and allocator growth) in the middle
of the wave.  Following the capacity-planning
line of work for vertical search engines (arxiv 1006.5059 in
PAPERS.md), this module closes the loop *ahead* of the breach:

``ServiceTimeModel``
    fits per-stage service-time distributions (retrieve, queue, batch,
    device step, gather) from the same measurements the serving path
    already makes — ``LoadMonitor`` observations (which inherit the
    WarmupGate exclusion and the executor's marginal-window charging)
    and per-batch drain stats tapped off the shedder.  The model is
    keyed by the configuration it measured (``drain_mode``,
    ``pipeline_depth``, batch budget) so fits are never blended across
    regimes that execute differently.

``predict(...)``
    a closed queueing-network what-if: replays a workload's arrival
    curve through a deterministic mini-model of the fleet (consistent-
    ring routing, per-replica batch queues, the real effective-deadline
    eval budget, fitted service rates) and returns predicted
    ``(throughput, p99)`` for a hypothetical ``(n_replicas, depth,
    batch)`` without running the fleet.

``ForecastPlanner``
    estimates the arrival curve's NHPP rate over a sliding window,
    linearly extrapolates it ``warmup_lead_s`` ahead, and converts the
    predicted rate into a *forecast pressure* (predicted utilization of
    the fleet's measured service rate).  The coordinator feeds that
    into ``WatermarkAutoscaler.membership_decision`` so scale-up
    triggers before the watermark breach — and through the same
    cooldown bookkeeping as a reactive vote, so feedforward and
    reactive joins can never double-fire inside one cooldown window.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.deadline import effective_deadline
from repro_torch.cluster.routing import ConsistentHashRing


# ---------------------------------------------------------------------------
# per-stage accumulator
# ---------------------------------------------------------------------------

class StageStats:
    """Bounded per-stage accumulator of ``(n_items, elapsed_s)`` samples."""

    __slots__ = ("n", "sum_items", "sum_s", "_elapsed", "max_samples")

    def __init__(self, max_samples: int = 4096):
        self.n = 0
        self.sum_items = 0.0
        self.sum_s = 0.0
        self._elapsed: Deque[float] = deque(maxlen=max_samples)
        self.max_samples = max_samples

    def observe(self, n_items: float, elapsed_s: float) -> None:
        if elapsed_s < 0.0:
            return
        self.n += 1
        self.sum_items += float(n_items)
        self.sum_s += float(elapsed_s)
        self._elapsed.append(float(elapsed_s))

    @property
    def rate_items_per_s(self) -> Optional[float]:
        """Aggregate items/s — the fit a queueing model wants, robust to
        per-sample jitter because it weights by window length."""
        if self.sum_s <= 0.0:
            return None
        return self.sum_items / self.sum_s

    def mean_s(self) -> Optional[float]:
        if self.n == 0:
            return None
        return self.sum_s / self.n

    def percentile_s(self, q: float) -> Optional[float]:
        if not self._elapsed:
            return None
        return float(np.percentile(np.asarray(self._elapsed), q))

    def summary(self) -> Dict[str, Optional[float]]:
        return {
            "n": self.n,
            "mean_s": self.mean_s(),
            "p50_s": self.percentile_s(50.0),
            "p99_s": self.percentile_s(99.0),
            "rate_items_per_s": self.rate_items_per_s,
        }


# ---------------------------------------------------------------------------
# service-time model
# ---------------------------------------------------------------------------

STAGE_RETRIEVE = "retrieve"
STAGE_QUEUE = "queue"
STAGE_BATCH = "batch"
STAGE_DEVICE = "device"
STAGE_GATHER = "gather"
STAGES = (STAGE_RETRIEVE, STAGE_QUEUE, STAGE_BATCH, STAGE_DEVICE,
          STAGE_GATHER)


class ServiceTimeModel:
    """Per-stage service-time fit for ONE ``(drain_mode, pipeline_depth,
    batch_items)`` serving configuration.

    Stage sources, and why each is honest:

    - ``device``: tapped off ``LoadMonitor.observe`` via ``on_observe``.
      The monitor only sees windows the WarmupGate admitted (first-sight
      warmup excluded) and, at ``pipeline_depth > 1``, only the *marginal*
      window since the previous completion — so fitted device rates are
      invariant to depth instead of double-counting overlapped work.
    - ``batch``: whole-batch drain service tapped off the shedder
      (``uload``, ``n_evaluated``, ``response_time_s``).  Warmup batches
      — detected by the WarmupGate's exclusion counter moving — are
      dropped here too, with the drop counted in
      ``n_warmup_excluded``.  On simulated clocks this stage is exact
      (SimClock charges ``n_evaluated / rate``).
    - ``queue``: scheduler-measured ``Response.queue_delay_s``.
    - ``retrieve`` / ``gather``: front-end per-query times fed by the
      caller (fan-out searcher shard times / gather makespans).
    """

    def __init__(self, cfg, *, drain_mode: str, pipeline_depth: int,
                 batch_items: int):
        self.cfg = cfg
        self.drain_mode = str(drain_mode)
        self.pipeline_depth = int(pipeline_depth)
        self.batch_items = int(batch_items)
        self.stages: Dict[str, StageStats] = {s: StageStats() for s in STAGES}
        self.n_warmup_excluded = 0
        self._uload_total = 0.0
        self._evaluated_total = 0.0

    # -- taps ---------------------------------------------------------------

    def observe_device(self, n_items: int, elapsed_s: float) -> None:
        self.stages[STAGE_DEVICE].observe(n_items, elapsed_s)

    def observe_batch(self, uload: int, n_evaluated: int, elapsed_s: float,
                      *, n_cached: Optional[int] = None,
                      warm: bool = True) -> None:
        """One drained batch. ``n_evaluated`` is what the device ran
        (feeds the rate fit); ``n_cached`` — when the caller can name
        the Trust-DB hit count — separates cache reduction from
        deadline shedding, so ``eval_frac`` stays a pure hit-rate model
        and ``predict`` doesn't double-count the shed budget."""
        if not warm:
            self.n_warmup_excluded += 1
            return
        self._uload_total += float(uload)
        self._evaluated_total += (float(uload - n_cached)
                                  if n_cached is not None
                                  else float(n_evaluated))
        self.stages[STAGE_BATCH].observe(n_evaluated, elapsed_s)

    def observe_queue(self, delay_s: float) -> None:
        self.stages[STAGE_QUEUE].observe(1, delay_s)

    def observe_retrieve(self, n_items: int, elapsed_s: float) -> None:
        self.stages[STAGE_RETRIEVE].observe(n_items, elapsed_s)

    def observe_gather(self, elapsed_s: float) -> None:
        self.stages[STAGE_GATHER].observe(1, elapsed_s)

    # -- fitted parameters --------------------------------------------------

    def eval_frac(self) -> float:
        """Fraction of enqueued items that miss the Trust-DB cache and
        are therefore device-eligible. Deadline shedding is NOT folded
        in here — ``predict`` models that itself via the eval budget."""
        if self._uload_total <= 0.0:
            return 1.0
        return min(self._evaluated_total / self._uload_total, 1.0)

    def device_rate_items_per_s(self) -> float:
        """Fitted evaluation rate; falls back to the config-seeded rate
        (the same seed ``LoadMonitor`` uses) when nothing was measured."""
        for stage in (STAGE_BATCH, STAGE_DEVICE):
            r = self.stages[stage].rate_items_per_s
            if r is not None and r > 0.0:
                return r
        return self.cfg.u_capacity / max(self.cfg.deadline_s, 1e-9)

    def fitted(self) -> Dict[str, object]:
        return {
            "drain_mode": self.drain_mode,
            "pipeline_depth": self.pipeline_depth,
            "batch_items": self.batch_items,
            "eval_frac": self.eval_frac(),
            "device_rate_items_per_s": self.device_rate_items_per_s(),
            "n_warmup_excluded": self.n_warmup_excluded,
            "stages": {s: st.summary() for s, st in self.stages.items()},
        }


# ---------------------------------------------------------------------------
# closed queueing-network what-if
# ---------------------------------------------------------------------------

@dataclass
class CapacityPrediction:
    n_replicas: int
    pipeline_depth: int
    batch_items: int
    throughput_items_per_s: float
    p50_s: float
    p99_s: float
    makespan_s: float
    n_requests: int
    n_items: int


def predict(model: ServiceTimeModel, n_replicas: int, pipeline_depth: int,
            batch_items: int,
            workload: Sequence[Tuple[float, int, str]],
            *, round_s: Optional[float] = None) -> CapacityPrediction:
    """What-if: replay ``workload`` through a deterministic queueing
    mini-model of an ``n_replicas`` fleet and predict throughput / p99.

    ``workload`` is the arrival curve: ``(t_arrival, n_items, tenant)``
    rows sorted by time (unsorted input is sorted here).  The mini-model
    mirrors the fleet's actual mechanics — consistent-ring tenant
    routing, one drained batch per replica per ``round_s`` cadence tick,
    batches capped at ``batch_items`` whole requests, the shedder's
    effective-deadline eval budget, cache hits at the fitted
    ``eval_frac``, service charged at the fitted device rate — without
    building a single engine.  Scheduling nuances the model ignores
    (priority classes, stealing, hedging) are second-order for capacity;
    the validation gate in ``bench_capacity`` bounds the error at 25%.
    """
    if n_replicas <= 0:
        raise ValueError("n_replicas must be positive")
    arrivals = sorted(workload, key=lambda a: a[0])
    cfg = model.cfg
    rate = model.device_rate_items_per_s()
    ef = model.eval_frac()
    if round_s is None:
        round_s = batch_items / max(rate, 1e-9)
    # The live shedder reads (Ucapacity, Uthreshold) off its
    # LoadMonitor, which re-derives them from the measured rate and the
    # two deadline windows — mirror that derivation from the fitted
    # rate, NOT the raw config constants, or every deadline budget is
    # computed against parameters the fleet isn't actually running.
    ucap = max(1, int(rate * cfg.deadline_s))
    uthr = max(0, int(rate * (cfg.overload_deadline_s
                              - cfg.deadline_s)))
    chunk = max(int(getattr(cfg, "chunk_size", 1)), 1)

    ring = ConsistentHashRing()
    names = [f"r{i}" for i in range(n_replicas)]
    for name in names:
        ring.add(name, 1.0)

    clock = {name: 0.0 for name in names}
    queues: Dict[str, Deque[Tuple[float, int]]] = {
        name: deque() for name in names}
    latencies: List[float] = []
    completions: List[float] = []
    n_items_total = 0

    def _drain_round() -> bool:
        any_batch = False
        for name in names:
            q = queues[name]
            if not q:
                continue
            batch: List[Tuple[float, int]] = []
            total = 0
            while q and (not batch or total + q[0][1] <= batch_items):
                t_arr, n = q.popleft()
                batch.append((t_arr, n))
                total += n
            dl = effective_deadline(
                total, ucap, uthr,
                deadline_s=cfg.deadline_s,
                overload_deadline_s=cfg.overload_deadline_s,
                weight=cfg.very_heavy_weight)
            n_miss = total * ef
            # The shedder walks the drop queue in evaluator chunks and
            # stops at the last WHOLE chunk inside the deadline budget —
            # floor the budget the same way or every budget-bound batch
            # is over-predicted by a fraction of a chunk.
            budget = float((int(rate * dl) // chunk) * chunk)
            n_eval = min(n_miss, max(budget, min(n_miss, ucap)))
            clock[name] += n_eval / max(rate, 1e-9)
            done = clock[name]
            for t_arr, n in batch:
                latencies.append(max(done - t_arr, 0.0))
                completions.append(done)
            any_batch = True
        return any_batch

    next_drain = round_s
    for t_arr, n, tenant in arrivals:
        name = ring.route(str(tenant))
        clock[name] = max(clock[name], float(t_arr))
        queues[name].append((float(t_arr), int(n)))
        n_items_total += int(n)
        # Catch-up drains fire AFTER the arrival is enqueued and the
        # routed clock has advanced — the trace driver's order. An
        # idle gap between arrivals is charged to whatever was queued
        # through it, exactly as the event-driven replay charges it.
        while next_drain <= t_arr:
            _drain_round()
            next_drain += round_s
    while _drain_round():
        pass

    if not latencies:
        return CapacityPrediction(
            n_replicas=n_replicas, pipeline_depth=pipeline_depth,
            batch_items=batch_items, throughput_items_per_s=0.0,
            p50_s=0.0, p99_s=0.0, makespan_s=0.0, n_requests=0, n_items=0)
    lat = np.asarray(latencies)
    makespan = max(max(completions), arrivals[-1][0]) if completions else 0.0
    return CapacityPrediction(
        n_replicas=n_replicas,
        pipeline_depth=pipeline_depth,
        batch_items=batch_items,
        throughput_items_per_s=n_items_total / max(makespan, 1e-9),
        p50_s=float(np.percentile(lat, 50.0)),
        p99_s=float(np.percentile(lat, 99.0)),
        makespan_s=float(makespan),
        n_requests=len(latencies),
        n_items=n_items_total,
    )


# ---------------------------------------------------------------------------
# feedforward planner
# ---------------------------------------------------------------------------

@dataclass
class ForecastSnapshot:
    t: float
    rate_now_items_per_s: float
    rate_forecast_items_per_s: float
    pressure: float


class ForecastPlanner:
    """Sliding-window NHPP rate estimate + linear extrapolation.

    ``observe_arrival`` taps every admitted enqueue.  The window is
    split into two half-windows; the rate slope between them is
    extrapolated ``warmup_lead_s`` ahead, which is exactly the lead a
    new replica needs so its prewarm finishes before the predicted
    breach.  ``forecast_pressure`` converts the predicted item rate to
    a utilization of the fleet's measured service rate (scaled by the
    fitted cache-hit fraction when a ``ServiceTimeModel`` is attached),
    on the same ``[0, 1]``-ish scale the reactive watermark pressure
    uses so the two signals share one set of thresholds.
    """

    def __init__(self, *, warmup_lead_s: float = 0.5, window_s: float = 2.0,
                 min_arrivals: int = 8,
                 model: Optional[ServiceTimeModel] = None):
        if window_s <= 0.0:
            raise ValueError("window_s must be positive")
        self.warmup_lead_s = float(warmup_lead_s)
        self.window_s = float(window_s)
        self.min_arrivals = int(min_arrivals)
        self.model = model
        self._arrivals: Deque[Tuple[float, int]] = deque()
        self.n_observed = 0
        self.last: Optional[ForecastSnapshot] = None

    def observe_arrival(self, t: float, n_items: int) -> None:
        t = float(t)
        self._arrivals.append((t, int(n_items)))
        self.n_observed += 1
        cutoff = t - self.window_s
        while self._arrivals and self._arrivals[0][0] < cutoff:
            self._arrivals.popleft()

    def _window_rate(self, lo: float, hi: float) -> float:
        if hi <= lo:
            return 0.0
        items = sum(n for t, n in self._arrivals if lo < t <= hi)
        return items / (hi - lo)

    def rate_estimate(self, now: float) -> float:
        return self._window_rate(now - self.window_s, now)

    def forecast_rate(self, now: float) -> float:
        """Linear extrapolation ``warmup_lead_s`` past ``now`` from the
        two half-window rates (centered at ``now - 3w/4`` and
        ``now - w/4``)."""
        half = self.window_s / 2.0
        r_old = self._window_rate(now - self.window_s, now - half)
        r_new = self._window_rate(now - half, now)
        slope = (r_new - r_old) / half
        return max(r_new + slope * (self.warmup_lead_s + half / 2.0), 0.0)

    def forecast_pressure(self, now: float, *,
                          rate_items_per_s: float) -> float:
        """Predicted fleet utilization at ``now + warmup_lead_s``
        against the fleet's current aggregate service rate."""
        if self.n_observed < self.min_arrivals or rate_items_per_s <= 0.0:
            return 0.0
        ef = self.model.eval_frac() if self.model is not None else 1.0
        fr = self.forecast_rate(now)
        pressure = min(fr * ef / rate_items_per_s, 4.0)
        self.last = ForecastSnapshot(
            t=float(now), rate_now_items_per_s=self.rate_estimate(now),
            rate_forecast_items_per_s=fr, pressure=pressure)
        return pressure

    def stats(self) -> Dict[str, float]:
        last = self.last
        return {
            "n_observed": self.n_observed,
            "window_s": self.window_s,
            "warmup_lead_s": self.warmup_lead_s,
            "rate_now_items_per_s":
                last.rate_now_items_per_s if last else 0.0,
            "rate_forecast_items_per_s":
                last.rate_forecast_items_per_s if last else 0.0,
            "pressure": last.pressure if last else 0.0,
        }
