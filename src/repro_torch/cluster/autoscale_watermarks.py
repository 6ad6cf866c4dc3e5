"""Adaptive admission watermarks + tenant quotas from fleet load.

Counterpart of ``repro.cluster.autoscale_watermarks`` (host logic, copied).

Without it, ``AdmissionPolicy`` watermarks and tenant token-bucket
quotas are *static* config. This module closes the loop
the way ``core.adaptive`` closes it on the Very-Heavy extension weight:
observe, aggregate, push new setpoints.

Aggregation: each replica's ``LoadMonitor`` EWMA throughput yields its
(Ucapacity, Uthreshold); the cluster's capacity is their sum (capacity
planning for vertical search: provision per replica, reason per
fleet). Cluster **pressure** is the EWMA-smoothed ratio of fleet queued
items to fleet (Ucapacity + Uthreshold) — 0 is an idle fleet, 1 means
the backlog alone fills every replica's extended-deadline budget.

Control law (proportional, clamped):

* admission watermarks interpolate from each replica's CONFIGURED
  policy (its ``AdmissionPolicy`` at first sight — the idle anchor)
  down to a floor (saturated), so LOW and then NORMAL traffic starts
  shedding *earlier* on every replica as the fleet heats up — before
  queues hit static backpressure — without discarding the operator's
  ``SchedulerConfig`` watermarks;
* per-tenant quotas are re-derived from measured capacity: tenant rate
  on replica ``r`` = ``tenant_capacity_frac * cluster_rate *
  share(r)``, where ``share(r)`` is the replica's fraction of fleet
  throughput — a tenant may consume at most that fraction of the
  *measured* fleet, not of a stale config guess.

Elastic membership (capacity planning for vertical search: provision
replica count to offered load, not only quotas): on top of the
watermark/quota push, :meth:`membership_decision` turns the same
smoothed fleet pressure into a scale-up / scale-down vote the
``ClusterCoordinator`` executes as a runtime join or graceful leave.
The policy compares the fleet EWMA backlog against the summed
per-replica Ucapacity watermarks, with two kinds of hysteresis so
membership never flaps:

* a wide dead band — scale up only above ``scale_up_pressure``, scale
  down only when the SURVIVING fleet (one replica fewer) would still
  sit below ``scale_down_pressure``;
* a cooldown — after any membership change, no further change for
  ``scale_cooldown_ticks`` updates (joins need a tick to absorb load
  before the backlog statistics mean anything).

Both hysteresis knobs are operator-tunable without constructing the
autoscaler by hand: ``TrustIRConfig.autoscale_up_pressure`` (default
0.75 — scale up when smoothed backlog fills 3/4 of the fleet's
extended-deadline budget), ``autoscale_down_pressure`` (default 0.15 —
scale down only when the n-1 fleet would still sit below 15%), and
``autoscale_cooldown_ticks`` (default 2 autoscale updates) thread
through ``ClusterCoordinator``'s default-autoscaler construction. The
defaults keep the dead band wide relative to per-round backlog noise
(0.15 vs 0.75 is a 5x span) so diurnal traffic crosses it slowly and
flash crowds cross it immediately — the asymmetry chaos traces rely
on.

The static single-host behaviour is the degenerate case: one replica,
``update`` never called.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Sequence, Tuple

from repro_torch.scheduling import AdmissionPolicy

from repro_torch.cluster.replica import ReplicaHandle


@dataclass
class ClusterLoadSnapshot:
    """One autoscaler update, for observability and tests."""
    u_capacity: int                  # fleet Ucapacity (sum of replicas)
    u_threshold: int                 # fleet Uthreshold
    rate_items_per_s: float          # fleet EWMA throughput
    queued_items: int                # fleet backlog
    pressure: float                  # smoothed backlog / fleet budget
    low_watermark: float             # as pushed to the FIRST replica
    normal_watermark: float          # (per-replica when anchors differ)
    tenant_rates: Dict[str, float]   # per-replica items/s per tenant

    def as_dict(self) -> Dict:
        return {"u_capacity": self.u_capacity,
                "u_threshold": self.u_threshold,
                "rate_items_per_s": self.rate_items_per_s,
                "queued_items": self.queued_items,
                "pressure": self.pressure,
                "low_watermark": self.low_watermark,
                "normal_watermark": self.normal_watermark,
                "tenant_rates": dict(self.tenant_rates)}


class WatermarkAutoscaler:
    def __init__(self, base_low: float = 0.5, base_normal: float = 0.9,
                 floor_low: float = 0.1, floor_normal: float = 0.5,
                 ewma: float = 0.5, ewma_up: float = 1.0,
                 tenant_capacity_frac: float = 0.5,
                 tenant_burst_s: float = 2.0,
                 scale_up_pressure: float = 0.75,
                 scale_down_pressure: float = 0.15,
                 scale_cooldown_ticks: int = 2):
        if not (0.0 <= floor_low <= base_low <= 1.0):
            raise ValueError("need 0 <= floor_low <= base_low <= 1")
        if not (0.0 <= floor_normal <= base_normal <= 1.0):
            raise ValueError("need 0 <= floor_normal <= base_normal <= 1")
        if not (0.0 <= scale_down_pressure < scale_up_pressure <= 1.0):
            raise ValueError(
                "need 0 <= scale_down_pressure < scale_up_pressure <= 1 "
                "(the dead band IS the anti-flap hysteresis)")
        # Fallback idle anchors, used only when a replica's configured
        # policy cannot be read; normally each replica's own
        # AdmissionPolicy at first sight is the anchor.
        self.base_low = base_low
        self.base_normal = base_normal
        self.floor_low = floor_low
        self.floor_normal = floor_normal
        # Asymmetric smoothing: pressure RISES at ewma_up (default:
        # instantly — a saturated fleet must not look idle for the
        # first few ticks and trigger a cold-start scale-down) and
        # decays at ewma (slow — scale-down is the conservative
        # direction).
        self.ewma = ewma
        self.ewma_up = ewma_up
        # <=0 disables quota pushing (watermarks only).
        self.tenant_capacity_frac = tenant_capacity_frac
        self.tenant_burst_s = tenant_burst_s
        self.scale_up_pressure = scale_up_pressure
        self.scale_down_pressure = scale_down_pressure
        self.scale_cooldown_ticks = int(scale_cooldown_ticks)
        self._pressure = 0.0
        self._anchors: Dict[str, Tuple[float, float]] = {}
        self.n_updates = 0
        self._last_scale_tick = -(10 ** 9)

    @property
    def pressure(self) -> float:
        return self._pressure

    def forget(self, replica_id: str) -> None:
        """Drop a departed replica's watermark anchor (a future replica
        reusing the id re-anchors on ITS configured policy)."""
        self._anchors.pop(replica_id, None)

    # -- elastic membership policy -------------------------------------------
    def membership_decision(self, n_replicas: int, min_replicas: int,
                            max_replicas: int,
                            forecast_pressure: float = None) -> int:
        """Vote on fleet size from the last update's smoothed pressure:
        ``+1`` (join a replica), ``-1`` (gracefully drain one out), or
        ``0``. Call after :meth:`update` each autoscale tick.

        Hysteresis: the up/down thresholds form a dead band, scale-down
        additionally requires the surviving ``n-1`` fleet to stay below
        the down threshold (removing capacity must not immediately push
        pressure toward the up threshold), and any decision starts a
        ``scale_cooldown_ticks``-update cooldown — so consecutive ticks
        can never alternate join/leave on a noisy boundary.

        ``forecast_pressure`` is the feedforward signal (the
        ``ForecastPlanner``'s predicted utilization ``warmup_lead_s``
        ahead, on the same scale as the reactive pressure). It is
        deliberately folded into THIS vote rather than voting on its
        own: a planner-initiated pre-warm join takes the same branch,
        sets the same ``_last_scale_tick``, and therefore consumes the
        same cooldown as a reactive join — reactive and feedforward can
        never produce two membership changes inside one cooldown
        window. The forecast also vetoes scale-down (shedding capacity
        right before a predicted wave is the one unforced error the
        planner exists to prevent).
        """
        if max_replicas <= 0:               # membership fixed
            return 0
        min_replicas = max(min_replicas, 1)
        if self.n_updates - self._last_scale_tick \
                < self.scale_cooldown_ticks:
            return 0
        p = self._pressure
        f = forecast_pressure if forecast_pressure is not None else 0.0
        if max(p, f) >= self.scale_up_pressure \
                and n_replicas < max_replicas:
            self._last_scale_tick = self.n_updates
            return 1
        survivors = max(n_replicas - 1, 1)
        if n_replicas > min_replicas and \
                max(p, f) * n_replicas / survivors \
                <= self.scale_down_pressure:
            self._last_scale_tick = self.n_updates
            return -1
        return 0

    def cluster_parameters(self, replicas: Sequence[ReplicaHandle]
                           ) -> Tuple[int, int, float]:
        """Fleet (Ucapacity, Uthreshold, rate) — per-replica LoadMonitor
        EWMA estimates, summed."""
        ucap = uthr = 0
        rate = 0.0
        for rep in replicas:
            c, t = rep.monitor.parameters()
            ucap += c
            uthr += t
            rate += rep.monitor.rate
        return ucap, uthr, rate

    def update(self, replicas: Sequence[ReplicaHandle],
               tenants: Iterable[str] = ()) -> ClusterLoadSnapshot:
        """Observe fleet load, then push watermarks (every replica) and
        tenant quotas (every replica x tenant) derived from it."""
        ucap, uthr, rate = self.cluster_parameters(replicas)
        queued = sum(rep.queued_items for rep in replicas)
        raw = min(queued / max(ucap + uthr, 1), 1.0)
        alpha = self.ewma_up if raw > self._pressure else self.ewma
        self._pressure = alpha * raw + (1 - alpha) * self._pressure
        p = min(max(self._pressure, 0.0), 1.0)

        tenant_rates: Dict[str, float] = {}
        tenant_list: List[str] = sorted(set(tenants))
        low_wm = self.base_low
        normal_wm = self.base_normal
        for i, rep in enumerate(replicas):
            # Idle anchor = the replica's CONFIGURED policy, captured
            # the first time this autoscaler sees it (the policy object
            # itself is replaced by every update below).
            if rep.replica_id not in self._anchors:
                pol = rep.scheduler.policy
                self._anchors[rep.replica_id] = (
                    pol.low_watermark, pol.normal_watermark)
            base_low, base_normal = self._anchors[rep.replica_id]
            rep_low = min(base_low, self.floor_low) \
                + (base_low - min(base_low, self.floor_low)) * (1.0 - p)
            rep_normal = min(base_normal, self.floor_normal) \
                + (base_normal - min(base_normal, self.floor_normal)) \
                * (1.0 - p)
            if i == 0:                  # reported snapshot values
                low_wm, normal_wm = rep_low, rep_normal
            rep.scheduler.policy = AdmissionPolicy(
                low_watermark=rep_low, normal_watermark=rep_normal)
            if self.tenant_capacity_frac > 0 and tenant_list:
                share = rep.monitor.rate / max(rate, 1e-9)
                t_rate = self.tenant_capacity_frac * rate * share
                for tenant in tenant_list:
                    rep.scheduler.limiter.configure(
                        tenant, rate=t_rate,
                        burst=t_rate * self.tenant_burst_s)
                    tenant_rates[f"{rep.replica_id}:{tenant}"] = t_rate

        self.n_updates += 1
        return ClusterLoadSnapshot(
            u_capacity=ucap, u_threshold=uthr, rate_items_per_s=rate,
            queued_items=queued, pressure=p, low_watermark=low_wm,
            normal_watermark=normal_wm, tenant_rates=tenant_rates)
