"""Adaptive pipeline depth: a bounded controller over the drain window.

Counterpart of ``repro.cluster.depth`` (host logic, copied).

``TrustIRConfig.pipeline_depth`` was a static choice: deep windows buy
throughput (batch N+2 stages while N computes) but charge every batch
the latency of the window ahead of it, so the right depth depends on
whether the replica is throughput-bound (backlog keeps the window full)
or latency-bound (queue delay eats the deadline). This module closes
that loop per replica:

``DepthController``
    one controller per ``Scheduler``/``DrainExecutor``. Each tick reads
    two signals — the replica's backlog in batches (throughput-bound
    when it could keep a deeper window full) and the measured queue
    delay against the deadline (latency-bound when waiting already
    burns the budget) — and votes deepen / shallow / hold. The queue
    delay falls back to the per-stage service-time fit
    (``cluster.capacity.ServiceTimeModel``, STAGE_QUEUE p99) when the
    caller has no fresher sample, so the controller is driven by the
    same fits the capacity planner maintains.

Flap control: a vote only applies after ``hysteresis`` CONSECUTIVE
same-direction votes, every applied change starts a ``cooldown_ticks``
hold (votes do not accumulate through it), and depth moves ONE step at
a time inside ``[min_depth, max_depth]`` — the static config remains as
the clamp (``max_depth = cfg.pipeline_depth``), so adaptive depth can
never exceed what the operator provisioned. Alternating pressure
therefore never changes depth (property-tested in
``tests/test_adaptive_depth.py``).

The coordinator wires the fleet's ``ServiceTimeModel`` into each
replica's controller when capacity planning is attached; each drain
round then re-ticks the controller and applies the decision through
``DrainExecutor.set_depth`` — per replica, every round, with fresh
stats (the scheduler does the same when it drains standalone).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.cluster.capacity import STAGE_QUEUE, ServiceTimeModel

VOTE_DEEPEN = 1
VOTE_HOLD = 0
VOTE_SHALLOW = -1


def controller_from_config(cfg) -> Optional["DepthController"]:
    """Build the configured controller (None when adaptive depth is
    off — the static-depth behaviour is then untouched)."""
    if not getattr(cfg, "adaptive_depth", False):
        return None
    return DepthController(
        min_depth=getattr(cfg, "adaptive_depth_min", 1),
        max_depth=max(int(getattr(cfg, "pipeline_depth", 1)), 1),
        deadline_s=cfg.deadline_s,
        deepen_backlog_batches=getattr(
            cfg, "adaptive_depth_backlog_batches", 2.0),
        latency_frac=getattr(cfg, "adaptive_depth_latency_frac", 0.5),
        hysteresis=getattr(cfg, "adaptive_depth_hysteresis", 2),
        cooldown_ticks=getattr(cfg, "adaptive_depth_cooldown_ticks", 2))


@dataclass
class DepthDecision:
    depth: int
    vote: int
    changed: bool
    backlog_batches: float
    queue_delay_s: Optional[float]


class DepthController:
    """Bounded hysteresis controller for the drain window depth.

    Starts at ``max_depth`` (the static config), so an idle or
    well-provisioned replica behaves exactly like the pre-adaptive
    system until a latency signal argues for shallowing.
    """

    def __init__(self, *, min_depth: int = 1, max_depth: int = 2,
                 deadline_s: float = 0.5,
                 deepen_backlog_batches: float = 2.0,
                 latency_frac: float = 0.5,
                 hysteresis: int = 2, cooldown_ticks: int = 2,
                 model: Optional[ServiceTimeModel] = None):
        if min_depth < 1:
            raise ValueError("min_depth must be >= 1")
        if max_depth < min_depth:
            raise ValueError("max_depth must be >= min_depth")
        self.min_depth = int(min_depth)
        self.max_depth = int(max_depth)
        self.deadline_s = float(deadline_s)
        self.deepen_backlog_batches = float(deepen_backlog_batches)
        self.latency_frac = float(latency_frac)
        self.hysteresis = max(int(hysteresis), 1)
        self.cooldown_ticks = max(int(cooldown_ticks), 0)
        self.model = model
        self.depth = self.max_depth
        self.n_ticks = 0
        self.n_changes = 0
        self._streak_vote = VOTE_HOLD
        self._streak = 0
        self._cooldown = 0
        self.last: Optional[DepthDecision] = None

    # -- signals ------------------------------------------------------------
    def _queue_delay(self, sample: Optional[float]) -> Optional[float]:
        if sample is not None:
            return float(sample)
        if self.model is not None:
            return self.model.stages[STAGE_QUEUE].percentile_s(99.0)
        return None

    def _vote(self, backlog_batches: float,
              queue_delay_s: Optional[float]) -> int:
        latency_bound = (queue_delay_s is not None
                         and queue_delay_s
                         > self.latency_frac * self.deadline_s)
        if latency_bound and self.depth > self.min_depth:
            return VOTE_SHALLOW
        if (not latency_bound
                and backlog_batches >= self.deepen_backlog_batches
                and self.depth < self.max_depth):
            return VOTE_DEEPEN
        return VOTE_HOLD

    # -- the tick -----------------------------------------------------------
    def tick(self, *, backlog_batches: float,
             queue_delay_s: Optional[float] = None) -> int:
        """One control step; returns the (possibly updated) depth."""
        self.n_ticks += 1
        changed = False
        qd = self._queue_delay(queue_delay_s)
        vote = self._vote(float(backlog_batches), qd)
        if self._cooldown > 0:
            # Votes do not accumulate through a cooldown: an applied
            # change must prove itself before the next one.
            self._cooldown -= 1
            self._streak = 0
            self._streak_vote = VOTE_HOLD
        elif vote == VOTE_HOLD:
            self._streak = 0
            self._streak_vote = VOTE_HOLD
        else:
            if vote == self._streak_vote:
                self._streak += 1
            else:
                self._streak_vote = vote
                self._streak = 1
            if self._streak >= self.hysteresis:
                new = min(max(self.depth + vote, self.min_depth),
                          self.max_depth)
                changed = new != self.depth
                if changed:
                    self.depth = new
                    self.n_changes += 1
                self._streak = 0
                self._streak_vote = VOTE_HOLD
                self._cooldown = self.cooldown_ticks
        self.last = DepthDecision(depth=self.depth, vote=vote,
                                  changed=changed,
                                  backlog_batches=float(backlog_batches),
                                  queue_delay_s=qd)
        return self.depth

    def stats(self) -> dict:
        last = self.last
        return {
            "depth": self.depth,
            "min_depth": self.min_depth,
            "max_depth": self.max_depth,
            "n_ticks": self.n_ticks,
            "n_changes": self.n_changes,
            "last_vote": last.vote if last else VOTE_HOLD,
            "last_backlog_batches":
                last.backlog_batches if last else 0.0,
            "last_queue_delay_s":
                (last.queue_delay_s if last and
                 last.queue_delay_s is not None else 0.0),
        }
