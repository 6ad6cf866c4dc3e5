"""Fault tolerance: health tracking, straggler skipping, bounded hedging.

Counterpart of ``repro.distribution.fault_tolerance``, host logic copied:
``HeartbeatTracker`` (workers dead after ``timeout_s`` without a beat),
``largest_mesh_shape`` (the biggest (data, model) grid a surviving device
count allows), ``DeadlineSkipPolicy`` (skip grad-accum chunks that would
overrun the step deadline, and rescale), and the serving-side
``HedgedDispatch`` / ``HedgeBudgetView``; and ``ElasticMeshManager``,
which picks a (data, model) mesh for the ranks that survive and restores
the last checkpoint onto it, each leaf re-sharded by its spec
(``training.checkpoint.restore(..., shardings=)``).
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass
class HeartbeatTracker:
    timeout_s: float = 60.0
    _last: Dict[int, float] = field(default_factory=dict)

    def beat(self, worker_id: int, now: Optional[float] = None) -> None:
        self._last[worker_id] = time.monotonic() if now is None else now

    def live_workers(self, now: Optional[float] = None) -> List[int]:
        t = time.monotonic() if now is None else now
        return sorted(w for w, ts in self._last.items()
                      if t - ts <= self.timeout_s)

    def dead_workers(self, now: Optional[float] = None) -> List[int]:
        t = time.monotonic() if now is None else now
        return sorted(w for w, ts in self._last.items()
                      if t - ts > self.timeout_s)


def largest_mesh_shape(n_devices: int, prefer_model: int = 16
                       ) -> Tuple[int, ...]:
    """Biggest (data, model) grid fitting ``n_devices`` (powers of two).

    Keeps the model axis as close to ``prefer_model`` as the device count
    allows — TP degree changes less often than DP degree on failure.
    """
    n = 2 ** int(math.floor(math.log2(max(n_devices, 1))))
    model = min(prefer_model, n)
    return (n // model, model)


class ElasticMeshManager:
    """Rebuild (mesh, shardings) for the surviving device set."""

    def __init__(self, prefer_model: int = 16, device=None):
        self.prefer_model = prefer_model
        self.device = device

    def make_mesh(self, devices: Optional[Sequence[int]] = None):
        """The largest (data, model) mesh over ``devices`` (global ranks;
        every rank of the process group by default)."""
        from repro_torch.launch import mesh as mesh_lib
        devs = list(devices if devices is not None
                    else range(mesh_lib.world_size()))
        shape = largest_mesh_shape(len(devs), self.prefer_model)
        n_used = shape[0] * shape[1]
        return mesh_lib.mesh_from_devices(devs[:n_used], shape,
                                          ("data", "model"), self.device)

    def resume(self, ckpt_dir: str, tree_like, specs, devices=None):
        """Elastic restore: new mesh + shardings + state from the last
        checkpoint (leaves are saved unsharded; each rank keeps its own
        pieces of them). Returns (mesh, shardings, state, extra)."""
        from repro_torch.distribution.sharding import shardings_of
        from repro_torch.training import checkpoint as CK
        m = self.make_mesh(devices)
        sh = shardings_of(specs, m)
        state, extra = CK.restore(ckpt_dir, tree_like, shardings=sh,
                                  device=self.device)
        return m, sh, state, extra


@dataclass
class DeadlineSkipPolicy:
    """Straggler mitigation by deadline: work chunks that would overrun
    the step deadline are skipped and the remainder rescaled — the
    training-side analogue of the paper's PRIOR tier.
    """
    step_deadline_s: float
    min_fraction: float = 0.5     # never keep less than this

    def plan(self, chunk_times_s: Sequence[float]) -> List[bool]:
        """Given projected per-chunk times, choose which chunks to run."""
        keep: List[bool] = []
        t = 0.0
        n = len(chunk_times_s)
        min_keep = math.ceil(self.min_fraction * n)
        for i, c in enumerate(chunk_times_s):
            if t + c <= self.step_deadline_s or i < min_keep:
                keep.append(True)
                t += c
            else:
                keep.append(False)
        return keep

    def rescale(self, keep: Sequence[bool]) -> float:
        """Gradient rescale factor: kept chunks stand in for all."""
        kept = sum(keep)
        return len(keep) / max(kept, 1)


@dataclass
class HedgedDispatch:
    """Serving-side hedging: re-issue a request to a backup replica if the
    primary hasn't answered within the hedge latency (P95-tuned).

    Hedging is *bounded* two ways (Tail-Tolerant practice: hedges must
    stay a small fraction of traffic or they amplify the overload they
    mitigate):

    * ``max_hedges`` — per-request re-issue bound (the old boolean
      ``already_hedged`` is the ``max_hedges=1`` case; callers may still
      pass a bool, it counts as 0/1 prior hedges);
    * ``budget_frac`` — a token bucket denominated in *requests seen*:
      every ``note_request()`` earns ``budget_frac`` of a hedge token,
      capped at ``budget_burst``, and every issued hedge
      (``record_hedge``) spends one — fleet hedge rate stays ~5% of
      traffic regardless of how hot the tail gets.
    """
    hedge_after_s: float
    max_hedges: int = 1
    budget_frac: float = 0.05          # hedges per request of traffic
    budget_burst: float = 1.0          # token cap (allows early hedges)
    _tokens: float = field(default=None, init=False)  # type: ignore
    n_requests_seen: int = field(default=0, init=False)
    n_hedges_issued: int = field(default=0, init=False)

    def __post_init__(self):
        self._tokens = self.budget_burst

    @property
    def budget_available(self) -> float:
        return self._tokens

    def note_request(self, n: int = 1) -> None:
        """Earn hedge budget from observed (admitted) traffic."""
        self.n_requests_seen += n
        self._tokens = min(self.budget_burst,
                           self._tokens + self.budget_frac * n)

    def should_hedge(self, elapsed_s: float, n_prior_hedges) -> bool:
        """True when this request may be re-issued *now*: it has waited
        past the hedge latency, has re-issues left, and the traffic
        budget holds a full token."""
        return (int(n_prior_hedges) < self.max_hedges
                and elapsed_s >= self.hedge_after_s
                and self._tokens >= 1.0)

    def record_hedge(self, n: int = 1) -> None:
        """Spend budget for issued hedge(s)."""
        self.n_hedges_issued += n
        self._tokens -= n

    def probe_view(self, hedge_after_s: float,
                   max_hedges: int = 1) -> "HedgeBudgetView":
        """A view over this SAME token bucket with its own (usually
        much shorter) hedge latency: per-shard probe hedging
        (``fanout``) fires earlier than whole-request hedging,
        but both spend one fleet-wide budget — total hedges stay a
        bounded fraction of admitted traffic no matter which layer
        issues them."""
        return HedgeBudgetView(self, hedge_after_s,
                               max_hedges=max_hedges)


class HedgeBudgetView:
    """Same bucket, different trigger: delegates every token operation
    to the base :class:`HedgedDispatch` while applying its own hedge
    latency and per-item re-issue bound."""

    def __init__(self, base: HedgedDispatch, hedge_after_s: float,
                 max_hedges: int = 1):
        self.base = base
        self.hedge_after_s = float(hedge_after_s)
        self.max_hedges = int(max_hedges)

    @property
    def budget_available(self) -> float:
        return self.base.budget_available

    def note_request(self, n: int = 1) -> None:
        self.base.note_request(n)

    def should_hedge(self, elapsed_s: float, n_prior_hedges) -> bool:
        return (int(n_prior_hedges) < self.max_hedges
                and elapsed_s >= self.hedge_after_s
                and self.base.budget_available >= 1.0)

    def record_hedge(self, n: int = 1) -> None:
        self.base.record_hedge(n)
