"""Serving-side hedging policy: bounded hedged dispatch.

Counterpart of the hedging half of ``repro.distribution.fault_tolerance``
(``HedgedDispatch`` and ``HedgeBudgetView``), host logic copied. The
checkpoint, elastic-mesh and heartbeat parts of that module are mesh
code for a later slice of the port.
"""
from __future__ import annotations

from dataclasses import dataclass, field


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
        (``repro.fanout``) fires earlier than whole-request hedging,
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
