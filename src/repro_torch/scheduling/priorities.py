"""Request priority classes and per-regime admission rules.

Counterpart of ``repro.scheduling.priorities`` (host logic, copied).

The Load Shedder decides *what to evaluate* inside an admitted batch
(paper §5); this module decides *which requests get batch capacity at
all* when the offered load exceeds it — the admission layer that
tail-tolerant search stacks (1707.07426) and vertical-search capacity
planning (1006.5059) put in front of the shedding logic.

Four classes, mirroring the spirit of the shedder's three regimes:

=============  =========================================================
``CRITICAL``   interactive / paid traffic; always admitted, bypasses
               the tenant rate limiter, drained first.
``HIGH``       latency-sensitive; admitted in every regime (subject to
               rate limits and queue backpressure).
``NORMAL``     default; throttled only under VERY_HEAVY pressure.
``LOW``        batch / prefetch / crawler refresh; throttled under
               HEAVY pressure, rejected outright under VERY_HEAVY.
=============  =========================================================

Rejection is never a silent drop: the scheduler answers every rejected
request with an explicit ``Response`` carrying the average-trust prior
(the same fallback tier the shedder uses past the deadline), flagged
``admitted=False`` with a machine-readable ``reason``.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional

from repro_torch.core.regimes import Regime


class Priority(enum.IntEnum):
    """Lower value = more important (sorts first in queue order)."""
    CRITICAL = 0
    HIGH = 1
    NORMAL = 2
    LOW = 3


# Machine-readable rejection reasons (Response.reason).
REASON_RATE_LIMITED = "rate_limited"          # tenant token bucket empty
REASON_SHED_LOW_HEAVY = "shed_low_heavy"      # LOW over watermark, HEAVY
REASON_SHED_LOW_VERY_HEAVY = "shed_low_very_heavy"
REASON_SHED_NORMAL_VERY_HEAVY = "shed_normal_very_heavy"
REASON_QUEUE_FULL = "queue_full"              # static-capacity backpressure
REASON_QUARANTINED = "quarantined"            # poison-pill circuit breaker open


@dataclass(frozen=True)
class AdmissionPolicy:
    """Per-regime admission ladder (regime from the *offered* load:
    queued items + the incoming request's candidate count).

    ``low_watermark`` / ``normal_watermark`` are queue-fill fractions
    (0..1) above which the respective class stops being admitted in the
    regime that throttles it.
    """
    low_watermark: float = 0.5      # LOW fill bound under HEAVY
    normal_watermark: float = 0.9   # NORMAL fill bound under VERY_HEAVY

    def decide(self, priority: Priority, regime: Regime,
               fill_frac: float) -> Optional[str]:
        """Return ``None`` to admit, or a rejection reason string.

        fill_frac: current fill of the *target class queue* (0..1).
        Tenant rate limiting and queue backpressure are the scheduler's
        own checks, applied after this ladder (CRITICAL bypasses the
        rate limiter there).
        """
        if priority is Priority.CRITICAL:
            return None
        if regime is Regime.NORMAL:
            return None
        if priority is Priority.LOW:
            if regime is Regime.VERY_HEAVY:
                return REASON_SHED_LOW_VERY_HEAVY
            if fill_frac >= self.low_watermark:
                return REASON_SHED_LOW_HEAVY
            return None
        if (priority is Priority.NORMAL and regime is Regime.VERY_HEAVY
                and fill_frac >= self.normal_watermark):
            return REASON_SHED_NORMAL_VERY_HEAVY
        return None
