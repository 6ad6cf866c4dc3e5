"""Per-tenant token-bucket rate limiting (admission guard).

Counterpart of ``repro.scheduling.ratelimit`` (host logic, copied).

Buckets are denominated in *candidate items*, not requests: a "book"
flood of 276k result URLs from one tenant costs 276k tokens, so a
single tenant cannot monopolize evaluation capacity with a few huge
requests while staying under a request-count cap.

The clock is injected (``now``) so the limiter runs under the
simulator's deterministic ``SimClock`` as well as ``time.monotonic``.
``CRITICAL`` traffic bypasses the limiter entirely (see
``priorities.AdmissionPolicy``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Tuple


@dataclass
class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s, capacity ``burst``."""
    rate: float                    # tokens (items) per second
    burst: float                   # bucket capacity
    tokens: float = field(default=math.nan)   # nan -> start full
    last_t: float = field(default=math.nan)

    def _refill(self, now: float) -> None:
        if math.isnan(self.tokens):
            self.tokens = self.burst
            self.last_t = now
            return
        dt = max(now - self.last_t, 0.0)
        self.tokens = min(self.burst, self.tokens + dt * self.rate)
        self.last_t = now

    def try_acquire(self, n: float, now: float) -> bool:
        """Take ``n`` tokens if available; never goes negative."""
        self._refill(now)
        if n <= self.tokens + 1e-9:
            self.tokens -= n
            return True
        return False

    def available(self, now: float) -> float:
        self._refill(now)
        return self.tokens


class TenantRateLimiter:
    """One bucket per tenant, lazily created from default parameters.

    ``math.inf`` defaults disable limiting (every acquire succeeds)
    so the scheduler works out of the box; per-tenant quotas are
    installed with :meth:`configure`.
    """

    def __init__(self, default_rate: float = math.inf,
                 default_burst: float = math.inf):
        self.default_rate = default_rate
        self.default_burst = default_burst
        self._buckets: Dict[str, TokenBucket] = {}

    def configure(self, tenant: str, rate: float, burst: float) -> None:
        """Install or retune a tenant's quota.

        Retuning adjusts the EXISTING bucket in place (tokens clamped
        to the new burst) — replacing it would refill to a full burst
        and forgive everything the tenant already consumed, letting a
        periodically-reconfigured quota (the cluster autoscaler) never
        actually bind.
        """
        b = self._buckets.get(tenant)
        if b is None:
            self._buckets[tenant] = TokenBucket(rate=rate, burst=burst)
            return
        b.rate = rate
        if not math.isnan(b.tokens):
            b.tokens = min(b.tokens, burst)
        b.burst = burst

    def _bucket(self, tenant: str) -> TokenBucket:
        b = self._buckets.get(tenant)
        if b is None:
            b = TokenBucket(rate=self.default_rate,
                            burst=self.default_burst)
            self._buckets[tenant] = b
        return b

    def allow(self, tenant: str, n_items: int, now: float) -> bool:
        b = self._bucket(tenant)
        if math.isinf(b.burst):
            return True
        return b.try_acquire(float(n_items), now)

    def snapshot(self, now: float) -> Dict[str, Tuple[float, float]]:
        """tenant -> (available tokens, burst) for observability."""
        return {t: (b.available(now), b.burst)
                for t, b in self._buckets.items()}
