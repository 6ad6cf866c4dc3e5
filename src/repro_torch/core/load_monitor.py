"""Load Monitor (paper §4): decides Uload, Ucapacity, Uthreshold.

Uload is observed per request batch. Ucapacity and Uthreshold are derived
from a measured evaluator throughput (items/s, EWMA-smoothed):

    Ucapacity  = floor(rate * deadline_s)
    Uthreshold = floor(rate * (overload_deadline_s - deadline_s))

Config values seed the estimate before any measurement exists.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Hashable, Optional, Tuple

from repro_torch.configs.base import TrustIRConfig


class WarmupGate:
    """Shared warmup exclusion rule for throughput observations.

    The first evaluation of a new work shape pays one-off costs (kernel
    builds, allocator growth, library autotuning); its elapsed time
    would collapse the rate EWMA. Both drain executors consult ONE
    rule — "the first sight of a shape signature is warmup, skip its
    observation" — so their Ucapacity estimates stay comparable.
    """

    def __init__(self) -> None:
        self._seen: set = set()
        self.n_excluded: int = 0

    def warm(self, signature: Hashable) -> bool:
        """True when ``signature`` has been seen before (observe it);
        False on first sight (warmup: skip)."""
        if signature in self._seen:
            return True
        self._seen.add(signature)
        self.n_excluded += 1
        return False

    @staticmethod
    def signature(n_items: int, features) -> Tuple:
        """Shape signature of one evaluator call: item count plus every
        feature leaf's trailing shape + dtype (tensors or ndarrays)."""
        leaves = tuple(sorted(
            (k, tuple(v.shape[1:]), str(v.dtype))
            for k, v in features.items())) if hasattr(
                features, "items") else ()
        return (int(n_items),) + leaves


@dataclass
class LoadMonitor:
    cfg: TrustIRConfig
    ewma: float = 0.3
    _rate: Optional[float] = None        # items/s, EWMA
    n_observations: int = 0
    # Per-observation rates are clamped symmetrically to within this
    # factor of the current estimate before blending, so one
    # pathological sample cannot whipsaw the EWMA.
    rate_clamp_mult: float = 8.0
    # Optional tap for accepted observations (the fleet's
    # ServiceTimeModel subscribes here); fired only for samples past the
    # warmup and validity filters.
    on_observe: Optional[Callable[[int, float], None]] = None

    @property
    def rate(self) -> float:
        if self._rate is not None:
            return self._rate
        # Seed from config: Ucapacity items within the base deadline.
        return self.cfg.u_capacity / max(self.cfg.deadline_s, 1e-9)

    def observe(self, n_items: int, elapsed_s: float) -> None:
        """Record a measured evaluation of ``n_items`` in ``elapsed_s``."""
        if n_items <= 0 or elapsed_s <= 0:
            return
        r = n_items / elapsed_s
        if self._rate is None:
            # The first measurement seeds the estimate unclamped.
            self._rate = r
        else:
            r = min(max(r, self._rate / self.rate_clamp_mult),
                    self.rate_clamp_mult * self._rate)
            self._rate = self.ewma * r + (1 - self.ewma) * self._rate
        self.n_observations += 1
        if self.on_observe is not None:
            self.on_observe(n_items, elapsed_s)

    def parameters(self) -> Tuple[int, int]:
        """Current (Ucapacity, Uthreshold)."""
        r = self.rate
        ucap = max(1, int(r * self.cfg.deadline_s))
        uthr = max(0, int(r * (self.cfg.overload_deadline_s
                               - self.cfg.deadline_s)))
        return ucap, uthr
