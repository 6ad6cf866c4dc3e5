"""Deterministic per-shard service-time model with heavy-tailed
straggler injection.

Scatter-gather tail latency is ruled by the slowest of ``n`` shard
probes, so reproducing the tail problem needs per-probe service times
that are (a) heavy-tailed and (b) **bit-reproducible** — churn/chaos
tests assert exact response sets, and a model whose draws depended on
call interleaving would break under hedging (a hedge probe consumes a
draw the unhedged run never made).

:class:`ShardServiceModel` therefore derives every draw from a counter:
probe ``seq`` of shard ``key`` seeds its own
``np.random.default_rng((seed, stable_hash(key), seq))`` stream, so the
service time of any probe is a pure function of ``(seed, key, seq)`` —
independent of how probes from different shards interleave, and
identical across runs. Two straggler mechanisms compose:

* **transient** — with probability ``straggler_p`` a probe pays
  ``straggler_mult x (1 + Pareto(tail_alpha))``, the heavy tail of the
  Tail-Tolerant Distributed Search setting (a GC pause, a page fault
  storm);
* **persistent** — :meth:`set_persistent` pins a multiplier on one
  shard (a degraded disk, a noisy neighbour) until
  :meth:`clear_persistent`; the selective-replication EWMAs exist to
  catch exactly these.

Times are *simulated* seconds layered on the fleet's SimClock timeline;
they never feed the LoadMonitor (wall clocks only).

Counterpart of ``repro.fanout.service_model``, copied: the draws stay
numpy's counter-seeded ``default_rng``, so the port and the reference
draw the same service time for the same ``(seed, key, seq)`` bit for bit
and make the same late-shard and hedge decisions. A ``torch.Generator``
would change every decision.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np


def _key_hash(s: str) -> int:
    """Stable 32-bit key hash (md5, like the ring's ``stable_hash`` —
    local copy so this leaf module never imports ``cluster``,
    whose coordinator imports this package)."""
    return int.from_bytes(hashlib.md5(s.encode()).digest()[:4], "big")


@dataclass
class ShardServiceModel:
    """Seeded counter-based service-time draws for shard probes."""
    base_s: float = 0.004            # healthy-shard service time
    jitter_frac: float = 0.25        # uniform +-frac around base
    straggler_p: float = 0.01        # transient heavy-tail probability
    straggler_mult: float = 10.0     # tail multiplier scale
    tail_alpha: float = 1.6          # Pareto shape (lower = heavier)
    seed: int = 0
    _persistent: Dict[str, float] = field(default_factory=dict,
                                          init=False, repr=False)
    _probe_seq: Dict[str, int] = field(default_factory=dict,
                                       init=False, repr=False)

    # -- persistent (EWMA-visible) slowness ---------------------------------

    def set_persistent(self, key: str, mult: float) -> None:
        """Pin a persistent slowdown on ``key`` (``mult <= 1`` clears)."""
        if mult <= 1.0:
            self._persistent.pop(key, None)
        else:
            self._persistent[key] = float(mult)

    def clear_persistent(self, key: str) -> None:
        self._persistent.pop(key, None)

    def persistent_mult(self, key: str) -> float:
        return self._persistent.get(key, 1.0)

    # -- draws ---------------------------------------------------------------

    def sample_at(self, key: str, seq: int,
                  mult_key: Optional[str] = None) -> float:
        """Service time of probe ``seq`` against ``key`` — a pure
        function of ``(seed, key, seq)`` plus the current persistent
        multiplier of ``mult_key`` (default ``key``; hedge probes pass
        the HOST replica so a mirror rides the host's health, while
        their rng stream stays distinct from the host's primaries)."""
        rng = np.random.default_rng((self.seed & 0xFFFFFFFF,
                                     _key_hash(key), int(seq)))
        u_jit, u_strag = rng.random(2)
        t = self.base_s * (1.0 + self.jitter_frac * (2.0 * u_jit - 1.0))
        if u_strag < self.straggler_p:
            t *= self.straggler_mult * (1.0 + rng.pareto(self.tail_alpha))
        return t * self._persistent.get(mult_key or key, 1.0)

    def sample(self, key: str, mult_key: Optional[str] = None) -> float:
        """Draw the NEXT probe against ``key`` (advances its counter)."""
        seq = self._probe_seq.get(key, 0)
        self._probe_seq[key] = seq + 1
        return self.sample_at(key, seq, mult_key=mult_key)

    def reset(self) -> None:
        """Rewind every probe counter (replays reproduce a run exactly;
        persistent multipliers are state, so they stay)."""
        self._probe_seq.clear()
