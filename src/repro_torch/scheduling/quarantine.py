"""Poison-pill detector + quarantine: a circuit breaker per work signature.

Counterpart of ``repro.scheduling.quarantine`` (host logic, copied).

A *query of death* is a request whose candidate features make the
evaluator raise (or hang until a watchdog kills it). Without defence,
every retry re-poisons the ``DrainExecutor`` window: the failed batch is
prior-answered (the no-drop invariant holds), but the executor error
count grows without bound and every batch sharing the window with the
poison pays the rescue path — the classic query-of-death outage mode of
production retrieval stacks (tail-tolerant search, 1707.07426, survives
*slow* shards; this module survives *toxic* work).

The defence is signature-keyed:

``work_signature(item_keys)``
    A stable content hash of the request's candidate-set prefix. A
    query of death retrieves the same candidate documents every time it
    is asked, so its requests collapse onto ONE signature no matter
    which tenant or replica carries them — while organic traffic
    spreads across signatures (hot-URL repeats share one signature too,
    which is harmless: signatures only matter once they strike).

``PoisonQuarantine``
    Per-signature circuit breaker in front of the evaluator:

    * CLOSED   — requests flow; each executor error carrying the
      signature is a strike.
    * OPEN     — after ``k`` strikes. Matching requests are
      prior-answered at admission (an explicit ``Response`` with reason
      ``"quarantined"`` — never a silent drop) and the evaluator never
      sees them, capping executor errors at O(k) per signature.
    * HALF_OPEN — ``probe_after_s`` after opening, exactly ONE matching
      request is admitted as a probe. Success closes the breaker
      (strikes reset); failure re-opens it for another
      ``probe_after_s``.

The breaker never touches requests already queued when it opens — they
were admitted under a closed breaker and drain normally (their errors
still count, so the O(k) bound is ``k`` strikes plus the in-queue
stragglers at opening time plus one per probe).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict

import numpy as np

# Breaker states.
CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

# How many leading candidate keys feed the signature. A prefix keeps
# the hash O(1) per request; 64 keys is far past collision range for
# organic traffic while a query of death (identical candidate set)
# always collides with itself.
SIGNATURE_PREFIX = 64


def work_signature(item_keys) -> str:
    """Stable content hash of a candidate-set prefix (hex, 12 chars)."""
    keys = np.asarray(item_keys, dtype=np.uint32)[:SIGNATURE_PREFIX]
    return hashlib.md5(keys.tobytes()).hexdigest()[:12]


@dataclass
class _Breaker:
    state: str = CLOSED
    strikes: int = 0            # errors while CLOSED/HALF_OPEN (resets on close)
    opened_t: float = 0.0       # clock time of the last open transition
    n_errors: int = 0           # lifetime executor errors for this signature
    n_blocked: int = 0          # requests prior-answered by this breaker
    n_probes: int = 0           # half-open probes admitted


@dataclass
class QuarantineStats:
    n_blocked: int = 0          # requests prior-answered across signatures
    n_strikes: int = 0          # executor errors recorded against breakers
    n_opens: int = 0            # CLOSED/HALF_OPEN -> OPEN transitions
    n_probes: int = 0           # half-open probes admitted
    n_recoveries: int = 0       # probes that closed a breaker

    def as_dict(self) -> Dict[str, int]:
        return dict(self.__dict__)


class PoisonQuarantine:
    """Signature-keyed circuit breakers (see module docstring).

    ``now`` is a zero-arg clock callable — the scheduler passes its own
    (simulated or wall) clock so half-open timing is deterministic in
    simulation.
    """

    def __init__(self, k: int, probe_after_s: float, now) -> None:
        if k <= 0:
            raise ValueError("quarantine k must be positive")
        if probe_after_s <= 0:
            raise ValueError("probe_after_s must be positive")
        self.k = int(k)
        self.probe_after_s = float(probe_after_s)
        self._now = now
        self._breakers: Dict[str, _Breaker] = {}
        self.stats = QuarantineStats()

    # -- admission-time check ------------------------------------------------

    def check(self, sig: str) -> bool:
        """True = admit the request; False = prior-answer it.

        Called on the scheduler's submit path. An OPEN breaker past its
        probe timer admits exactly one request as the half-open probe.
        """
        br = self._breakers.get(sig)
        if br is None or br.state == CLOSED:
            return True
        if br.state == OPEN and (self._now() - br.opened_t
                                 >= self.probe_after_s):
            br.state = HALF_OPEN
            br.n_probes += 1
            self.stats.n_probes += 1
            return True
        # OPEN inside the timer, or HALF_OPEN with the probe already out.
        br.n_blocked += 1
        self.stats.n_blocked += 1
        return False

    # -- executor feedback ---------------------------------------------------

    def record_failure(self, sig: str) -> None:
        """An executor error carried this signature: one strike."""
        br = self._breakers.setdefault(sig, _Breaker())
        br.n_errors += 1
        self.stats.n_strikes += 1
        if br.state == HALF_OPEN:
            # The probe failed: straight back to OPEN, timer restarted.
            br.state = OPEN
            br.opened_t = self._now()
            self.stats.n_opens += 1
            return
        if br.state == CLOSED:
            br.strikes += 1
            if br.strikes >= self.k:
                br.state = OPEN
                br.opened_t = self._now()
                self.stats.n_opens += 1

    def record_success(self, sig: str) -> None:
        """A batch carrying this signature completed cleanly."""
        br = self._breakers.get(sig)
        if br is None:
            return
        if br.state == HALF_OPEN:
            self.stats.n_recoveries += 1
        if br.state != OPEN:
            # HALF_OPEN probe success closes; CLOSED strikes decay to
            # zero (a signature that evaluates cleanly is not poison).
            br.state = CLOSED
            br.strikes = 0

    # -- restart banking -----------------------------------------------------

    def adopt(self, other: "PoisonQuarantine") -> None:
        """Inherit ``other``'s breaker state and lifetime stats.

        A rolling restart rebuilds the serving engine — and with it the
        scheduler's quarantine — from scratch.  Without banking, every
        OPEN breaker is forgotten and the restarted replica re-eats
        ``k`` poison strikes per known-bad signature, wave after wave.
        ``ReplicaHandle.restart`` calls this right after the rebuild
        (next to the scheduler-counter banking) so breakers ride
        through.  The replica clock is monotone across a restart (the
        new engine's clock resumes at ``now + downtime``), so inherited
        ``opened_t`` values keep their meaning for half-open timing.
        """
        self._breakers = other._breakers
        self.stats = other.stats

    # -- introspection -------------------------------------------------------

    @property
    def any_tracked(self) -> bool:
        return bool(self._breakers)

    def state_of(self, sig: str) -> str:
        br = self._breakers.get(sig)
        return br.state if br is not None else CLOSED

    def per_signature(self) -> Dict[str, Dict[str, object]]:
        return {sig: {"state": br.state, "strikes": br.strikes,
                      "n_errors": br.n_errors, "n_blocked": br.n_blocked,
                      "n_probes": br.n_probes}
                for sig, br in self._breakers.items()}

    def max_errors_per_signature(self) -> int:
        return max((br.n_errors for br in self._breakers.values()),
                   default=0)
