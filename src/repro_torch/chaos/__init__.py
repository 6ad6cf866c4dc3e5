"""repro_torch.chaos — trace-driven chaos engineering for the trust fleet.

Counterpart of ``repro.chaos`` (host logic, copied).

Two halves, one seed:

* ``trace`` — the deterministic workload engine. A :class:`TraceConfig`
  materializes (via :func:`make_trace`) into a concrete arrival list —
  diurnal rate curve, flash-crowd windows, Zipf tenant skew, correlated
  hot-URL floods — plus a scripted fault timeline: query-of-death
  poison windows (:func:`poisonable` evaluator wrapper), correlated
  regional failures, coordinated rolling restarts, shard slowdowns.
* ``driver`` — :func:`run_fleet_trace` replays a trace against a live
  ``ClusterCoordinator`` and :func:`response_fingerprint` hashes the
  result set for the bit-determinism gate.

The reference's chaos gates live in its benchmark
``benchmarks/bench_fleet.py`` (not ported); ``chip_smoke.py`` replays a
trace twice on the card and compares fingerprints.
"""
from repro_torch.chaos.driver import (response_fingerprint, run_fleet_trace)
from repro_torch.chaos.trace import (EvaluatorHangError, FlashCrowd,
                                     POISON_FEATURE, POISON_HANG,
                                     POISON_RAISE, PoisonPillError,
                                     PoisonSpec, RegionalFailure,
                                     RollingRestartEvent, SlowShardEvent,
                                     TraceArrival, TraceConfig, make_trace,
                                     poisonable)

__all__ = [
    "EvaluatorHangError",
    "FlashCrowd",
    "POISON_FEATURE",
    "POISON_HANG",
    "POISON_RAISE",
    "PoisonPillError",
    "PoisonSpec",
    "RegionalFailure",
    "RollingRestartEvent",
    "SlowShardEvent",
    "TraceArrival",
    "TraceConfig",
    "make_trace",
    "poisonable",
    "response_fingerprint",
    "run_fleet_trace",
]
