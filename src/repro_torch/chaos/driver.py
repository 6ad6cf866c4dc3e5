"""Fleet-scale trace replay driver.

Counterpart of ``repro.chaos.driver`` (host logic, copied).

:func:`run_fleet_trace` drives a ``ClusterCoordinator`` with a
materialized chaos trace (``trace.make_trace``): arrivals enqueue in
timestamp order, scripted fault events fire as the arrival clock passes
them, and drain rounds run on a time cadence (one round per per-replica
batch service time — the continuously-busy serving loop, same cadence
policy as ``run_churn_workload``). Regional failures and shard
slowdowns reuse the churn driver's :func:`apply_churn_event` verbatim,
so victim picks stay the same deterministic worst-case choices the
elastic tests already pin.

Every arrival carries the ``POISON_FEATURE`` column (zeros on clean
traffic) — the batcher requires uniform feature keys, and the column is
what lets a query-of-death arrival detonate a
:func:`~repro_torch.chaos.trace.poisonable` evaluator wherever its batch
lands.

:func:`response_fingerprint` hashes a response set into one md5 hex
digest, order-independent (rows sort by request id): the bit-
determinism gate replays a trace twice and asserts equal fingerprints.
"""
from __future__ import annotations

import hashlib
from typing import List, Optional

import numpy as np

from repro_torch.chaos.trace import (POISON_FEATURE, RegionalFailure,
                                     RollingRestartEvent, SlowShardEvent,
                                     TraceConfig, make_trace)
from repro_torch.serving.simulator import (ChurnEvent, SchedSimReport,
                                           apply_churn_event)


def _fire(coordinator, ev, log: List) -> None:
    if isinstance(ev, RegionalFailure):
        # Correlated regional outage: n_crash heaviest-loaded replicas
        # die on the same tick (apply_churn_event re-picks the heaviest
        # after each kill and never takes the last replica).
        for _ in range(ev.n_crash):
            log.append(apply_churn_event(
                coordinator, ChurnEvent(t=ev.t, action="crash")))
    elif isinstance(ev, RollingRestartEvent):
        coordinator.rolling_restart(downtime_s=ev.downtime_s,
                                    max_wave_frac=ev.max_wave_frac)
        log.append((ev.t, "rolling_restart", None,
                    coordinator.n_replicas))
    elif isinstance(ev, SlowShardEvent):
        log.append(apply_churn_event(
            coordinator, ChurnEvent(t=ev.t, action=ev.action,
                                    mult=ev.mult)))
    else:                               # pragma: no cover — schema guard
        raise TypeError(f"unknown trace event {ev!r}")


def run_fleet_trace(coordinator, searcher, cfg: TraceConfig,
                    round_s: Optional[float] = None) -> SchedSimReport:
    """Replay a chaos trace against a live fleet. Deterministic end to
    end: the trace materializes from ``cfg.seed``, the searcher derives
    candidates from each query string, and the simulated fleet drains
    on a fixed cadence — same config, same responses, bit for bit."""
    arrivals, events = make_trace(cfg)
    ei = 0
    log: List = []
    n0 = len(coordinator.completed)
    if round_s is None:
        clock = coordinator.replicas[0].clock
        rate = clock.rate if clock is not None else None
        round_s = (coordinator.max_batch_items / rate
                   if rate else 0.05)
    next_drain = round_s
    for arr in arrivals:
        while ei < len(events) and events[ei].t <= arr.t:
            _fire(coordinator, events[ei], log)
            ei += 1
        res = searcher.search(arr.query, arr.n_results)
        feats = dict(res.features)
        feats["trust"] = res.exact_trust
        feats[POISON_FEATURE] = np.full(len(res.url_ids), arr.poison,
                                        np.float32)
        coordinator.enqueue(res.url_ids, res.buckets, feats,
                            slo_s=cfg.slo_s, priority=arr.priority,
                            tenant=arr.tenant, t_arrival=arr.t)
        while next_drain <= arr.t:
            coordinator.drain(max_rounds=1)
            next_drain += round_s
    while ei < len(events):             # events past the last arrival
        _fire(coordinator, events[ei], log)
        ei += 1
    coordinator.drain()
    # Feedforward joins are fleet events too: fold the planner's
    # prewarm-join log into the churn timeline (same 4-tuple shape the
    # scripted events use) so trace reports show WHEN capacity arrived
    # relative to the wave that needed it.
    for entry in getattr(coordinator, "planner_log", []):
        log.append((entry["t"], "prewarm_join", entry["replica"],
                    entry["n_replicas"]))
    log.sort(key=lambda row: row[0])
    return SchedSimReport(responses=list(coordinator.completed[n0:]),
                          scheduler_stats=coordinator.scheduler_stats(),
                          churn_log=log)


def response_fingerprint(responses) -> str:
    """Order-independent md5 of a response set: one row per response —
    ``(request_id, admitted, reason, latency, trust bytes)`` — sorted
    by request id, so the digest ignores completion-order jitter but
    pins every externally-visible field bit-exactly."""
    rows = sorted(
        (int(r.request_id), bool(r.admitted), str(r.reason),
         np.float64(r.latency_s).tobytes(),
         np.asarray(r.trust, np.float32).tobytes())
        for r in responses)
    h = hashlib.md5()
    for rid, adm, reason, lat, trust in rows:
        h.update(f"{rid}|{int(adm)}|{reason}|".encode())
        h.update(lat)
        h.update(trust)
        h.update(b";")
    return h.hexdigest()
