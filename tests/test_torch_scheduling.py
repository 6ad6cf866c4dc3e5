"""The port's scheduler against ``repro.scheduling`` on the CPU: one
seeded script of submits, drains and clock advances (four priorities,
three tenants, token-bucket rate limits, queue backpressure, hedged
re-dispatch, a poison evaluator tripping the quarantine breaker, and
adaptive pipeline depth) gives the same admissions, rejection reasons,
batch packing, tiers and scheduler stats in both packages, on the
deterministic stub evaluator of the reference's fused-drain tests.
Trust is allclose (atol 1e-5: the frameworks round the sigmoid
differently). The fleet hooks — work stealing (``EDFQueue.pop_back``,
``PriorityQueueBank.steal_back``) and the quarantine's restart banking
(``adopt``) and introspection — take the same entries and report the
same breakers."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrustIRConfig as TrustIRConfig_j
from repro.core import LoadShedder as LoadShedder_j, SimClock as SimClock_j
from repro.scheduling import (MicroBatcher as MicroBatcher_j,
                              PoisonQuarantine as PoisonQuarantine_j,
                              Priority as Priority_j,
                              PriorityQueueBank as PriorityQueueBank_j,
                              QueuedRequest as QueuedRequest_j,
                              Request as Request_j,
                              Scheduler as Scheduler_j,
                              SchedulerConfig as SchedulerConfig_j,
                              to_fused_inputs as to_fused_inputs_j)
from repro_torch.configs import TrustIRConfig
from repro_torch.core.shedder import LoadShedder, SimClock
from repro_torch.scheduling import (MicroBatcher, PoisonQuarantine, Priority,
                                    PriorityQueueBank, QueuedRequest,
                                    Request, Scheduler, SchedulerConfig,
                                    to_fused_inputs)

D = 8
W = np.linspace(-1.0, 1.0, D).astype(np.float32)
POISON = 1.0e6                     # x[:, 0] at this value raises


@jax.jit
def _ev_jit(x):
    return jax.nn.sigmoid(x @ jnp.asarray(W)) * 5.0


def _ev_j(chunk):
    x = np.asarray(chunk["x"])
    if (x[:, 0] >= POISON).any():
        raise ValueError("poison candidate")
    return np.asarray(_ev_jit(jnp.asarray(x)))


def _ev_t(chunk):
    x = chunk["x"]
    if bool((x[:, 0] >= POISON).any()):
        raise ValueError("poison candidate")
    return torch.sigmoid(x @ torch.from_numpy(W)) * 5.0


CFG = dict(u_capacity=128, u_threshold=128, deadline_s=0.5,
           overload_deadline_s=1.0, chunk_size=16, cache_slots=1024,
           cache_ways=2)
SCHED = dict(max_batch_items=256, queue_capacity_requests=4,
             hedge_after_s=0.25)
QUOTA_C = (100.0, 200.0)           # tenant "c": items/s, burst
TENANTS = ("a", "b", "c")


def _script(seed, n_steps=90):
    """[(kind, ...)]: submits of seeded sizes/priorities/tenants, six
    poison requests (all with one candidate set), one CRITICAL burst,
    and drains."""
    r = np.random.default_rng(seed)
    steps, rid, t = [], 0, 0.0
    for i in range(n_steps):
        t += float(r.exponential(0.04))
        if i == n_steps // 3:
            # a CRITICAL burst overruns its queue: backpressure
            for _ in range(6):
                steps.append(("submit", rid, t, 16, 0, "a", False,
                              int(r.integers(0, 2 ** 31))))
                rid += 1
        if i % (n_steps // 6) == 5:
            # a query of death (CRITICAL: no ladder or quota stops it)
            steps.append(("submit", rid, t, 40, 0, "b", True, 0))
            rid += 1
        if r.random() < 0.7:
            n = int(r.integers(8, 120))
            steps.append(("submit", rid, t, n, int(r.choice(4, p=[
                0.15, 0.25, 0.4, 0.2])), TENANTS[int(r.integers(3))],
                False, int(r.integers(0, 2 ** 31))))
            rid += 1
        else:
            steps.append(("drain", t, int(r.choice([1, 2, 0]))))
    steps.append(("drain", t + 5.0, 0))
    return steps


def _request(pkg, step):
    _, rid, t, n, _, _, poison, fseed = step
    r = np.random.default_rng(fseed)
    if poison:
        keys = np.arange(900_001, 900_001 + 40, dtype=np.uint32)
        x = np.full((40, D), POISON, np.float32)
        n = 40
    else:
        keys = r.integers(1, 5000, n).astype(np.uint32)
        x = r.normal(size=(n, D)).astype(np.float32)
    buckets = r.integers(0, 4, n).astype(np.int32)
    req_cls = Request_j if pkg == "j" else Request
    return req_cls(rid, keys, buckets, {"x": x}, arrival_s=t, slo_s=1.0)


def _record(resp):
    return (resp.request_id, resp.priority.name, resp.admitted, resp.reason,
            resp.hedged, resp.tier.tolist(), int(resp.shed.regime),
            resp.shed.uload, resp.shed.n_evaluated, resp.shed.n_cached,
            resp.shed.n_prior, round(resp.latency_s, 9),
            round(resp.queue_delay_s, 9))


def _run(pkg, script, **cfg_kw):
    kw = dict(CFG, **cfg_kw)
    rate = kw["u_capacity"] / kw["deadline_s"]
    if pkg == "j":
        cfg = TrustIRConfig_j(**kw)
        clock = SimClock_j(rate)
        shedder = LoadShedder_j(cfg, _ev_j, sim_clock=clock)
        sch = Scheduler_j(cfg, shedder, SchedulerConfig_j(**SCHED),
                          now=clock.now)
        prio = Priority_j
    else:
        cfg = TrustIRConfig(**kw)
        clock = SimClock(rate)
        shedder = LoadShedder(cfg, _ev_t, sim_clock=clock, device="cpu")
        sch = Scheduler(cfg, shedder, SchedulerConfig(**SCHED),
                        now=clock.now)
        prio = Priority
    sch.limiter.configure("c", *QUOTA_C)
    log, trust = [], []
    for step in script:
        if step[0] == "submit":
            clock.t = max(clock.t, step[2])
            out = sch.submit(_request(pkg, step), priority=prio(step[4]),
                             tenant=step[5])
            out = [] if out is None else [out]
        else:
            clock.t = max(clock.t, step[1])
            out = sch.drain(max_batches=step[2] or None)
        for resp in out:
            log.append(_record(resp))
            trust.append(np.asarray(resp.trust))
    dc = sch.depth_controller
    q = sch.quarantine
    return (log, trust, sch.stats.as_dict(),
            dc.stats() if dc is not None else None,
            q.stats.as_dict() if q is not None else None)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("extra", [
    {},
    {"quarantine_k": 2, "quarantine_probe_after_s": 5.0},
    {"adaptive_depth": True, "pipeline_depth": 3,
     "adaptive_depth_hysteresis": 1, "adaptive_depth_cooldown_ticks": 1},
], ids=["plain", "quarantine", "adaptive-depth"])
def test_scheduler_matches_reference(seed, extra):
    script = _script(seed)
    log_j, trust_j, stats_j, depth_j, quar_j = _run("j", script, **extra)
    log_t, trust_t, stats_t, depth_t, quar_t = _run("t", script, **extra)
    assert log_t == log_j
    for a, b in zip(trust_t, trust_j):
        np.testing.assert_allclose(a, b, atol=1e-5)
    assert stats_t == stats_j
    assert depth_t == depth_j
    assert quar_t == quar_j
    # the script exercised what it claims
    reasons = set(stats_t["rejected_by_reason"])
    assert {"rate_limited", "queue_full"} <= reasons
    assert stats_t["n_hedges"] > 0 and stats_t["n_executor_errors"] > 0
    assert {r[4] for r in log_t} == {False, True}          # hedged twins
    if "quarantine_k" in extra:
        assert stats_t["n_quarantined"] > 0
    if "adaptive_depth" in extra:
        assert depth_t["n_ticks"] > 0
    # every submitted request answered exactly once
    rids = [r[0] for r in log_t]
    assert sorted(rids) == list(range(stats_t["n_submitted"]))


def test_batcher_packing_and_fused_inputs_match_reference():
    script = [s for s in _script(7) if s[0] == "submit"][:12]
    banks = {"j": PriorityQueueBank_j(64), "t": PriorityQueueBank(64)}
    for pkg, bank in banks.items():
        qcls, pcls = ((QueuedRequest_j, Priority_j) if pkg == "j"
                      else (QueuedRequest, Priority))
        for step in script:
            req = _request(pkg, step)
            bank.push(qcls(request=req, priority=pcls(step[4]),
                           tenant=step[5], deadline_t=step[2] + 1.0,
                           enqueue_t=step[2]))
    for _ in range(6):
        bj = MicroBatcher_j(200).form(banks["j"])
        bt = MicroBatcher(200).form(banks["t"])
        if bj is None:
            assert bt is None
            break
        assert [q.request.request_id for q, _, _ in bt.slices] == \
            [q.request.request_id for q, _, _ in bj.slices]
        for name in ("item_keys", "buckets", "valid", "segments"):
            np.testing.assert_array_equal(getattr(bt, name),
                                          getattr(bj, name))
        np.testing.assert_array_equal(bt.features["x"], bj.features["x"])
        keys_t, buckets_t, valid_t, feats_t = to_fused_inputs(bt, "cpu")
        keys_j, buckets_j, valid_j, feats_j = to_fused_inputs_j(bj)
        np.testing.assert_array_equal(
            keys_t.numpy().view(np.uint32), np.asarray(keys_j))
        np.testing.assert_array_equal(buckets_t.numpy(),
                                      np.asarray(buckets_j))
        np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
        np.testing.assert_array_equal(feats_t["x"].numpy(),
                                      np.asarray(feats_j["x"]))


def _banks(seed, capacity=64):
    script = [s for s in _script(seed) if s[0] == "submit"][:30]
    banks = {"j": PriorityQueueBank_j(capacity),
             "t": PriorityQueueBank(capacity)}
    for pkg, bank in banks.items():
        qcls, pcls = ((QueuedRequest_j, Priority_j) if pkg == "j"
                      else (QueuedRequest, Priority))
        for step in script:
            bank.push(qcls(request=_request(pkg, step),
                           priority=pcls(step[4]), tenant=step[5],
                           deadline_t=step[2] + 1.0, enqueue_t=step[2]))
    return banks


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("costed", [False, True], ids=["latest", "costed"])
def test_steal_back_and_pop_back_match_reference(seed, costed):
    """Victim-side stealing leaves every class head in place and picks
    the same entries: the latest-deadline back entry, or the costliest
    of the back region under a cost function."""
    banks = _banks(seed)

    def cost(qreq):                     # a stand-in for Trust-DB misses
        return float(qreq.n_items % 7)

    taken = {}
    for pkg, bank in banks.items():
        heads = {p.name: q.peek().request.request_id
                 for p, q in bank.queues.items() if len(q)}
        log = []
        while True:
            qreq = bank.steal_back(min_leave=1,
                                   cost_fn=cost if costed else None)
            if qreq is None:
                break
            log.append((qreq.request.request_id, qreq.priority.name))
        # one more class-level pop_back with a small candidate window
        crit = bank.queues[list(bank.queues)[0]]
        got = crit.pop_back(cost_fn=cost if costed else None,
                            max_candidates=3)
        log.append(got.request.request_id if got is not None else None)
        log.append(sorted(heads.items()))
        for p, q in bank.queues.items():
            if p.name != "CRITICAL" and len(q):
                assert q.peek().request.request_id == heads[p.name]
        taken[pkg] = log
    assert taken["t"] == taken["j"]
    assert len(taken["t"]) > 3


def test_quarantine_adopt_and_introspection_match_reference():
    out = {}
    for pkg, cls in (("t", PoisonQuarantine), ("j", PoisonQuarantine_j)):
        clock = {"t": 0.0}
        q = cls(2, 1.0, lambda: clock["t"])
        for i, sig in enumerate(["a", "b", "a", "c", "a", "b", "c", "c"]):
            clock["t"] = 0.1 * i
            q.record_failure(sig)
            if sig == "c" and i == 3:
                q.record_success("c")
        clock["t"] = 2.0
        checks = [q.check(s) for s in ("a", "b", "c", "d", "a")]
        fresh = cls(2, 1.0, lambda: clock["t"])
        fresh.adopt(q)
        out[pkg] = (checks, fresh.per_signature(),
                    [fresh.state_of(s) for s in "abcd"],
                    fresh.max_errors_per_signature(),
                    fresh.stats.as_dict(), fresh.any_tracked)
    assert out["t"] == out["j"]
    assert out["t"][3] == 3 and "half_open" in out["t"][2]
