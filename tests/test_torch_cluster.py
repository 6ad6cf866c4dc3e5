"""The port's serving fleet (``repro_torch.cluster``) against
``repro.cluster`` on the CPU: the consistent-hash ring, the load heap,
the gossip bus, the autoscaler and forecast planner, ``capacity.predict``,
and ``ClusterCoordinator`` itself on SimClocks with the deterministic
stub evaluators (``lambda ch: ch["x"]`` on 1-D features, as
``tests/test_cluster.py`` uses it, and ``lambda ch: ch["trust"]`` — the
oracle trust the workload drivers attach — on the simulator's
workloads) at 1, 3 and 6 replicas with stealing, hedging, gossip and
KV-slot admission.

Everything here is host logic or a bit-exact Trust-DB op, so every
comparison is exact: ``response_fingerprint`` (request ids, admission,
reasons, float64 latency bytes, float32 trust bytes) and the whole
``scheduler_stats()`` dict, floats included."""
import dataclasses

import numpy as np
import pytest

import repro.cluster as CJ
import repro_torch.cluster as CT
from repro.chaos import response_fingerprint as fingerprint_j
from repro.configs.base import reduced as reduced_j
from repro.configs.trust_ir import smoke_config as smoke_j
from repro.core.pipeline import SyntheticSearcher as SyntheticSearcher_j
from repro.scheduling import Priority as Priority_j
from repro.serving import simulator as sim_j
from repro.serving.kv_cache import SlotAllocator as SlotAllocator_j
from repro_torch.chaos import response_fingerprint
from repro_torch.configs.base import reduced
from repro_torch.configs.trust_ir import smoke_config
from repro_torch.core.pipeline import SyntheticSearcher
from repro_torch.core.shedder import TIER_INVALID
from repro_torch.scheduling import Priority
from repro_torch.serving import simulator as sim
from repro_torch.serving.kv_cache import SlotAllocator

TENANTS = [f"tenant{i}" for i in range(240)]


# ---------------------------------------------------------------------------
# routing, load heap, gossip
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0),
                                     (4.0, 1.0, 2.0, 1.0),
                                     (1.0,) * 6],
                         ids=["equal3", "weighted4", "equal6"])
def test_ring_matches_reference(weights):
    rings = (CT.ConsistentHashRing(), CJ.ConsistentHashRing())
    for ring in rings:
        for i, w in enumerate(weights):
            ring.add(f"r{i}", w)

    def view(ring):
        return (ring.assignments(TENANTS),
                [ring.route_chain(t, len(weights)) for t in TENANTS[:40]],
                [ring.backup_for(t) for t in TENANTS[:40]],
                ring.remap_diff(TENANTS, remove="r1"),
                ring.remap_diff(TENANTS, add=("r9", 2.0)),
                ring.sibling_for("docpart:3", exclude=("r0",)))

    assert view(rings[0]) == view(rings[1])
    for ring in rings:
        ring.fence("r1")
    assert view(rings[0]) == view(rings[1])
    for ring in rings:
        ring.unfence("r1")
        ring.remove("r0")
    assert view(rings[0])[0] == view(rings[1])[0]
    assert [CT.stable_hash(t) for t in TENANTS] == \
        [CJ.stable_hash(t) for t in TENANTS]


def test_load_heap_matches_reference():
    rng = np.random.default_rng(7)
    loads = {f"r{i}": int(rng.integers(0, 50)) for i in range(9)}
    heaps = (CT.ReplicaLoadHeap(dict(loads)), CJ.ReplicaLoadHeap(dict(loads)))
    for step in range(200):
        rid = f"r{int(rng.integers(0, 11))}"
        if step % 17 == 16 and rid in heaps[0]:
            for h in heaps:
                h.remove(rid)
        else:
            load = int(rng.integers(0, 60))
            for h in heaps:
                h.update(rid, load)
        a, b = heaps
        assert (a.hottest(), a.coldest(), a.gap(), len(a)) == \
            (b.hottest(), b.coldest(), b.gap(), len(b))


class _Sink:
    """A replica stand-in that records every delta applied to it."""

    def __init__(self, rid):
        self.replica_id = rid
        self.applied = []

    def apply_trust_deltas(self, keys, values):
        self.applied.append((np.asarray(keys).tolist(),
                             np.asarray(values).tolist()))


@pytest.mark.parametrize("mode", ["broadcast", "epidemic"])
def test_gossip_bus_messages_and_budget_match_reference(mode):
    buses = (CT.TrustGossipBus(48, mode=mode, seed=3),
             CJ.TrustGossipBus(48, mode=mode, seed=3))
    fleets = ([_Sink(f"r{i}") for i in range(7)],
              [_Sink(f"r{i}") for i in range(7)])
    rng = np.random.default_rng(11)
    for rnd in range(12):
        n_live = 7 if rnd < 8 else 5          # two members leave
        for _ in range(int(rng.integers(1, 5))):
            origin = f"r{int(rng.integers(0, n_live))}"
            keys = rng.integers(1, 400, int(rng.integers(1, 30))
                                ).astype(np.uint32)
            vals = rng.random(len(keys)).astype(np.float32)
            gen = 1 if rng.random() < 0.15 else None   # a stale publish
            for bus in buses:
                bus.publish(origin, keys, vals, gen=gen)
        for bus, fleet in zip(buses, fleets):
            bus.flush(fleet[:n_live])
    assert buses[0].stats.as_dict() == buses[1].stats.as_dict()
    assert [s.applied for s in fleets[0]] == [s.applied for s in fleets[1]]
    st = buses[0].stats
    assert st.n_dropped_budget > 0 and st.n_dropped_stale > 0
    assert st.n_broadcast <= 48 * st.n_rounds


# ---------------------------------------------------------------------------
# capacity planning and autoscaling
# ---------------------------------------------------------------------------

def _service_models():
    out = []
    for mod, cfg in ((CT, smoke_config()), (CJ, smoke_j())):
        m = mod.ServiceTimeModel(cfg, drain_mode="host", pipeline_depth=2,
                                 batch_items=256)
        rng = np.random.default_rng(5)
        for i in range(40):
            n = int(rng.integers(32, 256))
            m.observe_batch(n, int(n * 0.7), n / 900.0 + rng.random() * 1e-3,
                            n_cached=int(n * 0.3), warm=i % 9 != 0)
            m.observe_device(int(n * 0.7), n / 1000.0)
            m.observe_queue(float(rng.random()) * 0.05)
        out.append(m)
    return out


def test_capacity_predict_matches_reference():
    """``predict`` is pure host arithmetic over the same fitted model:
    every field of the prediction is exact."""
    m_t, m_j = _service_models()
    assert m_t.fitted() == m_j.fitted()
    rng = np.random.default_rng(9)
    t = np.cumsum(rng.exponential(1 / 80.0, size=300))
    workload = [(float(a), int(rng.integers(20, 200)), f"tenant{i % 7}")
                for i, a in enumerate(t)]
    for n_rep, depth, batch in ((1, 1, 256), (3, 2, 256), (6, 2, 128)):
        p_t = CT.predict(m_t, n_rep, depth, batch, workload)
        p_j = CJ.predict(m_j, n_rep, depth, batch, workload)
        assert dataclasses.asdict(p_t) == dataclasses.asdict(p_j)
        assert p_t.n_requests == len(workload)


def test_forecast_planner_matches_reference():
    m_t, m_j = _service_models()
    planners = (CT.ForecastPlanner(warmup_lead_s=0.5, window_s=2.0,
                                   model=m_t),
                CJ.ForecastPlanner(warmup_lead_s=0.5, window_s=2.0,
                                   model=m_j))
    rng = np.random.default_rng(2)
    t, out = 0.0, ([], [])
    while t < 6.0:
        t += float(rng.exponential(1.0 / (20.0 + 30.0 * t)))   # a ramp
        n = int(rng.integers(10, 100))
        for p, o in zip(planners, out):
            p.observe_arrival(t, n)
            o.append((p.forecast_pressure(t, rate_items_per_s=3000.0),
                      p.rate_estimate(t), p.forecast_rate(t)))
    assert out[0] == out[1]
    assert planners[0].stats() == planners[1].stats()
    assert max(f for f, _, _ in out[0]) > 0.0


def _stub_coordinator(pkg, n_replicas, cluster_kw=None, rate_scale=0.5,
                      kv_pools=None, key="x", **cfg_kw):
    if pkg == "t":
        cfg = reduced(smoke_config(), n_replicas=n_replicas, **cfg_kw)
        rate = rate_scale * cfg.u_capacity / cfg.deadline_s
        return CT.ClusterCoordinator(
            cfg, lambda ch: ch[key],
            cluster_cfg=CT.ClusterConfig(**(cluster_kw or {})),
            sim_rate_items_per_s=rate, kv_pools=kv_pools, device="cpu")
    cfg = reduced_j(smoke_j(), n_replicas=n_replicas, **cfg_kw)
    rate = rate_scale * cfg.u_capacity / cfg.deadline_s
    return CJ.ClusterCoordinator(
        cfg, lambda ch: np.asarray(ch[key]),
        cluster_cfg=CJ.ClusterConfig(**(cluster_kw or {})),
        sim_rate_items_per_s=rate, kv_pools=kv_pools)


def test_autoscaler_decisions_match_reference():
    """Snapshots (watermarks, tenant quotas, pressure) and membership
    votes of both autoscalers over a load that rises and falls."""
    coords = (_stub_coordinator("t", 3), _stub_coordinator("j", 3))
    scalers = (CT.WatermarkAutoscaler(scale_cooldown_ticks=1),
               CJ.WatermarkAutoscaler(scale_cooldown_ticks=1))
    rng = np.random.default_rng(4)
    votes = ([], [])
    for step in range(40):
        n_new = int(rng.integers(0, 6)) if step < 7 else 0
        for i in range(n_new):
            n = int(rng.integers(20, 120))
            keys = np.arange(step * 10_000 + i * 300 + 1,
                             step * 10_000 + i * 300 + n + 1,
                             dtype=np.uint32)
            feats = {"x": np.linspace(0, 5, n, dtype=np.float32)}
            for c in coords:
                c.enqueue(keys, np.zeros(n, np.int32), feats,
                          tenant=f"tenant{i}", slo_s=5.0)
        fp = 0.9 if step == 3 else None
        for c, s, v in zip(coords, scalers, votes):
            snap = s.update(c.replicas, c.tenants_seen)
            v.append((snap.as_dict(),
                      s.membership_decision(c.n_replicas, 1, 5,
                                            forecast_pressure=fp)))
            if step % 2 or step >= 7:
                c.drain(max_rounds=1)
    assert votes[0] == votes[1]
    assert {d for _, d in votes[0]} >= {1, -1}


# ---------------------------------------------------------------------------
# the coordinator end to end
# ---------------------------------------------------------------------------

def _workload(mod, n_queries=120, slo=1.0):
    P = mod.Priority
    return mod.MultiTenantWorkload(tenants=[
        mod.TenantSpec(f"tenant{i}", qps=40.0, max_results=400, slo_s=slo,
                       priority_mix={P.CRITICAL: 1, P.HIGH: 1,
                                     P.NORMAL: 2, P.LOW: 1})
        for i in range(6)], n_queries=n_queries, seed=3)


def _run_pair(n_replicas, cluster_kw, driver="cluster", **cfg_kw):
    out = []
    for pkg, mod, searcher in (("t", sim, SyntheticSearcher),
                               ("j", sim_j, SyntheticSearcher_j)):
        coord = _stub_coordinator(pkg, n_replicas, cluster_kw,
                                  key="trust", **cfg_kw)
        run = (mod.run_cluster_workload if driver == "cluster"
               else mod.run_churn_workload)
        args = () if driver == "cluster" else ([],)
        rep = run(coord, searcher(corpus_size=5000, seed=1), _workload(mod),
                  *args)
        out.append((coord, rep))
    return out


def _assert_no_drop(coord, rep):
    rids = [r.request_id for r in rep.responses]
    assert len(rids) == len(set(rids)) == rep.scheduler_stats["n_submitted"]
    for r in rep.responses:
        if r.admitted:
            assert (r.tier != TIER_INVALID).all()
        else:
            assert r.reason


@pytest.mark.parametrize("n_replicas,cluster_kw,driver,cfg_kw", [
    (1, {}, "cluster", {}),
    (3, dict(hedge_after_s=0.05), "cluster", {}),
    (3, dict(hedge_after_s=0.05, gossip=True, cost_aware_steal=False),
     "churn", {}),
    (3, dict(autoscale=True, min_replicas=2, max_replicas=5,
             forecast=True, warmup_lead_s=0.3), "churn", {}),
    (6, dict(hedge_after_s=0.05, gossip=True, gossip_mode="epidemic",
             autoscale=True), "cluster", {}),
    (6, dict(hedge_after_s=0.05, gossip=True), "churn",
     dict(quarantine_k=2, adaptive_depth=True)),
], ids=["r1", "r3-hedge", "r3-gossip-plain-steal", "r3-elastic-forecast",
        "r6-epidemic-autoscale", "r6-gossip-quarantine-adaptive-depth"])
def test_coordinator_matches_reference(n_replicas, cluster_kw, driver,
                                       cfg_kw):
    (c_t, r_t), (c_j, r_j) = _run_pair(n_replicas, cluster_kw, driver,
                                       **cfg_kw)
    assert response_fingerprint(r_t.responses) == \
        fingerprint_j(r_j.responses)
    assert r_t.scheduler_stats == r_j.scheduler_stats
    assert r_t.churn_log == r_j.churn_log
    _assert_no_drop(c_t, r_t)
    c = r_t.scheduler_stats["cluster"]
    if n_replicas > 1:
        assert c["n_steals"] > 0
    if cluster_kw.get("hedge_after_s"):
        assert c["n_hedges"] > 0
    if cluster_kw.get("gossip"):
        assert r_t.scheduler_stats["gossip"]["n_applied"] > 0
    if cluster_kw.get("forecast"):
        assert c["n_joins"] > 0


def test_kv_slot_admission_matches_reference():
    """Decode requests on a fleet whose thief has no claimable KV slot:
    the steal veto and the slot-aware batching give the same responses
    in both packages."""
    out = []
    for pkg, alloc, P in (("t", SlotAllocator, Priority),
                          ("j", SlotAllocator_j, Priority_j)):
        coord = _stub_coordinator(
            pkg, 2, dict(steal_threshold_items=1, cost_aware_steal=True),
            rate_scale=1.0, kv_pools=[alloc(n_slots=2), alloc(n_slots=0)])
        t_hot = next(t for t in (f"t{i}" for i in range(50))
                     if coord.ring.route(t) == "r0")
        for i in range(10):
            n = 20 + i
            coord.enqueue(np.arange(i * 1000 + 1, i * 1000 + n + 1,
                                    dtype=np.uint32),
                          np.zeros(n, np.int32),
                          {"x": np.linspace(0, 5, n, dtype=np.float32)},
                          tenant=t_hot, slo_s=10.0,
                          priority=P.NORMAL if i % 3 else P.HIGH,
                          needs_kv_slot=(i % 2 == 0))
            if i % 4 == 3:
                coord.drain(max_rounds=1)
        coord.drain()
        out.append(coord)
    c_t, c_j = out
    assert response_fingerprint(c_t.completed) == \
        fingerprint_j(c_j.completed)
    assert c_t.scheduler_stats() == c_j.scheduler_stats()
    assert len(c_t.completed) == 10
    assert c_t.stats.n_steals > 0
