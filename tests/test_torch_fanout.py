"""The port's tail-tolerant scatter-gather (``repro_torch.fanout``)
against ``repro.fanout`` on the CPU: the service model's counter-seeded
draws bit for bit, ``QuorumGather.split``/``adapt`` and
``StripeReplicator.due``/``recovered`` on the same inputs, lossless
mirror stripes built on their primary's device, ``FanoutSearcher``
(quorum, hedging onto mirrors, the stripe answer cache, replication)
over a seeded query stream with stragglers, and the coordinator's
fan-out fleet through slow/recover churn at 1, 3 and 6 replicas:
``response_fingerprint``, ``scheduler_stats()`` (its ``fanout`` and
``cluster`` entries included) and churn logs equal the reference's.

Ids, gather reports and every counter are exact. Scores are held at
float32 rounding (rtol 1e-6): the reference ranks float32 BM25 scores,
the port float64 ones (ROADMAP.md, Queue 3)."""
import dataclasses

import numpy as np
import pytest

import repro.cluster as CJ
import repro.fanout as FJ
import repro_torch.cluster as CT
import repro_torch.fanout as FT
from repro.chaos import response_fingerprint as fingerprint_j
from repro.configs.base import reduced as reduced_j
from repro.configs.trust_ir import smoke_config as smoke_j
from repro.distribution.fault_tolerance import HedgedDispatch as Hedge_j
from repro.retrieval import CorpusRetrieval as CorpusRetrieval_j
from repro.retrieval import SyntheticCorpus as SyntheticCorpus_j
from repro.retrieval import ZipfQueryModel as ZipfQueryModel_j
from repro.serving import simulator as sim_j
from repro_torch.chaos import response_fingerprint
from repro_torch.configs.base import reduced
from repro_torch.configs.trust_ir import smoke_config
from repro_torch.core.shedder import TIER_INVALID
from repro_torch.distribution.fault_tolerance import HedgedDispatch
from repro_torch.retrieval import (CorpusRetrieval, CorpusSearcher,
                                   SyntheticCorpus, ZipfQueryModel,
                                   index_checksum)
from repro_torch.serving import simulator as sim

SCORE_RTOL = 1e-6
CORPUS_KW = dict(n_docs=192, vocab_size=256, doc_len=24, seed=3)


@pytest.fixture(scope="module")
def pair():
    """(port, reference) retrievals over the same 8-stripe corpus."""
    ct, cj = SyntheticCorpus(**CORPUS_KW), SyntheticCorpus_j(**CORPUS_KW)
    return (CorpusRetrieval(ct, n_partitions=8, block_docs=48,
                            device="cpu"),
            CorpusRetrieval_j(cj, n_partitions=8, block_docs=48))


def _shards(ret):
    return ([ret.build_shard([p]) for p in range(ret.n_partitions)],
            [f"s{p}" for p in range(ret.n_partitions)])


def _queries(corpus, n, seed=11):
    qm = ZipfQueryModel.for_corpus(corpus, seed=seed)
    return [qm.sample() for _ in range(n)]


def _same_answer(got, want):
    (dt, st), (dj, sj) = got, want
    assert dt.tolist() == np.asarray(dj).tolist()
    np.testing.assert_allclose(st, np.asarray(sj, np.float64),
                               rtol=SCORE_RTOL, atol=0)


# ---------------------------------------------------------------------------
# service model, quorum, replicator: host logic, exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(seed=0), dict(seed=7, straggler_p=0.2),
                                dict(seed=2 ** 33 + 5, tail_alpha=1.1,
                                     jitter_frac=0.5)],
                         ids=["default", "heavy-tail", "wide-seed"])
def test_service_draws_equal_the_reference_bit_for_bit(kw):
    mt, mj = FT.ShardServiceModel(**kw), FJ.ShardServiceModel(**kw)
    keys = ["r0", "r1", "s3", "docpart:7", "r2|m|r0"]
    for m in (mt, mj):
        m.set_persistent("r1", 6.0)
    for key in keys:
        for seq in (0, 1, 2, 17, 1000):
            assert mt.sample_at(key, seq) == mj.sample_at(key, seq)
            assert mt.sample_at(key, seq, mult_key="r1") == \
                mj.sample_at(key, seq, mult_key="r1")
    rng = np.random.default_rng(4)
    for _ in range(200):               # interleaved counters
        key = keys[int(rng.integers(0, len(keys)))]
        assert mt.sample(key) == mj.sample(key)
    for m in (mt, mj):
        m.clear_persistent("r1")
        m.reset()
    assert [mt.sample("r1") for _ in range(8)] == \
        [mj.sample("r1") for _ in range(8)]


def test_quorum_split_and_adapt_equal_the_reference():
    rng = np.random.default_rng(5)
    for q in range(0, 9):
        qt, qj = FT.QuorumGather(q), FJ.QuorumGather(q)
        for n in range(0, 9):
            times = [float(t) for t in rng.choice(
                [0.001, 0.004, 0.005, 0.04], size=n)]    # ties included
            assert qt.split(times) == qj.split(times)
            assert qt.effective_k(max(n, 1)) == qj.effective_k(max(n, 1))
    qt, qj = FT.QuorumGather(4, floor_k=2), FJ.QuorumGather(4, floor_k=2)
    for _ in range(120):
        regime, n = int(rng.integers(0, 3)), int(rng.integers(0, 10))
        assert qt.adapt(regime, n) == qj.adapt(regime, n)
    assert (qt.quorum_k, qt.n_adapts) == (qj.quorum_k, qj.n_adapts)
    assert qt.n_adapts > 10


@pytest.mark.parametrize("policy", [
    dict(), dict(min_probes=3, max_mirrors=1),
    dict(slow_factor=1.5, recover_factor=1.2, ewma_alpha=0.5,
         max_mirrors=3)], ids=["default", "one-mirror", "eager"])
def test_replicator_due_and_recovered_equal_the_reference(policy):
    rt = FT.StripeReplicator(FT.ReplicationPolicy(**policy))
    rj = FJ.StripeReplicator(FJ.ReplicationPolicy(**policy))
    rng = np.random.default_rng(9)
    keys = [f"r{i}" for i in range(6)]
    slow = {"r1": 12.0, "r4": 4.0}
    mirrored = set()
    for step in range(160):
        if step == 100:
            slow = {}                  # the disks got swapped
        key = keys[int(rng.integers(0, len(keys)))]
        t = 0.004 * (0.75 + 0.5 * rng.random()) * slow.get(key, 1.0)
        rt.observe(key, t)
        rj.observe(key, t)
        assert rt.baseline() == rj.baseline()
        due = rt.due(set(mirrored))
        assert due == rj.due(set(mirrored))
        mirrored |= set(due)
        back = rt.recovered(set(mirrored))
        assert back == rj.recovered(set(mirrored))
        mirrored -= set(back)
    assert rt._ewma == rj._ewma and rt._n == rj._n


# ---------------------------------------------------------------------------
# mirror stripes
# ---------------------------------------------------------------------------

def test_mirror_is_lossless_and_lives_on_the_primary_device(pair):
    ret, _ = pair
    primary = ret.build_shard([0, 1])
    before = (primary.n_docs, index_checksum(primary.index))
    mirror = FT.mirror_shard_of(primary)
    assert mirror.device == primary.device
    assert (primary.n_docs, index_checksum(primary.index)) == before
    assert index_checksum(mirror.index) == before[1]
    assert not primary._dense_ok and not mirror._dense_ok
    for q in _queries(ret.corpus, 12):
        d0, s0 = primary.retrieve(q, 8)
        d1, s1 = mirror.retrieve(q, 8)
        assert d0.tolist() == d1.tolist()
        assert s0.tobytes() == s1.tobytes()      # bit for bit
    # per-stripe mirrors carry exactly the stripes named
    part = FT.mirror_shard_of(primary, [ret.partition_doc_ids(1)])
    assert sorted(part.index.doc_len) == ret.partition_doc_ids(1)
    assert index_checksum(primary.index) == before[1]


def test_clone_stripe_never_aliases(pair):
    ret, _ = pair
    primary = ret.build_shard([2])
    sub = primary.export_docs(list(primary.index.doc_len)[:4])
    clone = FT.clone_stripe(sub)
    primary.absorb(sub)
    t = next(iter(clone.postings))
    clone.postings[t].append((10 ** 6, 1))
    clone.doc_len[10 ** 6] = 1
    assert 10 ** 6 not in sub.doc_len
    assert all(d != 10 ** 6 for d, _ in sub.postings.get(t, []))


# ---------------------------------------------------------------------------
# FanoutSearcher against the reference's
# ---------------------------------------------------------------------------

def _report(r):
    return dataclasses.asdict(r)


@pytest.mark.parametrize("case", [
    dict(quorum_k=0, persistent={"s3": 20.0}, straggler_p=0.1,
         hedge_after_s=0.002),
    dict(quorum_k=6, persistent={"s2": 50.0}),
    dict(quorum_k=7, persistent={"s0": 50.0}, repeat=True),
    dict(quorum_k=0, persistent={"s1": 40.0}, straggler_p=0.0,
         hedge_after_s=0.006, mirrors={"s1": "s4"}),
    dict(quorum_k=0, persistent={"s1": 10.0, "s2": 40.0}, straggler_p=0.0,
         shared_budget=dict(hedge_after_s=0.5, budget_frac=0.0,
                            budget_burst=1.0),
         hedge_after_s=0.006, mirrors={"s1": "s5", "s2": "s5"}),
    dict(quorum_k=6, persistent={"s5": 12.0}, straggler_p=0.05,
         hedge_after_s=0.002, maintain=True, recover_at=12, n=48),
], ids=["full-quorum-hedged", "partial-quorum", "answer-cache",
        "hedge-wins", "shared-budget-widest-gap", "maintain-recover"])
def test_fanout_searcher_equals_the_reference(pair, case):
    """Ids, scores, the per-query ``GatherReport`` and ``gather_stats()``
    over 24 or 48 seeded queries (each asked twice with ``repeat``), straggler
    injection, mirrors and standalone replication included."""
    ret, ret_j = pair
    fans = []
    for F, ret_x, H in ((FT, ret, HedgedDispatch), (FJ, ret_j, Hedge_j)):
        shards, keys = _shards(ret_x)
        model = F.ShardServiceModel(
            seed=21, straggler_p=case.get("straggler_p", 0.01))
        for key, mult in case["persistent"].items():
            model.set_persistent(key, mult)
        hedge = None
        if "shared_budget" in case:
            hedge = H(**case["shared_budget"]).probe_view(
                case["hedge_after_s"])
        fan = F.FanoutSearcher(
            ret_x.corpus, shards, keys, quorum_k=case["quorum_k"],
            service_model=model, hedge=hedge,
            hedge_after_s=case.get("hedge_after_s", 0.0),
            replicator=F.StripeReplicator(F.ReplicationPolicy(
                max_mirrors=1)))
        for key, host in case.get("mirrors", {}).items():
            fan.add_mirror(key, host,
                           F.mirror_shard_of(shards[keys.index(key)]))
        fans.append((fan, model))
    (ft, mt), (fj, mj) = fans
    qs = _queries(ret.corpus, case.get("n", 24), seed=31)
    if case.get("repeat"):
        qs = [q for q in qs for _ in range(2)]
    for i, q in enumerate(qs):
        if i == case.get("recover_at"):
            mt.clear_persistent("s5")
            mj.clear_persistent("s5")
        _same_answer(ft.retrieve(q, 16), fj.retrieve(q, 16))
        assert _report(ft.last_report) == _report(fj.last_report)
        if case.get("maintain"):
            ft.maintain()
            fj.maintain()
            assert {k: h for k, (h, _) in ft.mirrors.items()} == \
                {k: h for k, (h, _) in fj.mirrors.items()}
    assert ft.gather_stats() == fj.gather_stats()
    assert ft.gather_times == fj.gather_times
    st = ft.gather_stats()
    if case["quorum_k"]:
        assert st["n_late_shards"] > 0
        assert st["n_cache_fills"] + st["n_prior_answered"] \
            == st["n_late_shards"]
    if "mirrors" in case:
        assert st["n_shard_hedge_wins"] > 0
    if case.get("maintain"):
        assert st["n_mirrors_built"] >= 1 and st["n_mirrors_dropped"] >= 1
    if case.get("repeat"):
        assert st["n_cache_fills"] > 0


@pytest.mark.parametrize("adapt", [False, True], ids=["static", "adapted"])
def test_full_quorum_is_bit_identical_to_the_plain_gather(pair, adapt):
    """``quorum_k == n`` (static, or walked there by the regime ladder)
    with stragglers and hedging on returns exactly the synchronous
    gather: ids, order, float64 score bits and the ``search`` mapping."""
    ret, _ = pair
    shards, keys = _shards(ret)
    plain = CorpusSearcher(ret.corpus, shards)
    model = FT.ShardServiceModel(straggler_p=0.1, seed=2)
    model.set_persistent("s3", 20.0)
    fan = FT.FanoutSearcher(ret.corpus, shards, keys,
                            quorum_k=2 if adapt else len(shards),
                            service_model=model, hedge_after_s=0.002)
    while fan.quorum.quorum_k < len(shards):
        fan.quorum.adapt(0, len(shards))
    for q in _queries(ret.corpus, 16):
        d0, s0 = plain.retrieve(q, 16)
        d1, s1 = fan.retrieve(q, 16)
        assert d0.tolist() == d1.tolist() and s0.tobytes() == s1.tobytes()
        r0, r1 = plain.search(q, 16), fan.search(q, 16)
        assert np.array_equal(r0.url_ids, r1.url_ids)
        for f in r0.features:
            assert np.array_equal(r0.features[f], r1.features[f])
    assert fan.n_gathers == 32 and fan.n_late_shards == 0


def test_without_a_model_it_is_the_plain_gather(pair):
    ret, _ = pair
    shards, keys = _shards(ret)
    plain = CorpusSearcher(ret.corpus, shards)
    fan = FT.FanoutSearcher(ret.corpus, shards, keys)
    for q in _queries(ret.corpus, 8):
        d0, s0 = plain.retrieve(q, 16)
        d1, s1 = fan.retrieve(q, 16)
        assert d0.tolist() == d1.tolist() and s0.tobytes() == s1.tobytes()
    assert fan.n_gathers == 0


def test_set_fleet_and_warm_mirrors(pair):
    """``set_fleet`` drops mirrors whose shard or host left and clears the
    answer cache; ``add_mirror`` builds the mirror's dense form now
    (one warm probe) unless told not to."""
    ret, _ = pair
    shards, keys = _shards(ret)
    fan = FT.FanoutSearcher(ret.corpus, shards, keys, quorum_k=4,
                            service_model=FT.ShardServiceModel(seed=1))
    fan.retrieve(_queries(ret.corpus, 1)[0], 8)
    warm = FT.mirror_shard_of(shards[1])
    fan.add_mirror("s1", "s4", warm)
    assert warm._dense_ok
    cold = FT.mirror_shard_of(shards[2])
    fan.add_mirror("s2", "s5", cold, warm=False)
    assert not cold._dense_ok
    assert len(fan._answer_cache) > 0
    fan.set_fleet([(k, s) for k, s in zip(keys, shards) if k != "s4"])
    assert list(fan.mirrors) == ["s2"] and fan.n_mirrors_dropped == 1
    assert len(fan._answer_cache) == 0


def test_request_and_shard_hedges_share_one_budget(pair):
    """Whole-request twins and shard-probe hedges spend one token bucket
    through ``probe_view``, as in the reference: the books balance and
    neither starves."""
    ret, _ = pair
    shards, keys = _shards(ret)
    base = HedgedDispatch(hedge_after_s=0.5, budget_frac=0.5,
                          budget_burst=1.0)
    model = FT.ShardServiceModel(seed=9, straggler_p=0.0)
    model.set_persistent("s1", 40.0)
    fan = FT.FanoutSearcher(ret.corpus, shards, keys, quorum_k=0,
                            service_model=model,
                            hedge=base.probe_view(0.006),
                            hedge_after_s=0.006)
    fan.add_mirror("s1", "s4", FT.mirror_shard_of(shards[1]))
    req = shard = 0
    for i, q in enumerate(_queries(ret.corpus, 9)):
        if i % 3 == 0 and base.should_hedge(0.6, 0):
            base.record_hedge()
            req += 1
        before = fan.n_shard_hedges
        fan.retrieve(q, 8)
        shard += fan.n_shard_hedges - before
        base.note_request(1)
    assert req > 0 and shard > 0
    assert base.n_hedges_issued == req + shard
    assert fan.n_shard_twin_drops == shard
    assert base.budget_available >= 0.0


# ---------------------------------------------------------------------------
# the fleet: ClusterCoordinator with a fan-out searcher
# ---------------------------------------------------------------------------

def _fleet(pkg, n_replicas, cluster_kw=None, **cfg_kw):
    C, F, red, smoke, Corpus, Ret = (
        (CT, FT, reduced, smoke_config, SyntheticCorpus, CorpusRetrieval)
        if pkg == "t" else
        (CJ, FJ, reduced_j, smoke_j, SyntheticCorpus_j, CorpusRetrieval_j))
    corpus = Corpus(n_docs=384, vocab_size=256, seed=3)
    kw = {"device": "cpu"} if pkg == "t" else {}
    ret = Ret(corpus, n_partitions=24, block_docs=16, **kw)
    cfg = red(smoke(), n_replicas=n_replicas, **cfg_kw)
    ev = (lambda ch: ch["trust"]) if pkg == "t" \
        else (lambda ch: np.asarray(ch["trust"]))
    coord = C.ClusterCoordinator(
        cfg, ev, cluster_cfg=C.ClusterConfig(**(cluster_kw or {})),
        sim_rate_items_per_s=cfg.u_capacity / cfg.deadline_s,
        retrieval=ret, fanout_model=F.ShardServiceModel(seed=5), **kw)
    return coord, corpus


@pytest.mark.parametrize("n_replicas,cluster_kw,cfg_kw", [
    (1, {}, dict(fanout_quorum_k=1, fanout_hedge_after_s=0.006)),
    (3, {}, dict(fanout_quorum_k=2, fanout_hedge_after_s=0.006,
                 fanout_max_mirrors=1)),
    (6, dict(hedge_after_s=0.05, gossip=True),
     dict(fanout_quorum_k=4, fanout_hedge_after_s=0.006,
          fanout_adaptive_quorum=True)),
], ids=["r1", "r3-quorum-hedge", "r6-cluster-hedge-adaptive"])
def test_fanout_fleet_through_slow_recover_churn_matches_reference(
        n_replicas, cluster_kw, cfg_kw):
    """A slow/recover pair on one replica (the degraded-disk scenario)
    between raw-query arrivals: the same responses, stats (mirrors
    built on ring siblings and dropped after recovery, hedge wins, late
    stripes cache- or prior-answered) and churn log as the reference."""
    out = []
    for pkg, smod, QM in (("t", sim, ZipfQueryModel),
                          ("j", sim_j, ZipfQueryModel_j)):
        coord, corpus = _fleet(pkg, n_replicas, cluster_kw, **cfg_kw)
        wl = smod.MultiTenantWorkload(
            tenants=[smod.TenantSpec(f"t{i}", qps=40.0, min_results=8,
                                     max_results=16) for i in range(2)],
            n_queries=90, seed=0,
            query_model=QM.for_corpus(corpus, seed=9))
        slow = "r1" if n_replicas > 1 else "r0"
        events = [smod.ChurnEvent(t=0.2, action="slow", replica_id=slow,
                                  mult=12.0),
                  smod.ChurnEvent(t=1.0, action="recover",
                                  replica_id=slow)]
        rep = smod.run_churn_workload(coord, coord.searcher, wl, events)
        out.append((coord, rep))
    (c_t, r_t), (c_j, r_j) = out
    assert isinstance(c_t.searcher, FT.FanoutSearcher)
    assert response_fingerprint(r_t.responses) == \
        fingerprint_j(r_j.responses)
    assert r_t.scheduler_stats == r_j.scheduler_stats
    assert r_t.churn_log == r_j.churn_log
    assert c_t.scheduler_stats() == c_j.scheduler_stats()
    rids = [r.request_id for r in r_t.responses]
    assert len(rids) == 90 == len(set(rids))
    for r in r_t.responses:
        assert (r.tier != TIER_INVALID).all() if r.admitted else r.reason
    fan = r_t.scheduler_stats["fanout"]
    assert fan["n_gathers"] >= 90
    assert fan["n_cache_fills"] + fan["n_prior_answered"] \
        == fan["n_late_shards"]
    if n_replicas == 3:
        assert fan["n_late_shards"] > 0
        c = r_t.scheduler_stats["cluster"]
        assert c["n_stripe_replications"] == 1 == c["n_mirror_drops"]
        assert fan["n_shard_hedge_wins"] > 0
        assert fan["n_mirrors_live"] == 0
        assert all(not r.mirrors for r in c_t.replicas)


def test_mirrors_ride_the_ring_sibling_and_survive_restart():
    """Mid-slowdown the mirror lives on the slow replica's ring sibling
    in both packages, is held by that replica's ``mirrors`` and survives
    a rolling restart, as the reference keeps it."""
    coords = []
    for pkg, smod, QM in (("t", sim, ZipfQueryModel),
                          ("j", sim_j, ZipfQueryModel_j)):
        coord, corpus = _fleet(pkg, 3, fanout_quorum_k=2,
                               fanout_hedge_after_s=0.006,
                               fanout_max_mirrors=1)
        coord.set_shard_slowdown("r1", 12.0)
        qm = QM.for_corpus(corpus, seed=9)
        for i in range(40):
            coord.enqueue_query(qm.sample(), 8, tenant=f"t{i % 3}",
                                t_arrival=0.01 * i)
            if i % 4 == 3:
                coord.drain(max_rounds=1)
        coord.drain()
        coord.rolling_restart()
        coords.append(coord)
    c_t, c_j = coords
    hosts = {r.replica_id: sorted(r.mirrors) for r in c_t.replicas}
    assert hosts == {r.replica_id: sorted(r.mirrors) for r in c_j.replicas}
    assert sum(len(m) for m in hosts.values()) == 1
    host = next(rid for rid, m in hosts.items() if m)
    assert host != "r1" and hosts[host] == ["r1"]
    assert response_fingerprint(c_t.completed) == \
        fingerprint_j(c_j.completed)
    assert c_t.scheduler_stats() == c_j.scheduler_stats()


def test_adaptive_quorum_walks_as_the_reference():
    """With ``fanout_adaptive_quorum`` the drain rounds walk ``quorum_k``
    from its floor toward the fan-out under Normal load, step for step
    as in the reference; the static config stays put."""
    walks = {}
    for adaptive in (False, True):
        for pkg, QM in (("t", ZipfQueryModel), ("j", ZipfQueryModel_j)):
            coord, corpus = _fleet(pkg, 3, fanout_quorum_k=2,
                                   fanout_adaptive_quorum=adaptive)
            qm = QM.for_corpus(corpus, seed=4)
            walk = []
            for i in range(8):
                coord.enqueue_query(qm.sample(), 8)
                coord.drain()
                walk.append(coord.searcher.quorum.quorum_k)
            walks[adaptive, pkg] = (walk, coord.searcher.quorum.n_adapts,
                                    response_fingerprint(coord.completed)
                                    if pkg == "t" else
                                    fingerprint_j(coord.completed))
    for adaptive in (False, True):
        assert walks[adaptive, "t"] == walks[adaptive, "j"]
    assert walks[False, "t"][0] == [2] * 8
    assert walks[True, "t"][0][-1] == 3 and walks[True, "t"][1] >= 1


def test_fleet_without_fanout_keeps_the_plain_searcher():
    corpus = SyntheticCorpus(n_docs=96, vocab_size=128, seed=3)
    ret = CorpusRetrieval(corpus, n_partitions=4, block_docs=24,
                          device="cpu")
    cfg = reduced(smoke_config(), n_replicas=2)
    coord = CT.ClusterCoordinator(
        cfg, lambda ch: ch["trust"],
        sim_rate_items_per_s=cfg.u_capacity / cfg.deadline_s,
        retrieval=ret, device="cpu")
    assert not isinstance(coord.searcher, FT.FanoutSearcher)
    coord.set_shard_slowdown("r0", 4.0)          # guarded no-op
    assert "fanout" not in coord.scheduler_stats()
