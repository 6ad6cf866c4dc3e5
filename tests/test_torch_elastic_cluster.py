"""Elastic membership of the port's fleet against ``repro.cluster`` on
the CPU: ``add_replica``, graceful ``remove_replica(drain=True)`` (queue
handoff, warm Trust-DB handoff, index-stripe moves), crash
``remove_replica(drain=False)`` (admission-journal replay, stripe
rebuilds), ``rolling_restart`` and ``run_churn_workload``. Responses
(``response_fingerprint``), scheduler stats and churn logs are exact and
no-drop holds. Also the snapshot caveat: ``ReplicaHandle.prewarm``
restores the cache and prior bit for bit, which is safe because the
port's ``TC.insert`` and ``AT.update`` never write the tensors they were
given."""
import numpy as np
import pytest
import torch

import repro.cluster as CJ
import repro_torch.cluster as CT
from repro.chaos import response_fingerprint as fingerprint_j
from repro.configs.base import reduced as reduced_j
from repro.configs.trust_ir import smoke_config as smoke_j
from repro.core.pipeline import SyntheticSearcher as SyntheticSearcher_j
from repro.retrieval import CorpusRetrieval as CorpusRetrieval_j
from repro.retrieval import SyntheticCorpus as SyntheticCorpus_j
from repro.retrieval import ZipfQueryModel as ZipfQueryModel_j
from repro.serving import simulator as sim_j
from repro_torch.chaos import response_fingerprint
from repro_torch.configs.base import reduced
from repro_torch.configs.trust_ir import smoke_config
from repro_torch.core import average_trust as AT
from repro_torch.core import trust_cache as TC
from repro_torch.core.pipeline import SyntheticSearcher
from repro_torch.core.shedder import TIER_INVALID
from repro_torch.retrieval import (CorpusRetrieval, SyntheticCorpus,
                                   ZipfQueryModel)
from repro_torch.serving import simulator as sim

PKGS = (("t", CT, sim, SyntheticSearcher),
        ("j", CJ, sim_j, SyntheticSearcher_j))


def _coordinator(pkg, mod, n_replicas, cluster_kw, retrieval=None,
                 **cfg_kw):
    red, smoke = (reduced, smoke_config) if pkg == "t" \
        else (reduced_j, smoke_j)
    cfg = red(smoke(), n_replicas=n_replicas, **cfg_kw)
    rate = 0.5 * cfg.u_capacity / cfg.deadline_s
    extra = {"device": "cpu"} if pkg == "t" else {}
    ev = (lambda ch: ch["trust"]) if pkg == "t" \
        else (lambda ch: np.asarray(ch["trust"]))
    return mod.ClusterCoordinator(
        cfg, ev, cluster_cfg=mod.ClusterConfig(**cluster_kw),
        sim_rate_items_per_s=rate, retrieval=retrieval, **extra)


def _workload(smod, n_queries=150):
    P = smod.Priority
    return smod.MultiTenantWorkload(tenants=[
        smod.TenantSpec(f"tenant{i}", qps=30.0, max_results=400, slo_s=1.5,
                        priority_mix={P.CRITICAL: 1, P.HIGH: 1,
                                      P.NORMAL: 2, P.LOW: 1})
        for i in range(6)], n_queries=n_queries, seed=5)


def _assert_no_drop(rep):
    rids = [r.request_id for r in rep.responses]
    assert len(rids) == len(set(rids)) == rep.scheduler_stats["n_submitted"]
    for r in rep.responses:
        if r.admitted:
            assert (r.tier != TIER_INVALID).all()
        else:
            assert r.reason


@pytest.mark.parametrize("schedule,cluster_kw", [
    ([("join", None), ("leave", None), ("crash", None)],
     dict(hedge_after_s=0.05)),
    ([("crash", "r0"), ("join", "r7"), ("leave", "r1"), ("crash", None)],
     dict(hedge_after_s=0.05, gossip=True, gossip_mode="epidemic")),
    ([("leave", None), ("leave", None), ("join", None)],
     dict(gossip=True, warm_handoff_top_k=64)),
], ids=["join-leave-crash", "crash-first-epidemic", "double-leave-warm"])
def test_churn_workload_matches_reference(schedule, cluster_kw):
    out = []
    for pkg, mod, smod, searcher in PKGS:
        coord = _coordinator(pkg, mod, 4, cluster_kw)
        events = [smod.ChurnEvent(t=0.15 + 0.25 * i, action=a, replica_id=r)
                  for i, (a, r) in enumerate(schedule)]
        rep = smod.run_churn_workload(
            coord, searcher(corpus_size=5000, seed=2), _workload(smod),
            events)
        out.append(rep)
    r_t, r_j = out
    assert response_fingerprint(r_t.responses) == \
        fingerprint_j(r_j.responses)
    assert r_t.scheduler_stats == r_j.scheduler_stats
    assert r_t.churn_log == r_j.churn_log
    assert len(r_t.churn_log) == len(schedule)
    _assert_no_drop(r_t)
    c = r_t.scheduler_stats["cluster"]
    assert c["n_leaves"] + c["n_crashes"] + c["n_joins"] == len(schedule)
    assert c["n_handoffs"] + c["n_crash_recovered"] > 0


@pytest.fixture(scope="module")
def corpora():
    kw = dict(n_docs=192, vocab_size=256, doc_len=24, seed=3)
    return SyntheticCorpus(**kw), SyntheticCorpus_j(**kw)


def test_membership_with_index_stripes_matches_reference(corpora):
    """A 3-replica fleet over a 4-partition corpus: joins, a graceful
    leave (stripes move by ``export_docs`` -> ``absorb``), a crash
    (stripes rebuilt from the corpus) and a rolling restart, between
    raw-query enqueues."""
    fleets = []
    for (pkg, mod, smod, _), corpus, Ret, QM in (
            (PKGS[0], corpora[0], CorpusRetrieval, ZipfQueryModel),
            (PKGS[1], corpora[1], CorpusRetrieval_j, ZipfQueryModel_j)):
        kw = {"device": "cpu"} if pkg == "t" else {}
        ret = Ret(corpus, n_partitions=4, block_docs=48, **kw)
        coord = _coordinator(pkg, mod, 3, dict(hedge_after_s=0.05,
                                               gossip=True), retrieval=ret)
        qm = QM.for_corpus(corpus, seed=4)
        log = []
        for i in range(60):
            coord.enqueue_query(qm.sample(), n_results=32,
                                tenant=f"tenant{i % 5}", slo_s=2.0,
                                t_arrival=0.01 * i)
            if i % 6 == 5:
                coord.drain(max_rounds=1)
            if i == 12:
                log.append(coord.add_replica(now_t=0.12).replica_id)
            if i == 25:
                log.append(coord.remove_replica("r1", drain=True))
            if i == 38:
                log.append(coord.remove_replica("r3", drain=False))
            if i == 50:
                log.append(coord.rolling_restart())
            log.append(sorted(coord.partition_owners().items()))
        coord.drain()
        log.append([s.n_docs for s in coord.searcher.shards])
        fleets.append((coord, log))
    (c_t, log_t), (c_j, log_j) = fleets
    assert log_t == log_j
    assert response_fingerprint(c_t.completed) == \
        fingerprint_j(c_j.completed)
    assert c_t.scheduler_stats() == c_j.scheduler_stats()
    st = c_t.stats
    assert st.n_partition_moves > 0 and st.n_partition_rebuilds > 0
    assert sum(s.n_docs for s in c_t.searcher.shards) == 192
    rids = [r.request_id for r in c_t.completed]
    assert len(rids) == len(set(rids)) == 60


@pytest.mark.parametrize("mode", ["host", "fused"])
def test_prewarm_restores_cache_and_prior_and_state_is_functional(mode):
    cfg = reduced(smoke_config(), n_replicas=2, drain_mode=mode)
    coord = CT.ClusterCoordinator(
        cfg, lambda ch: ch["trust"], sim_rate_items_per_s=1000.0,
        device="cpu")
    rng = np.random.default_rng(0)
    for i in range(6):                  # warm the caches with real work
        n = 40
        coord.enqueue(np.arange(i * 100 + 1, i * 100 + n + 1,
                                dtype=np.uint32),
                      rng.integers(0, 4, n).astype(np.int32),
                      {"trust": rng.random(n).astype(np.float32) * 5},
                      tenant=f"t{i}", slo_s=5.0)
    coord.drain()
    rep = coord.replicas[0]
    sh = rep.engine.shedder
    cache, prior = sh.cache, sh.prior
    saved = ({k: v.clone() for k, v in cache.items()},
             {k: v.clone() for k, v in prior.items()})
    assert int((cache["keys"] != 0).sum()) > 0
    rep.prewarm(coord._feature_schema, coord.max_batch_items)
    assert sh.cache is cache and sh.prior is prior
    for state, copy in zip((sh.cache, sh.prior), saved):
        for k in copy:
            assert torch.equal(state[k], copy[k]), k
    # Functional updates: a new state, the old tensors untouched.
    keys = torch.arange(1, 33, dtype=torch.int32) + 0x7000
    new_cache = TC.insert(cache, keys, torch.ones(32),
                          torch.ones(32, dtype=torch.bool))
    new_prior = AT.update(prior, torch.zeros(32, dtype=torch.int32),
                          torch.ones(32), torch.ones(32, dtype=torch.bool))
    for state, copy, new in ((cache, saved[0], new_cache),
                             (prior, saved[1], new_prior)):
        for k in copy:
            assert torch.equal(state[k], copy[k]), k
            assert new[k].data_ptr() != state[k].data_ptr()
    assert int((new_cache["keys"] != 0).sum()) > \
        int((cache["keys"] != 0).sum())
