"""The port's fleet on the fused drain against the reference's, on the
CPU: a 3-replica ``ClusterCoordinator`` with ``drain_mode="fused"`` on
SimClocks, each replica on the smoke-width smollm-135m evaluator with
the reference's weights (``models.transformer.params_from_jax``), over a
192-doc corpus in 4 doc-partitions the ring assigns to replicas. Raw
queries go through ``enqueue_query`` (BM25 on every live shard ->
``topk_select`` -> merge) between drain rounds, with hedging and gossip
on and a graceful leave and a join midway. The reference's fused step
runs ``shed_partition`` in Pallas interpret mode, as its own tests run
it.

Candidate ids, tiers, admissions, reasons, regimes and counts are
exact; trust is within 5e-2 (the frameworks sum the bf16 transformer in
different orders)."""
import jax
import numpy as np
import pytest

import repro.cluster as CJ
import repro_torch.cluster as CT
from repro.configs import get_config as get_config_j
from repro.configs.base import TrustIRConfig as TrustIRConfig_j
from repro.models import transformer as T_j
from repro.retrieval import CorpusRetrieval as CorpusRetrieval_j
from repro.retrieval import SyntheticCorpus as SyntheticCorpus_j
from repro.scheduling import Priority as Priority_j
from repro.scheduling import SchedulerConfig as SchedulerConfig_j
from repro.serving.evaluators import make_evaluator as make_evaluator_j
from repro_torch.configs import TrustIRConfig
from repro_torch.core.shedder import TIER_INVALID
from repro_torch.retrieval import (CorpusRetrieval, SyntheticCorpus,
                                   ZipfQueryModel)
from repro_torch.scheduling import Priority, SchedulerConfig
from repro_torch.serving.evaluators import make_evaluator

CFG = dict(u_capacity=96, u_threshold=64, deadline_s=0.5,
           overload_deadline_s=1.0, chunk_size=16, cache_slots=1024,
           cache_ways=2, n_replicas=3, drain_mode="fused")
SCHED = dict(max_batch_items=160, queue_capacity_requests=8)
RATE = CFG["u_capacity"] / CFG["deadline_s"]
TRUST_ATOL = 5e-2


@pytest.fixture(scope="module")
def fleets():
    ev_j, mk = make_evaluator_j("smollm-135m", smoke=True, seed=0)
    params = jax.tree.map(np.asarray, T_j.init_params(
        jax.random.PRNGKey(0), get_config_j("smollm-135m", smoke=True)))
    ev_t, _ = make_evaluator("smollm-135m", smoke=True, params=params,
                             device="cpu")

    def doc_features(docs):
        return mk(len(docs), fseed=int(docs[0]) if len(docs) else 0)

    kw = dict(n_docs=192, vocab_size=256, doc_len=24, seed=3)
    qm = ZipfQueryModel.for_corpus(SyntheticCorpus(**kw), seed=2)
    queries = [qm.sample() for _ in range(30)]
    out = []
    for pkg in ("t", "j"):
        if pkg == "t":
            ret = CorpusRetrieval(SyntheticCorpus(**kw), n_partitions=4,
                                  block_docs=48, feature_fn=doc_features,
                                  device="cpu")
            coord = CT.ClusterCoordinator(
                TrustIRConfig(**CFG), ev_t, evaluate_batch=ev_t,
                cluster_cfg=CT.ClusterConfig(hedge_after_s=0.3,
                                             gossip=True),
                sched_cfg=SchedulerConfig(**SCHED),
                sim_rate_items_per_s=RATE, retrieval=ret, device="cpu")
            P = Priority
        else:
            ret = CorpusRetrieval_j(SyntheticCorpus_j(**kw), n_partitions=4,
                                    block_docs=48, feature_fn=doc_features)
            coord = CJ.ClusterCoordinator(
                TrustIRConfig_j(**CFG), ev_j, evaluate_batch=ev_j,
                cluster_cfg=CJ.ClusterConfig(hedge_after_s=0.3,
                                             gossip=True),
                sched_cfg=SchedulerConfig_j(**SCHED),
                sim_rate_items_per_s=RATE, retrieval=ret)
            P = Priority_j
        retrieved = []
        search = coord.searcher.search

        def logged(query, n, _search=search, _log=retrieved):
            res = _search(query, n)
            _log.append(np.asarray(res.url_ids).tolist())
            return res

        coord.searcher.search = logged
        for i, q in enumerate(queries):
            coord.enqueue_query(q, n_results=48, priority=P(i % 4),
                                tenant=f"tenant{i % 5}", slo_s=1.5,
                                t_arrival=0.02 * i)
            if i % 5 == 4:
                coord.drain(max_rounds=1)
            if i == 12:
                coord.remove_replica("r1", drain=True)
            if i == 20:
                coord.add_replica(now_t=0.02 * i)
        coord.drain()
        out.append((coord, retrieved))
    return out


def test_fused_fleet_matches_reference(fleets):
    (c_t, ids_t), (c_j, ids_j) = fleets
    assert ids_t == ids_j                      # candidate ids, exact
    a_resp = sorted(c_t.completed, key=lambda r: r.request_id)
    b_resp = sorted(c_j.completed, key=lambda r: r.request_id)
    assert [r.request_id for r in a_resp] == [r.request_id for r in b_resp]
    assert len(a_resp) == 30
    for a, b in zip(a_resp, b_resp):
        assert (a.admitted, a.reason, a.priority.name, a.hedged) == \
            (b.admitted, b.reason, b.priority.name, b.hedged)
        np.testing.assert_array_equal(a.tier, b.tier)
        assert int(a.shed.regime) == int(b.shed.regime)
        assert (a.shed.n_evaluated, a.shed.n_cached, a.shed.n_prior,
                a.shed.uload) == (b.shed.n_evaluated, b.shed.n_cached,
                                  b.shed.n_prior, b.shed.uload)
        np.testing.assert_allclose(a.trust, b.trust, atol=TRUST_ATOL)
        if a.admitted:
            assert (a.tier != TIER_INVALID).all()
    s_t, s_j = c_t.scheduler_stats(), c_j.scheduler_stats()
    for k in ("n_submitted", "n_admitted", "n_rejected", "n_batches",
              "n_batched_items", "n_hedges", "rejected_by_reason",
              "cluster"):
        assert s_t[k] == s_j[k], k
    assert s_t["cluster"]["n_leaves"] == s_t["cluster"]["n_joins"] == 1
    assert s_t["gossip"]["n_applied"] > 0
    assert {int(r.shed.regime) for r in a_resp if r.admitted} != {0}
    assert s_t["cluster"]["n_partition_moves"] > 0
    assert sorted(c_t.partition_owners().items()) == \
        sorted(c_j.partition_owners().items())
