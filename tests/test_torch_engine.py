"""The port's ``ServingEngine`` against ``repro.serving.engine`` on the
CPU under ``SimClock``: the smoke-width smollm-135m on shared weights
(``models.transformer.params_from_jax``) in ``host`` and ``fused`` drain
mode, raw query strings through ``enqueue_query`` over the retrieval
fixture, and the simulator's drivers. Tiers, admissions, rejection
reasons, regimes and counts are identical; trust allclose (atol 1e-4:
the frameworks sum the transformer in different orders; 1e-5 for the
stub evaluator)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as get_config_j
from repro.configs.base import TrustIRConfig as TrustIRConfig_j
from repro.core import SimClock as SimClock_j
from repro.core import LoadShedder as LoadShedder_j
from repro.core.pipeline import (SyntheticSearcher as SyntheticSearcher_j,
                                 TrustIRPipeline as TrustIRPipeline_j,
                                 exact_oracle_evaluator as oracle_j)
from repro.models import transformer as T_j
from repro.retrieval import CorpusRetrieval as CorpusRetrieval_j
from repro.retrieval import SyntheticCorpus as SyntheticCorpus_j
from repro.scheduling import Priority as Priority_j
from repro.scheduling import SchedulerConfig as SchedulerConfig_j
from repro.serving.engine import ServingEngine as ServingEngine_j
from repro.serving.evaluators import make_evaluator as make_evaluator_j
from repro.serving.simulator import (MultiTenantWorkload as Workload_j,
                                     TenantSpec as TenantSpec_j,
                                     WorkloadConfig as WorkloadConfig_j,
                                     run_scheduled_workload as run_sched_j,
                                     run_workload as run_workload_j)
from repro_torch.configs import TrustIRConfig
from repro_torch.core.pipeline import (SyntheticSearcher, TrustIRPipeline,
                                       exact_oracle_evaluator)
from repro_torch.core.shedder import TIER_INVALID, LoadShedder, SimClock
from repro_torch.retrieval import CorpusRetrieval, SyntheticCorpus
from repro_torch.scheduling import Priority, SchedulerConfig
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.evaluators import make_evaluator
from repro_torch.serving.simulator import (MultiTenantWorkload, TenantSpec,
                                           WorkloadConfig,
                                           run_scheduled_workload,
                                           run_workload)

CFG = dict(u_capacity=128, u_threshold=128, deadline_s=0.5,
           overload_deadline_s=1.0, chunk_size=16, cache_slots=1024,
           cache_ways=2)
SCHED = dict(max_batch_items=256, queue_capacity_requests=6)
RATE = CFG["u_capacity"] / CFG["deadline_s"]
W16 = np.linspace(-1.0, 1.0, 16).astype(np.float32)


@pytest.fixture(scope="module")
def smollm_pair():
    ev_j, mk = make_evaluator_j("smollm-135m", smoke=True, seed=0)
    params = jax.tree.map(np.asarray, T_j.init_params(
        jax.random.PRNGKey(0), get_config_j("smollm-135m", smoke=True)))
    ev_t, _ = make_evaluator("smollm-135m", smoke=True, params=params,
                             device="cpu")
    return ev_t, ev_j, mk


def _engines(ev_t, ev_j, mode, retrievers=(None, None), **cfg_kw):
    kw = dict(CFG, **cfg_kw)
    eng_j = ServingEngine_j(TrustIRConfig_j(**kw), ev_j,
                            sim_clock=SimClock_j(RATE),
                            sched_cfg=SchedulerConfig_j(**SCHED),
                            drain_mode=mode, evaluate_batch=ev_j,
                            retriever=retrievers[1])
    eng_t = ServingEngine(TrustIRConfig(**kw), ev_t,
                          sim_clock=SimClock(RATE),
                          sched_cfg=SchedulerConfig(**SCHED),
                          drain_mode=mode, retriever=retrievers[0],
                          device="cpu")
    return eng_t, eng_j


def _assert_same_responses(resp_t, resp_j, atol):
    assert [r.request_id for r in resp_t] == [r.request_id for r in resp_j]
    for a, b in zip(resp_t, resp_j):
        assert (a.admitted, a.reason, a.priority.name, a.hedged) == \
            (b.admitted, b.reason, b.priority.name, b.hedged)
        np.testing.assert_array_equal(a.tier, b.tier)
        assert int(a.shed.regime) == int(b.shed.regime)
        assert (a.shed.n_evaluated, a.shed.n_cached, a.shed.n_prior,
                a.shed.uload) == (b.shed.n_evaluated, b.shed.n_cached,
                                  b.shed.n_prior, b.shed.uload)
        assert a.latency_s == pytest.approx(b.latency_s, abs=1e-9)
        np.testing.assert_allclose(a.trust, b.trust, atol=atol)
        assert (a.tier != TIER_INVALID).all()              # no-drop


def _assert_close(a, b):
    """Equal structure, exact non-floats, floats within 1e-9."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_close(a[k], b[k])
    elif isinstance(a, float):
        assert a == pytest.approx(b, rel=1e-9, abs=1e-12)
    else:
        assert a == b


@pytest.mark.parametrize("mode", ["host", "fused"])
def test_engine_matches_reference_on_smollm(smollm_pair, mode):
    ev_t, ev_j, mk = smollm_pair
    eng_t, eng_j = _engines(ev_t, ev_j, mode)
    r = np.random.default_rng(4)
    for i in range(16):
        n = int(r.integers(16, 160))
        keys = r.integers(1, 3000, n).astype(np.uint32)
        buckets = r.integers(0, 4, n).astype(np.int32)
        feats = mk(n, fseed=i)
        prio = int(r.choice(4, p=[0.1, 0.2, 0.5, 0.2]))
        for eng, pcls in ((eng_t, Priority), (eng_j, Priority_j)):
            eng.enqueue(keys, buckets, feats, priority=pcls(prio),
                        tenant=f"t{i % 3}")
        if i % 5 == 4:
            for eng in (eng_t, eng_j):
                eng.drain(1)
    for eng in (eng_t, eng_j):
        eng.drain()
    _assert_same_responses(eng_t.completed, eng_j.completed, atol=1e-4)
    assert eng_t.scheduler_stats() == eng_j.scheduler_stats()
    st = eng_t.slo_stats()
    _assert_close(st, eng_j.slo_stats())
    assert st["n_rejected"] > 0 and st["n"] > 0
    regimes = {int(r.shed.regime) for r in eng_t.completed if r.admitted}
    assert len(regimes) >= 2


@pytest.fixture(scope="module")
def corpora():
    kw = dict(n_docs=192, vocab_size=256, doc_len=24, seed=3)
    return SyntheticCorpus(**kw), SyntheticCorpus_j(**kw)


@pytest.mark.parametrize("mode", ["host", "fused"])
def test_enqueue_query_over_corpus_matches_reference(smollm_pair, corpora,
                                                     mode):
    ev_t, ev_j, mk = smollm_pair

    def doc_features(docs):
        return mk(len(docs), fseed=int(docs[0]) if len(docs) else 0)

    ret_t = CorpusRetrieval(corpora[0], n_partitions=8, block_docs=48,
                            feature_fn=doc_features, device="cpu")
    ret_j = CorpusRetrieval_j(corpora[1], n_partitions=8, block_docs=48,
                              feature_fn=doc_features)
    searchers = (ret_t.searcher([ret_t.build_shard(range(8))]),
                 ret_j.searcher([ret_j.build_shard(range(8))]))
    eng_t, eng_j = _engines(ev_t, ev_j, mode, retrievers=searchers)
    from repro_torch.retrieval import ZipfQueryModel
    qm = ZipfQueryModel.for_corpus(corpora[0], seed=2)
    for i in range(18):
        q = qm.sample() if i % 6 else "zzz unmatched query"
        for eng, pcls in ((eng_t, Priority), (eng_j, Priority_j)):
            eng.enqueue_query(q, n_results=48, priority=pcls(i % 4),
                              tenant=f"t{i % 2}")
        if i % 4 == 3:
            for eng in (eng_t, eng_j):
                eng.drain(1)
    for eng in (eng_t, eng_j):
        eng.drain()
    _assert_same_responses(eng_t.completed, eng_j.completed, atol=1e-4)
    assert searchers[0].n_fallback == searchers[1].n_fallback == 3


def _stub_t(chunk):
    return torch.sigmoid(chunk["x"] @ torch.from_numpy(W16)) * 5.0


@jax.jit
def _stub_j(chunk):
    return jax.nn.sigmoid(chunk["x"] @ jnp.asarray(W16)) * 5.0


@pytest.mark.parametrize("mode", ["host", "fused"])
def test_run_scheduled_workload_summaries_equal(mode):
    searchers = (SyntheticSearcher(corpus_size=4000, seed=1),
                 SyntheticSearcher_j(corpus_size=4000, seed=1))
    eng_t, eng_j = _engines(_stub_t, _stub_j, mode)

    def workload(tspec, wl, prio):
        return wl(tenants=[
            tspec("interactive", qps=30.0, priority_mix={
                prio.CRITICAL: 1.0, prio.HIGH: 2.0}, max_results=300),
            tspec("batch", qps=50.0, priority_mix={
                prio.NORMAL: 2.0, prio.LOW: 1.0}, max_results=500)],
            n_queries=40, seed=5)

    rep_t = run_scheduled_workload(
        eng_t, searchers[0], workload(TenantSpec, MultiTenantWorkload,
                                      Priority))
    rep_j = run_sched_j(eng_j, searchers[1],
                        workload(TenantSpec_j, Workload_j, Priority_j))
    _assert_same_responses(rep_t.responses, rep_j.responses, atol=1e-5)
    _assert_close(rep_t.summary(), rep_j.summary())
    assert rep_t.summary()["n_rejected"] > 0


def test_run_workload_pipeline_matches_reference():
    searchers = (SyntheticSearcher(corpus_size=3000, seed=2),
                 SyntheticSearcher_j(corpus_size=3000, seed=2))
    cfg_t, cfg_j = TrustIRConfig(**CFG), TrustIRConfig_j(**CFG)
    pipe_t = TrustIRPipeline(cfg_t, searchers[0], LoadShedder(
        cfg_t, exact_oracle_evaluator(searchers[0]),
        sim_clock=SimClock(RATE), device="cpu"))
    pipe_j = TrustIRPipeline_j(cfg_j, searchers[1], LoadShedder_j(
        cfg_j, oracle_j(searchers[1]), sim_clock=SimClock_j(RATE)))
    out_t = pipe_t.run_query("book", 300)
    out_j = pipe_j.run_query("book", 300)
    np.testing.assert_array_equal(out_t.ranked_idx, out_j.ranked_idx)
    assert out_t.trust_fidelity == pytest.approx(out_j.trust_fidelity)
    # result counts are 100 (Normal) or 200 (Heavy): two shapes, so the
    # reference's decision maker compiles twice, not once per query
    wl = dict(n_queries=10, seed=3, min_results=100, max_results=200)
    rep_t = run_workload(pipe_t, WorkloadConfig(**wl))
    rep_j = run_workload_j(pipe_j, WorkloadConfig_j(**wl))
    _assert_close(rep_t.summary(), rep_j.summary())
    assert rep_t.regimes == rep_j.regimes
    assert set(rep_t.regimes) == {"NORMAL", "HEAVY"}


def test_enqueue_query_without_retriever_raises():
    eng = ServingEngine(TrustIRConfig(**CFG), _stub_t,
                        sim_clock=SimClock(RATE), device="cpu")
    with pytest.raises(RuntimeError):
        eng.enqueue_query("term00001")
    # a fused engine stages every micro-batch through feature_sharding
    from repro_torch.distribution.placement import (NamedSharding,
                                                    PartitionSpec)
    from repro_torch.launch.mesh import destroy_world, make_host_mesh
    mesh = make_host_mesh((1, 1), device="cpu")
    try:
        calls = []

        def placement(features):
            calls.append(sorted(features))
            return {k: NamedSharding(mesh, PartitionSpec("data"))
                    for k in features}
        cfg = TrustIRConfig(**dict(CFG, drain_mode="fused"))
        eng = ServingEngine(cfg, _stub_t, device="cpu",
                            sim_clock=SimClock(RATE),
                            feature_sharding=placement)
        ref = ServingEngine(cfg, _stub_t, device="cpu",
                            sim_clock=SimClock(RATE))
        x = np.random.default_rng(0).normal(size=(48, 16)).astype(np.float32)
        keys = np.arange(1, 49, dtype=np.uint32)
        got = [e.submit(keys, np.zeros(48, np.int32), {"x": x})
               for e in (eng, ref)]
        assert calls == [["x"]]
        np.testing.assert_array_equal(got[0].tier, got[1].tier)
        np.testing.assert_array_equal(got[0].trust, got[1].trust)
    finally:
        destroy_world()
    with pytest.raises(ValueError):
        ServingEngine(TrustIRConfig(**CFG), _stub_t, device="cpu",
                      drain_mode="sideways")


def test_depth_two_drain_without_flush_leaves_batches_in_flight():
    """Wall clock, fused, depth 2: ``drain(1, flush=False)`` keeps up to
    two batches in the executor's window; ``flush`` lands the rest, and
    every request is answered exactly once."""
    cfg = TrustIRConfig(**dict(CFG, drain_mode="fused", pipeline_depth=2))
    eng = ServingEngine(cfg, _stub_t, device="cpu",
                        sched_cfg=SchedulerConfig(max_batch_items=64))
    r = np.random.default_rng(0)
    rids, seen = [], []
    for i in range(6):
        n = 64
        rids.append(eng.enqueue(
            np.arange(i * 100 + 1, i * 100 + 1 + n, dtype=np.uint32),
            np.zeros(n, np.int32),
            {"x": r.normal(size=(n, 16)).astype(np.float32)}))
    in_flight = []
    for _ in range(6):
        seen += [x.request_id for x in eng.drain(1, flush=False)]
        in_flight.append(eng.scheduler.executor.in_flight)
    assert in_flight == [1, 2, 2, 2, 2, 2]
    assert len(seen) == 4
    seen += [x.request_id for x in eng.flush()]
    assert eng.scheduler.executor.in_flight == 0
    assert sorted(seen) == rids
    assert all(x.admitted for x in eng.completed)
