"""The serving path's spans and records (``repro_torch.tracing``,
``scheduling.batcher.BatchRecord``) on the CPU: a span is a no-op with no
profiler running and a named, nested record under one; with no profiler
a fused engine keeps no record but still numbers its batches; under one,
a fused wall-clock engine at depth 2 links every admitted response to
its batch's record, whose stamps run in order and whose counts agree
with the responses and the scheduler's stats; the records stay bounded;
a record that cannot be filled changes no answer; a search's spans nest
under the engine's; scoring computes no MoE aux loss."""
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.configs import TrustIRConfig, get_config
from repro_torch.core import fused_shedder as FS
from repro_torch.core.shedder import TIER_EVAL
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.retrieval import CorpusRetrieval, SyntheticCorpus
from repro_torch.scheduling import Priority, SchedulerConfig
from repro_torch.scheduling import scheduler as S
from repro_torch.serving.engine import ServingEngine

CFG = dict(u_capacity=128, u_threshold=128, deadline_s=0.5,
           overload_deadline_s=1.0, chunk_size=16, cache_slots=1024,
           cache_ways=2, drain_mode="fused", pipeline_depth=2)
W16 = np.linspace(-1.0, 1.0, 16).astype(np.float32)
STAMPS = ("formed", "staged", "dispatched", "ready", "answered")


def _stub(chunk):
    return torch.sigmoid(chunk["x"] @ torch.from_numpy(W16)) * 5.0


def _names(prof):
    return {e.name: e for e in prof.events()}


def test_span_is_a_shared_no_op_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record entered for {name}")

    monkeypatch.setattr(tracing, "_RECORD", refuse)
    a, b = tracing.span("engine.enqueue"), tracing.span("moe.router")
    assert a is b
    with a:
        pass


def test_spans_appear_by_name_and_nest_under_a_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("scheduler.drain"):
            with tracing.span("executor.submit"):
                torch.ones(4).add_(1)
            with tracing.span("executor.finalize"):
                pass
    ev = _names(prof)
    assert ev["executor.submit"].cpu_parent.name == "scheduler.drain"
    assert ev["executor.finalize"].cpu_parent.name == "scheduler.drain"
    assert ev["scheduler.drain"].cpu_parent is None
    op = next(e for e in prof.events() if e.name == "aten::add_")
    assert op.cpu_parent.name == "executor.submit"
    # spans of the program are CPU records only: nothing on a device
    assert all(e.device_type == torch.autograd.DeviceType.CPU
               for e in prof.events())


def _engine(max_batch=64, queue=1024):
    return ServingEngine(TrustIRConfig(**CFG), _stub, device="cpu",
                         sched_cfg=SchedulerConfig(
                             max_batch_items=max_batch,
                             queue_capacity_requests=queue))


def _serve(eng, n_requests=40, seed=0, traced=True):
    """Open-loop-ish serving on the wall clock: requests of 8-48 items
    at mixed priorities, one batch drained without flush after every
    third, then everything flushed; under a profiler unless not
    ``traced``."""
    if traced:
        with profile(activities=[ProfilerActivity.CPU]):
            return _serve(eng, n_requests, seed, traced=False)
    r = np.random.default_rng(seed)
    for i in range(n_requests):
        n = int(r.integers(8, 49))
        keys = r.integers(1, 400, size=n).astype(np.uint32)
        eng.enqueue(keys, (keys % 7).astype(np.int32),
                    {"x": r.normal(size=(n, 16)).astype(np.float32)},
                    priority=Priority(i % 4), tenant=f"t{i % 3}")
        if i % 3 == 2:
            eng.drain(1, flush=False)
            eng.poll()
    eng.drain()
    eng.flush()
    return eng.completed


def test_every_admitted_response_links_to_its_batch_record():
    eng = _engine()
    done = _serve(eng)
    recs = {b.batch_id: b for b in eng.scheduler.batch_records}
    admitted = [r for r in done if r.admitted]
    assert admitted and len(admitted) == len(done) - sum(
        not r.admitted for r in done)
    for r in done:
        if not r.admitted:
            assert r.batch_id is None
            continue
        rec = recs[r.batch_id]
        assert r.request_id in rec.request_ids
    # every record's requests are answered from it, once
    by_batch = Counter(r.batch_id for r in admitted)
    for bid, rec in recs.items():
        assert by_batch[bid] == len(rec.request_ids)


def test_stamps_run_in_order_for_every_request():
    eng = _engine()
    _serve(eng, seed=1)
    recs = list(eng.scheduler.batch_records)
    assert recs
    for rec in recs:
        stamps = [getattr(rec, k) for k in STAMPS]
        assert all(s is not None for s in stamps)
        for enq in rec.enqueued:
            assert enq <= rec.staged
        assert stamps == sorted(stamps)
        assert rec.device_ms is None                 # no CUDA here
        assert rec.max_evals >= max(rec.n_evaluated, 1)


def test_counts_agree_with_responses_and_scheduler_stats():
    eng = _engine()
    done = _serve(eng, seed=2)
    recs = list(eng.scheduler.batch_records)
    evals = sum(int((r.tier == TIER_EVAL).sum()) for r in done
                if r.admitted)
    assert sum(b.n_evaluated for b in recs) == evals
    assert len(recs) == eng.scheduler.stats.n_batches
    assert sum(len(b.request_ids) for b in recs) == \
        sum(r.admitted for r in done)


def test_no_records_without_a_profiler_but_every_batch_numbered():
    eng = _engine(queue=3)
    done = _serve(eng, n_requests=60, seed=3, traced=False)
    sch = eng.scheduler
    assert not sch.batch_records and not sch._landed
    assert any(not r.admitted for r in done)
    ids = {r.batch_id for r in done if r.admitted}
    assert None not in ids
    assert ids == set(range(sch.stats.n_batches))
    assert all(r.batch_id is None for r in done if not r.admitted)


def test_a_record_that_cannot_be_filled_changes_no_answer(monkeypatch):
    def broken(self):
        raise RuntimeError("event not recorded")

    monkeypatch.setattr(FS.PendingShed, "device_ms", broken)
    eng = _engine()
    done = _serve(eng, seed=5)
    assert eng.scheduler.stats.n_executor_errors == 0
    assert all(not r.reason.startswith("executor_error") for r in done)
    recs = list(eng.scheduler.batch_records)
    assert recs and all(b.device_ms is None and b.ready is not None
                        for b in recs)


def test_batch_records_stay_bounded(monkeypatch):
    monkeypatch.setattr(S, "BATCH_RECORDS", 4)
    eng = _engine(max_batch=16)
    _serve(eng, n_requests=30, seed=4)
    recs = eng.scheduler.batch_records
    assert eng.scheduler.stats.n_batches > 4
    assert len(recs) == 4
    ids = [b.batch_id for b in recs]
    assert ids == list(range(eng.scheduler.stats.n_batches - 4,
                             eng.scheduler.stats.n_batches))


@pytest.fixture(scope="module")
def searcher():
    corpus = SyntheticCorpus(n_docs=192, vocab_size=256, doc_len=24,
                             seed=3)
    ret = CorpusRetrieval(corpus, n_partitions=4, block_docs=48,
                          device="cpu")
    return ret.searcher([ret.build_shard(range(2)),
                         ret.build_shard(range(2, 4))]), corpus


def test_search_spans_nest_under_the_engine(searcher):
    srch, corpus = searcher
    eng = ServingEngine(TrustIRConfig(**CFG), lambda c: c["x"].sum(-1),
                        device="cpu", retriever=srch)
    from repro_torch.retrieval import ZipfQueryModel
    qm = ZipfQueryModel.for_corpus(corpus, seed=2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.enqueue_query(qm.sample(), n_results=16)
    ev = _names(prof)
    assert ev["retrieval.copy_back"].cpu_parent.name == "retrieval.search"
    assert ev["retrieval.score_topk"].cpu_parent.name == "retrieval.search"
    assert ev["retrieval.features"].cpu_parent.name == "retrieval.search"
    assert ev["retrieval.search"].cpu_parent.name == "engine.enqueue_query"
    assert ev["scheduler.admit"].cpu_parent.name == "engine.enqueue"
    # one copy back a shard holding documents
    n_copies = sum(e.name == "retrieval.copy_back" for e in prof.events())
    assert n_copies == sum(1 for sh in srch.shards if sh.n_docs)


def _moe_model():
    cfg = get_config("qwen3-moe-30b-a3b", smoke=True)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (3, 12),
                         generator=torch.Generator().manual_seed(1))
    return cfg, params, toks


def test_scoring_computes_no_moe_aux_and_metrics_still_do(monkeypatch):
    cfg, params, toks = _moe_model()
    aux_loss = M._aux_loss

    def refuse(*a, **k):
        raise AssertionError("the aux loss computed in scoring")

    with torch.no_grad():
        monkeypatch.setattr(M, "_aux_loss", refuse)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            T.score_tokens(params, cfg, toks)
        monkeypatch.setattr(M, "_aux_loss", aux_loss)
        names = {e.name for e in prof.events()}
        assert {"moe.router", "moe.dispatch", "moe.experts",
                "moe.combine"} <= names
        x, m = T.hidden_states(params, cfg, toks, with_metrics=True)
        assert set(m) == {"moe_aux_loss", "moe_drop_frac"}
        assert torch.equal(x, T.hidden_states(params, cfg, toks))
        h = torch.randn(20, cfg.d_model)
        bp = T._layers(params)[-1]["moe"]
        out, metrics = M.moe_apply(bp, h, cfg.moe, with_metrics=False)
        out2, metrics2 = M.moe_apply(bp, h, cfg.moe)
        assert metrics == {} and set(metrics2) == {"moe_aux_loss",
                                                   "moe_drop_frac"}
        assert torch.equal(out, out2)
