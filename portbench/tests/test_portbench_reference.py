"""The plain references against the system at smoke width on the CPU:
the evaluator (dense and MoE, capacity drops included), BM25 retrieval,
and the float8 control, which has to fail where the system passes."""
import numpy as np
import pytest
import torch

from conftest import SMOKE_MOE, smoke_files
from portbench import traffic_gen, weights
from portbench.reference import bm25, model, shedding


def _model(moe: bool):
    files = smoke_files("qwen3moe-urls-overload" if moe
                        else "smollm-urls-overload")
    return files["config"]


@pytest.mark.parametrize("moe", [False, True])
def test_reference_trust_matches_the_system(moe):
    from repro_torch.serving.evaluators import make_evaluator
    cfg = _model(moe)
    m = cfg["model"]
    tree = weights.make_weights(m, 17, torch.float32, "cpu")
    evaluate, _ = make_evaluator(cfg["arch"], smoke=True, params=tree,
                                 device="cpu", doc_len=32, trust_scale=5.0)
    keys = np.arange(1, 97, dtype=np.uint32)
    tok = torch.as_tensor(traffic_gen.item_tokens(3, keys, m["vocab_size"],
                                                  32))
    if moe:   # a hot token makes some experts overflow their capacity
        tok[:, ::2] = 7
    got = evaluate({"tokens": tok}).numpy()
    want = model.trust_scores(tree, m, tok, 5.0).numpy()
    assert np.abs(got - want).max() < 1e-4
    low = model.trust_scores(tree, m, tok, 5.0, precision="fp8").numpy()
    # the control (float8 operands) sits far outside the system's gap
    assert np.abs(low - want).max() > 100 * max(np.abs(got - want).max(),
                                                1e-7)


def test_moe_capacity_drops_are_the_systems():
    from repro_torch.configs import get_config
    from repro_torch.models import moe as M
    m = dict(SMOKE_MOE, norm_topk_prob=True)
    tree = weights.make_weights(dict(m, tie_word_embeddings=True,
                                     rms_norm_eps=1e-6, rope_theta=1e6), 4,
                                torch.float32, "cpu")
    p = tree["blocks"][0]["moe"]
    g = torch.Generator().manual_seed(0)
    h = torch.randn(40, m["hidden_size"], generator=g)
    h[::2] = h[0]               # one hot row: its experts overflow
    cfg = get_config("qwen3-moe-30b-a3b", smoke=True).moe
    got, metrics = M.moe_apply(p, h, cfg, compute_dtype=torch.float32)
    assert float(metrics["moe_drop_frac"]) > 0
    want = model.moe(p, h, m, fp8=False)
    assert torch.allclose(got, want, atol=1e-5)


def test_bm25_reference_equals_the_systems_retrieval():
    from repro_torch.retrieval.shard import CorpusRetrieval
    spec = smoke_files("smollm-search-steady")["traffic"]
    corpus = traffic_gen.make_corpus(spec, 21)
    retrieval = CorpusRetrieval(corpus, n_partitions=4, device="cpu")
    shard = retrieval.build_shard(range(4))
    ref = bm25.BM25(corpus.ranks, corpus.offsets, corpus.vocab)
    rng = np.random.default_rng(0)
    for _ in range(40):
        q = traffic_gen.sample_query(spec, corpus, rng)
        ids, scores = shard.retrieve(q, 64)
        want_ids, want_scores = ref.topk(q, 64)
        assert np.array_equal(ids, want_ids)
        assert np.array_equal(scores, want_scores)      # the same bits


def test_trust_db_hash_is_the_systems():
    from repro_torch.core import trust_cache as TC
    keys = np.asarray([1, 2, 3, 2 ** 24, 2 ** 32 - 1], np.uint32)
    got = TC.slots_of(torch.as_tensor(keys.view(np.int32)), 65536).numpy()
    want = shedding.hash32(keys) % np.uint64(65536)
    assert np.array_equal(got, want.astype(np.int64))


def test_budget_follows_the_regime_ladder():
    cfg = {"deadline_s": 0.5, "overload_deadline_s": 1.0,
           "very_heavy_weight": 0.5}
    assert shedding.deadline_budget(100, 200, 100, cfg) == 200   # Normal
    assert shedding.deadline_budget(250, 200, 100, cfg) == 400   # Heavy
    # Very Heavy: 400 * (1 + 0.5 * (600 - 300) / 600)
    assert shedding.deadline_budget(600, 200, 100, cfg) == 500
