"""The port's retrieval front end on the CPU against the JAX reference's:
the same seed gives the same corpus and index checksum; ``IndexShard``
of both packages retrieves the same document ids as the Python oracle
(the port's float64 scores equal the oracle's; the reference's float32
ones within rtol 2e-5, atol 2e-6, its tests' tolerance); the gather and
scatter forms give the same bits; a 4-way doc-partitioned
``CorpusSearcher`` ranks like the whole-corpus oracle; the fallback is
never empty; and where float32 rounds a float64 near-tie into a tie,
the port keeps the oracle's order."""
import numpy as np
import pytest
import torch

from repro.retrieval import (CorpusRetrieval as CorpusRetrieval_j,
                             IndexShard as IndexShard_j,
                             SyntheticCorpus as SyntheticCorpus_j,
                             ZipfQueryModel as ZipfQueryModel_j,
                             build_index as build_index_j,
                             index_checksum as index_checksum_j)
from repro_torch.retrieval import (CorpusRetrieval, IndexShard,
                                   SyntheticCorpus, ZipfQueryModel,
                                   build_index, index_checksum, normalize,
                                   topk_py)

CPU = "cpu"


@pytest.fixture(scope="module")
def corpus():
    return SyntheticCorpus(n_docs=192, vocab_size=256, doc_len=24, seed=3)


@pytest.fixture(scope="module")
def retrieval(corpus):
    return CorpusRetrieval(corpus, n_partitions=8, block_docs=48,
                           device=CPU)


def _queries(corpus, n, seed=11):
    qm = ZipfQueryModel.for_corpus(corpus, seed=seed)
    return [qm.sample() for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 3, 9])
def test_same_seed_same_corpus_and_checksum_as_reference(seed):
    kw = dict(n_docs=64, vocab_size=128, doc_len=24, seed=seed)
    a, b = SyntheticCorpus(**kw), SyntheticCorpus_j(**kw)
    assert a.doc_text == b.doc_text
    for name in ("features", "domains", "exact_trust", "quality"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    ids = list(range(64))
    assert index_checksum(build_index([a.text(d) for d in ids], ids)) == \
        index_checksum_j(build_index_j([b.text(d) for d in ids], ids))
    assert ZipfQueryModel.for_corpus(a, seed=seed).sample() == \
        ZipfQueryModel_j.for_corpus(b, seed=seed).sample()


def test_shard_retrieve_matches_reference_and_py_oracle(corpus):
    ids = list(range(corpus.n_docs))
    texts = [corpus.text(d) for d in ids]
    shard = IndexShard.build(texts, ids, device=CPU)
    shard_j = IndexShard_j.build(texts, ids)
    for q in _queries(corpus, 15):
        want = topk_py(shard.score_py(q), 10)
        docs, scores = shard.retrieve(q, 10)
        docs_j, scores_j = shard_j.retrieve(q, 10)
        assert docs.tolist() == docs_j.tolist() == [d for d, _ in want]
        assert scores.tolist() == [s for _, s in want]      # bit for bit
        np.testing.assert_allclose(scores, scores_j, rtol=2e-5, atol=2e-6)
    # the port keeps the float64 weights the reference rounds to float32
    shard._ensure_dense()
    shard_j._ensure_dense()
    assert shard._post_w.dtype == torch.float64
    np.testing.assert_array_equal(shard._post_w.numpy().astype(np.float32),
                                  np.asarray(shard_j._post_w))
    np.testing.assert_array_equal(shard._post_slot.numpy(),
                                  np.asarray(shard_j._post_slot))


def test_gather_and_scatter_forms_give_the_same_bits(corpus):
    ids = list(range(corpus.n_docs))
    shard = IndexShard.build([corpus.text(d) for d in ids], ids,
                             device=CPU)
    qs = _queries(corpus, 8) + ["term00000 term00000 term00001"]
    shard._ensure_dense()
    assert shard._w_dense is not None
    via_gather = [shard.score(q).numpy() for q in qs]
    via_gather_b = shard.score_batch(qs).numpy()
    shard._w_dense = None          # force the postings scatter
    for q, want in zip(qs, via_gather):
        np.testing.assert_array_equal(shard.score(q).numpy(), want)
    np.testing.assert_array_equal(shard.score_batch(qs).numpy(),
                                  via_gather_b)
    np.testing.assert_array_equal(via_gather_b, np.stack(via_gather))


def test_retrieve_empty_and_unknown_query(corpus):
    ids = list(range(16))
    shard = IndexShard.build([corpus.text(d) for d in ids], ids, device=CPU)
    docs, scores = shard.retrieve("zzzqqq unknownterm", 5)
    assert len(docs) == 0 and len(scores) == 0
    assert len(shard.retrieve("", 5)[0]) == 0
    empty = IndexShard.build([], [], device=CPU)
    assert len(empty.retrieve("term00001", 5)[0]) == 0


def test_partitioned_searcher_matches_whole_corpus_oracle(retrieval,
                                                          corpus):
    groups = [[0, 1], [2, 3], [4, 5], [6, 7]]
    searcher = retrieval.searcher(
        [retrieval.build_shard(g) for g in groups])
    ref = CorpusRetrieval_j(SyntheticCorpus_j(
        n_docs=192, vocab_size=256, doc_len=24, seed=3), n_partitions=8,
        block_docs=48)
    for q in _queries(corpus, 12, seed=5):
        want = retrieval.oracle_topk(q, 8)
        assert want == ref.oracle_topk(q, 8)
        docs, scores = searcher.retrieve(q, 8)
        assert docs.tolist() == [d for d, _ in want]
        np.testing.assert_allclose(scores, [s for _, s in want],
                                   rtol=2e-5, atol=2e-6)


def test_export_absorb_round_trip(retrieval, corpus):
    a = retrieval.build_shard(range(4))
    b = retrieval.build_shard(range(4, 8))
    b.absorb(a.export_docs(retrieval.partition_doc_ids(2)))
    assert a.n_docs + b.n_docs == corpus.n_docs
    with pytest.raises(ValueError):            # double-absorb guards
        b.absorb(retrieval.build_partition(2))
    searcher = retrieval.searcher([a, b])
    for q in _queries(corpus, 8, seed=7):
        want = retrieval.oracle_topk(q, 6)
        assert searcher.retrieve(q, 6)[0].tolist() == [d for d, _ in want]


def test_searcher_fallback_never_empty(retrieval):
    searcher = retrieval.searcher([retrieval.build_shard(range(8))])
    res = searcher.search("qqqzz nothingmatchesthis", 10)
    assert len(res.url_ids) == 10 and res.url_ids.dtype == np.uint32
    assert searcher.n_fallback == 1
    res2 = searcher.search("qqqzz nothingmatchesthis", 10)
    np.testing.assert_array_equal(res.url_ids, res2.url_ids)
    hit = searcher.search("term00001", 10)
    assert searcher.n_fallback == 2 and (hit.url_ids > 0).all()
    assert normalize("the running dogs") == ["runn", "dog"]


def test_float64_scores_keep_the_oracle_order_where_float32_ties():
    """Two documents whose BM25 scores differ by one float64 ulp (tf 1 in
    5 terms vs tf 2 in 13) round to one float32. The Python oracle ranks
    document 1 first; the port, summing in the oracle's float64, does
    too; the reference, ranking float32, breaks the tie by index and
    puts document 0 first (the fault filed in ROADMAP.md, Queue 3)."""
    texts = ["alpha " + " ".join(f"fill{c}x" for c in "abcd"),
             "alpha alpha " + " ".join(f"pad{c}x" for c in "abcdefghijk")]
    shard = IndexShard.build(texts, [0, 1], device=CPU)
    want = topk_py(shard.score_py("alpha"), 2)
    assert want[0][1] > want[1][1]
    assert np.float32(want[0][1]) == np.float32(want[1][1])
    docs, scores = shard.retrieve("alpha", 2)
    assert docs.tolist() == [d for d, _ in want] == [1, 0]
    assert scores.tolist() == [s for _, s in want]          # bit for bit
    docs_j, _ = IndexShard_j.build(texts, [0, 1]).retrieve("alpha", 2)
    assert docs_j.tolist() == [0, 1]
