"""The traffic generator: deterministic per seed, the same work from seed
to seed in another order, and inputs every operation can answer."""
from collections import Counter

import numpy as np
import pytest

from conftest import manifest, smoke_files
from portbench import harness, traffic_gen


def _spec(name):
    return harness.cell_files(manifest(), name)["traffic"]


@pytest.mark.parametrize("workload", ["smollm-urls-overload",
                                      "qwen3moe-urls-overload"])
def test_urls_same_seed_same_requests(workload):
    spec = _spec(workload)
    a = traffic_gen.make_requests(spec, 2 ** 31 + 5, 3.0, 0)
    b = traffic_gen.make_requests(spec, 2 ** 31 + 5, 3.0, 0)
    assert [r.due for r in a] == [r.due for r in b]
    assert all(np.array_equal(x.keys, y.keys) for x, y in zip(a, b))


@pytest.mark.parametrize("workload", ["smollm-urls-overload",
                                      "qwen3moe-urls-overload"])
def test_urls_seeds_share_the_schedule_not_the_keys(workload):
    spec = _spec(workload)
    a = traffic_gen.make_requests(spec, 7, 4.0, 0)
    b = traffic_gen.make_requests(spec, 8, 4.0, 0)
    assert len(a) == len(b) == round(spec["rate_per_s"] * 4.0)
    assert [r.due for r in a] == [r.due for r in b]
    assert [len(r.keys) for r in a] == [len(r.keys) for r in b]
    assert [r.priority for r in a] == [r.priority for r in b]
    assert not all(np.array_equal(x.keys, y.keys) for x, y in zip(a, b))
    mix = spec["priority_mix"]
    got = Counter(r.priority for r in a)
    for p, w in mix.items():
        assert abs(got[p] - w / sum(mix.values()) * len(a)) <= 1


def test_urls_keys_distinct_in_range_and_sizes_clipped():
    spec = _spec("smollm-urls-overload")
    reqs = traffic_gen.make_requests(spec, 3, 5.0, 0)
    s = spec["set_size"]
    for r in reqs:
        assert len(np.unique(r.keys)) == len(r.keys)
        assert r.keys.min() >= 1 and r.keys.max() <= spec["keys"]["n_keys"]
        assert s["min"] <= len(r.keys) <= s["max"]
        assert len(r.keys) % s["unit"] == 0
    assert all(0 <= r.due < 5.0 for r in reqs)
    assert [r.due for r in reqs] == sorted(r.due for r in reqs)


def test_warmup_stream_differs_from_window():
    spec = _spec("smollm-urls-overload")
    w = traffic_gen.make_requests(spec, 3, 5.0, 1)
    assert len(w) == spec["warmup_requests"]
    assert w[-1].due < len(w) / spec["rate_per_s"]
    assert w[0].due != traffic_gen.make_requests(spec, 3, 5.0, 0)[0].due


def test_tokens_depend_on_seed_and_key_only():
    keys = np.asarray([1, 2, 3, 2], np.uint32)
    t = traffic_gen.item_tokens(5, keys, 1000, 32)
    assert t.shape == (4, 32) and t.dtype == np.int32
    assert (t >= 0).all() and (t < 1000).all()
    assert np.array_equal(t[1], t[3]) and not np.array_equal(t[0], t[1])
    assert np.array_equal(t, traffic_gen.item_tokens(5, keys, 1000, 32))
    assert not np.array_equal(t, traffic_gen.item_tokens(6, keys, 1000, 32))


def test_corpus_and_queries_deterministic_and_answerable():
    spec = smoke_files("smollm-search-steady")["traffic"]
    a = traffic_gen.make_corpus(spec, 11)
    b = traffic_gen.make_corpus(spec, 11)
    assert a.doc_text == b.doc_text
    assert np.array_equal(a.exact_trust, b.exact_trust)
    assert a.doc_text != traffic_gen.make_corpus(spec, 12).doc_text
    # the text holds each document's ranks, with stopwords and variants
    words = a.doc_text[0].split()
    content = [w for w in words if w.startswith("term")]
    assert len(content) == a.offsets[1] - a.offsets[0]
    qa = traffic_gen.make_requests(spec, 11, 2.0, 0, a)
    qb = traffic_gen.make_requests(spec, 11, 2.0, 0, b)
    assert [r.query for r in qa] == [r.query for r in qb]
    for r in qa:
        ranks = [a.vocab.index(w) for w in r.query.split()]
        assert 1 <= len(ranks) <= spec["query"]["max_terms"]
        assert (a.df[ranks] > 0).all()
