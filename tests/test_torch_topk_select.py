"""The port's ``topk_select`` on the CPU (its plain version) against the
JAX reference's oracle ``kernels.ref.topk_select_ref`` and its Pallas
kernel in interpret mode, on the reference tests' cases: the (n, k)
grid with quantized (heavily tied) scores, all-``NEG_INF`` and duplicate
runs, a hypothesis sweep, and signed zeros. Indices and values are
exactly equal (values compared bit for bit). float64 scores, which the
reference kernel does not take, are held against a numpy lexsort."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.kernels import ops, ref
from repro_torch.kernels.topk_select import (INT32_MAX, NEG_INF,
                                             topk_select, topk_select_ref)

GRID = [(5, 3), (128, 8), (1024, 16), (1500, 100), (3000, 1024), (17, 17),
        (2048, 1)]


def _quantized(n, k, step=4):
    r = np.random.default_rng(n * 1000 + k)
    return (np.round(r.normal(size=n) * step) / step).astype(np.float32)


def _port(scores, k):
    v, i = topk_select(torch.from_numpy(scores), k)
    return v.numpy(), i.numpy()


def _assert_same(got, want):
    gv, gi = got
    wv, wi = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gv.view(np.int32), wv.view(np.int32))


@pytest.mark.parametrize("n,k", GRID)
def test_plain_matches_reference_oracle(n, k):
    scores = _quantized(n, k)
    _assert_same(_port(scores, k), ref.topk_select_ref(jnp.asarray(scores), k))


@pytest.mark.parametrize("n,k", [nk for nk in GRID if nk[1] <= 100])
def test_plain_matches_reference_pallas_kernel(n, k):
    scores = _quantized(n, k)
    _assert_same(_port(scores, k),
                 ops.topk_select(jnp.asarray(scores), k=k, interpret=True))


def test_all_neg_inf_and_duplicates():
    neg = np.full((256,), NEG_INF, np.float32)
    got = _port(neg, 8)
    _assert_same(got, ref.topk_select_ref(jnp.asarray(neg), 8))
    np.testing.assert_array_equal(got[1], np.arange(8))
    same = np.full((300,), 2.5, np.float32)
    got = _port(same, 12)
    _assert_same(got, ops.topk_select(jnp.asarray(same), k=12,
                                      interpret=True))
    np.testing.assert_array_equal(got[1], np.arange(12))


def test_signed_zeros_tie_by_index_and_keep_their_bits():
    r = np.random.default_rng(5)
    scores = np.where(r.random(500) < 0.5, np.float32(-0.0),
                      np.float32(0.0)).astype(np.float32)
    scores[r.random(500) < 0.1] = 1.0
    scores[r.random(500) < 0.1] = -1.0
    for k in (1, 37, 500):
        got = _port(scores, k)
        _assert_same(got, ref.topk_select_ref(jnp.asarray(scores), k))
    assert np.signbit(got[0]).any()            # -0.0 came back as -0.0


def test_rejects_what_it_does_not_take():
    s = torch.zeros(8)
    for k in (0, 9):
        with pytest.raises(ValueError):
            topk_select(s, k)
    with pytest.raises(TypeError):
        topk_select(s.half(), 2)
    with pytest.raises(ValueError):
        topk_select(s.reshape(2, 4), 2)
    assert INT32_MAX == np.iinfo(np.int32).max


def test_float64_orders_what_float32_would_tie():
    """float64 scores (the type retrieval ranks in) keep the order that a
    float32 image would turn into index ties: the same total order as a
    numpy lexsort over the float64 scores."""
    r = np.random.default_rng(3)
    base = np.round(r.normal(size=700) * 4) / 4
    scores = base + r.integers(0, 3, 700) * np.finfo(np.float64).eps
    assert len(np.unique(scores.astype(np.float32))) < len(np.unique(scores))
    for k in (1, 50, 700):
        v, i = topk_select(torch.from_numpy(scores), k)
        want = np.lexsort((np.arange(700), -scores))[:k]
        np.testing.assert_array_equal(i.numpy(), want)
        np.testing.assert_array_equal(v.numpy(), scores[want])
        assert v.dtype == torch.float64


@given(st.integers(1, 600), st.integers(1, 64), st.integers(0, 10**6))
@settings(max_examples=20, deadline=None)
def test_plain_matches_oracle_hypothesis(n, k, seed):
    k = min(k, n)
    r = np.random.default_rng(seed)
    scores = (np.round(r.normal(size=n) * 8) / 8).astype(np.float32)
    _assert_same(_port(scores, k), ref.topk_select_ref(jnp.asarray(scores),
                                                       k))


def _tied_at_threshold(n, k, n_above, n_tied, seed):
    """``n_above`` scores above a threshold T, ``n_tied`` copies of T
    spread over the whole range (more than the k - n_above the top k
    takes), the rest below: the top k must take the ties of smallest
    index."""
    r = np.random.default_rng(seed)
    scores = (r.random(n) * 0.5).astype(np.float64)
    scores[r.permutation(n)[:n_tied]] = 1.5
    scores[r.permutation(n)[:n_above]] = 2.0 + r.random(n_above)
    return scores


@pytest.mark.parametrize("n,k,n_above,n_tied", [
    (2000, 64, 40, 300), (3000, 7, 10, 500), (1500, 100, 0, 1500),
    (4096, 512, 200, 2000)])
def test_ties_at_threshold_take_the_smallest_indices(n, k, n_above, n_tied):
    """The k-th score repeated past k: float32 against the reference's
    oracle and its Pallas kernel, float64 against a numpy lexsort."""
    scores = _tied_at_threshold(n, k, n_above, n_tied, n + k)
    s32 = scores.astype(np.float32)
    got = _port(s32, k)
    _assert_same(got, ref.topk_select_ref(jnp.asarray(s32), k))
    if k <= 100:
        _assert_same(got, ops.topk_select(jnp.asarray(s32), k=k,
                                          interpret=True))
    v, i = topk_select(torch.from_numpy(scores), k)
    want = np.lexsort((np.arange(n), -scores))[:k]
    np.testing.assert_array_equal(i.numpy(), want)
    np.testing.assert_array_equal(v.numpy(), scores[want])
    tied = want[scores[want] == 1.5]
    assert len(tied) == k - min(n_above, k)
    np.testing.assert_array_equal(tied, np.flatnonzero(scores == 1.5)
                                  [:len(tied)])


@pytest.mark.parametrize("n,k", [(2048, 64), (5000, 64), (700, 300)])
def test_bm25_shaped_scores_with_many_exact_zeros(n, k):
    """Retrieval's scores: non-negative, most exactly zero (documents
    with no query term), the rest on a coarse grid with repeats."""
    r = np.random.default_rng(n + k)
    u = r.random(n)
    scores = np.where(u < 0.9, 0.0, np.round(-np.log(u) * 64) / 8)
    s32 = scores.astype(np.float32)
    _assert_same(_port(s32, k), ref.topk_select_ref(jnp.asarray(s32), k))
    if k <= 100:
        _assert_same(_port(s32, k), ops.topk_select(jnp.asarray(s32), k=k,
                                                    interpret=True))
    v, i = topk_select(torch.from_numpy(scores), k)
    want = np.lexsort((np.arange(n), -scores))[:k]
    np.testing.assert_array_equal(i.numpy(), want)
    np.testing.assert_array_equal(v.numpy(), scores[want])
