"""The port's numpy copy of the data streams (``training.data``) against
``repro.training.data``: every generator yields the same arrays bit for
bit (values, dtypes, shapes) from the same ``(seed, step)``, restarts
included (``start_step``), for the LM stream, each recommender family's
stream, the community graph, the CSR neighbor sampler, the sampled
subgraph batches and the batched molecules."""
import numpy as np
import pytest

from repro.configs import get_config as get_config_j
from repro.training import data as D_j
from repro_torch.configs import get_config
from repro_torch.training import data as D


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _take(gen, n):
    return [next(gen) for _ in range(n)]


@pytest.mark.parametrize("start", [0, 3])
def test_lm_batches_equal(start):
    for arch in ("smollm-135m", "gemma2-2b"):
        got = _take(D.lm_batches(get_config(arch, smoke=True), 3, 17,
                                 seed=5, start_step=start), 3)
        want = _take(D_j.lm_batches(get_config_j(arch, smoke=True), 3, 17,
                                    seed=5, start_step=start), 3)
        for g, w in zip(got, want):
            _same(g, w)


@pytest.mark.parametrize("arch", ["dlrm-mlperf", "bst", "two-tower-retrieval",
                                  "mind"])
def test_recsys_batches_equal(arch):
    got = _take(D.recsys_batches(get_config(arch, smoke=True), 9, seed=2,
                                 start_step=1), 2)
    want = _take(D_j.recsys_batches(get_config_j(arch, smoke=True), 9,
                                    seed=2, start_step=1), 2)
    for g, w in zip(got, want):
        _same(g, w)


def test_restart_resumes_on_the_same_batch():
    cfg = get_config("smollm-135m", smoke=True)
    straight = _take(D.lm_batches(cfg, 2, 8, seed=1), 5)
    resumed = _take(D.lm_batches(cfg, 2, 8, seed=1, start_step=3), 2)
    for g, w in zip(resumed, straight[3:]):
        _same(g, w)


def test_synthetic_graph_and_csr_sampler_equal():
    g = D.synthetic_graph(300, 2000, 12, 5, seed=4)
    w = D_j.synthetic_graph(300, 2000, 12, 5, seed=4)
    _same(g, w)
    csr, csr_j = D.CSRGraph(g["edge_index"], 300), D_j.CSRGraph(
        w["edge_index"], 300)
    np.testing.assert_array_equal(csr.ptr, csr_j.ptr)
    np.testing.assert_array_equal(csr.col, csr_j.col)
    nodes = np.arange(0, 300, 7)
    a = csr.sample_neighbors(nodes, 4, np.random.default_rng(9))
    b = csr_j.sample_neighbors(nodes, 4, np.random.default_rng(9))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_sampled_subgraph_and_molecule_batches_equal():
    g = D.synthetic_graph(200, 800, 6, 3, seed=1)
    got = _take(D.sampled_subgraph_batches(g, 8, (3, 2), seed=2,
                                           start_step=2), 2)
    want = _take(D_j.sampled_subgraph_batches(g, 8, (3, 2), seed=2,
                                              start_step=2), 2)
    for a, b in zip(got, want):
        _same(a, b)
    got = _take(D.batched_molecule_batches(4, 6, 10, 5, 2, seed=3), 2)
    want = _take(D_j.batched_molecule_batches(4, 6, 10, 5, 2, seed=3), 2)
    for a, b in zip(got, want):
        _same(a, b)
