"""The port's GCN trust propagator (``models.gnn``) and its evaluator on
the CPU against the JAX reference on the reference's own parameters, in
float32 at atol 1e-4: ``propagate`` for each norm and aggregator, with
and without an edge mask, ``forward``, ``trust_scores``, and the
``gcn-cora`` evaluator on a whole chunk and on a chunk gathered out of a
larger batch, as the fused drain gathers one.

The gathered chunk pins a reference caveat (ROADMAP.md, Queue 3): the
star subgraphs carry absolute node ids, so a gathered chunk's edges
point past its own nodes. The reference clamps its gathers and drops
out-of-range ``segment_sum`` ids; the port does the same, so port and
reference agree on the gathered chunk, and its scores differ from the
same items' scores inside the whole chunk."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as get_config_j
from repro.models import gnn as G_j
from repro.serving.evaluators import make_evaluator as make_evaluator_j
from repro_torch.configs import get_config
from repro_torch.models import gnn as G
from repro_torch.models import layers as L
from repro_torch.serving.evaluators import make_evaluator

ATOL = 1e-4


def _graph(n=40, n_edges=120, f=6, seed=0, out_of_range=0):
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, f)).astype(np.float32)
    ei = r.integers(0, n, size=(2, n_edges)).astype(np.int32)
    if out_of_range:                        # ids past the graph's nodes
        ei[:, :out_of_range] = r.integers(n, 2 * n, size=(2, out_of_range))
    mask = (r.random(n_edges) < 0.8).astype(np.float32)
    return x, ei, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("aggregator", ["mean", "sum", "max"])
@pytest.mark.parametrize("norm", ["sym", "rw", "none"])
def test_propagate_matches_jax(norm, aggregator, masked):
    x, ei, mask = _graph(seed=len(norm) + len(aggregator), out_of_range=9)
    kw = dict(norm=norm, aggregator=aggregator)
    want = G_j.propagate(jnp.asarray(x), jnp.asarray(ei),
                         edge_mask=jnp.asarray(mask) if masked else None,
                         **kw)
    got = G.propagate(torch.from_numpy(x), torch.from_numpy(ei),
                      edge_mask=torch.from_numpy(mask) if masked else None,
                      **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_segment_sum_drops_out_of_range_ids_and_keeps_order():
    data = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    seg = torch.tensor([2, 0, 7, 2, -1, 0])
    want = jax.ops.segment_sum(jnp.asarray(data.numpy()),
                               jnp.asarray(seg.numpy()), 4)
    got = L.segment_sum(data, seg, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    mx = L.segment_max(data, seg, 4)
    assert torch.isinf(mx[1]).all() and torch.equal(mx[2], data[3])


def _params(cfg_j, seed=0):
    return jax.tree.map(np.asarray, G_j.init_params(
        jax.random.PRNGKey(seed), cfg_j))


@pytest.mark.parametrize("aggregator,norm", [("mean", "sym"), ("sum", "rw"),
                                             ("max", "none")])
def test_forward_and_trust_scores_match_jax(aggregator, norm):
    import dataclasses
    cfg_j = dataclasses.replace(get_config_j("gcn-cora", smoke=True),
                                aggregator=aggregator, norm=norm, n_layers=3)
    cfg = dataclasses.replace(get_config("gcn-cora", smoke=True),
                              aggregator=aggregator, norm=norm, n_layers=3)
    params = _params(cfg_j)
    pt = G.params_from_jax(params)
    assert len(pt["layers"]) == 3
    x, ei, _ = _graph(n=50, f=cfg.d_feat, seed=3)
    want = G_j.forward(jax.tree.map(jnp.asarray, params), cfg_j,
                       jnp.asarray(x), jnp.asarray(ei))
    got = G.forward(pt, cfg, torch.from_numpy(x), torch.from_numpy(ei))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    want = G_j.trust_scores(jax.tree.map(jnp.asarray, params), cfg_j,
                            jnp.asarray(x), jnp.asarray(ei), trust_scale=5.0)
    got = G.trust_scores(pt, cfg, torch.from_numpy(x), torch.from_numpy(ei))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.fixture(scope="module")
def gcn_pair():
    ev_j, mk = make_evaluator_j("gcn-cora", smoke=True, seed=0)
    params = _params(get_config_j("gcn-cora", smoke=True))
    ev, mk_t = make_evaluator("gcn-cora", smoke=True, params=params,
                              device="cpu")
    return ev, ev_j, mk, mk_t


def _score(ev, ev_j, feats):
    got = ev({k: torch.from_numpy(np.ascontiguousarray(v))
              for k, v in feats.items()})
    want = np.asarray(ev_j({k: jnp.asarray(v) for k, v in feats.items()}))
    return got.numpy(), want


def test_evaluator_matches_jax_on_whole_and_gathered_chunks(gcn_pair):
    ev, ev_j, mk, mk_t = gcn_pair
    feats = mk(16, 0)
    for k, v in mk_t(16, 0).items():
        np.testing.assert_array_equal(v, feats[k])
    whole, whole_j = _score(ev, ev_j, feats)
    assert whole.shape == (16,) and ((whole >= 0) & (whole <= 5)).all()
    np.testing.assert_allclose(whole, whole_j, atol=ATOL)
    # items 8..15 alone, as the fused drain's gather hands them over
    sub = {k: v[8:] for k, v in feats.items()}
    gathered, gathered_j = _score(ev, ev_j, sub)
    np.testing.assert_allclose(gathered, gathered_j, atol=ATOL)
    # the caveat: absolute ids point past the gathered chunk's nodes
    assert sub["edge_src"].max() >= 8 * 9
    assert np.abs(gathered - whole[8:]).max() > 0.1
    # a gather in another order (the eval rank's) scores alike
    idx = np.array([5, 0, 3, 3, 12])
    perm, perm_j = _score(ev, ev_j, {k: v[idx] for k, v in feats.items()})
    np.testing.assert_allclose(perm, perm_j, atol=ATOL)


def test_gcn_config_matches_the_reference_field_for_field():
    import dataclasses
    for smoke in (False, True):
        cfg, cfg_j = get_config("gcn-cora", smoke), get_config_j("gcn-cora",
                                                                  smoke)
        for f in dataclasses.fields(cfg):
            assert getattr(cfg, f.name) == getattr(cfg_j, f.name), f.name
    cfg = get_config("gcn-cora")
    shapes = [tuple(lp["w"].shape) for lp in G.init_params(
        cfg, torch.Generator().manual_seed(0))["layers"]]
    assert shapes == [(1433, 16), (16, 7)]


def test_segment_max_gradient_splits_ties_as_jax():
    """The gradient of ``segment_max`` splits a segment's output gradient
    evenly over the rows tied at its max, negative gradients included
    (``torch.segment_reduce``'s own backward divides only positive ones);
    ids out of range and empty segments get none."""
    data = np.array([[1.0, 0.0], [3.0, 0.0], [3.0, 0.0], [2.0, 5.0],
                     [7.0, 7.0]], np.float32)
    seg = np.array([0, 0, 0, 1, 9], np.int32)
    up = np.array([[-1.0, 2.0], [3.0, -4.0], [5.0, 6.0]], np.float32)
    want = jax.grad(lambda d: (jax.ops.segment_max(d, jnp.asarray(seg), 3)
                               * jnp.asarray(up)).sum())(jnp.asarray(data))
    t = torch.from_numpy(data).requires_grad_(True)
    out = L.segment_max(t, torch.from_numpy(seg), 3)
    (torch.where(torch.isfinite(out), out, 0.0)
     * torch.from_numpy(up)).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))
