"""GNN dropout (``models.gnn.forward`` / ``node_loss`` with a
``dropout_rng``) against the reference's, on the CPU.

- The keep draws: a ``torch.Generator`` keeps each activation with
  probability 1 - p (within 0.01 of it over 64k draws), the same draws
  from the same seed, none without a generator or with p = 0.
- The scale: with every activation kept, the loss equals the loss
  without dropout of weights whose next layer is scaled by 1 / (1 - p)
  (within 1e-6).
- For a given mask: JAX's ``node_loss`` with ``dropout_rng=key`` and the
  port's with its keep draw replaced by JAX's own
  ``jax.random.bernoulli(key, 1 - p, shape)`` agree within 1e-5, loss and
  gradients. ``graph_readout_loss`` takes no dropout, as the
  reference's."""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as get_config_j
from repro.models import gnn as G_j
from repro_torch.configs import get_config
from repro_torch.models import gnn as G

P = 0.4


def _case(seed=0, n=48, n_edges=150):
    cfg_j = dataclasses.replace(get_config_j("gcn-cora", smoke=True),
                                dropout=P)
    cfg = dataclasses.replace(get_config("gcn-cora", smoke=True), dropout=P)
    params_j = G_j.init_params(jax.random.PRNGKey(seed), cfg_j)
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, cfg.d_feat)).astype(np.float32)
    ei = r.integers(0, n, size=(2, n_edges)).astype(np.int32)
    labels = r.integers(0, cfg.n_classes, n).astype(np.int32)
    lmask = (r.random(n) < 0.6).astype(np.float32)
    return cfg_j, cfg, params_j, x, ei, labels, lmask


def _port(params_j):
    return G.params_from_jax(jax.tree.map(np.asarray, params_j))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_keep_draws_rate_and_reproducibility():
    keep = G._keep_mask((256, 256), 1 - P,
                        torch.Generator().manual_seed(3), "cpu")
    assert keep.dtype == torch.bool
    assert abs(keep.float().mean().item() - (1 - P)) < 0.01
    again = G._keep_mask((256, 256), 1 - P,
                         torch.Generator().manual_seed(3), "cpu")
    assert torch.equal(keep, again)


def test_no_draw_without_a_generator_or_at_p_zero(monkeypatch):
    cfg_j, cfg, params_j, x, ei, labels, lmask = _case()
    p = _port(params_j)
    x, ei = _t(x, ei)
    calls = []
    monkeypatch.setattr(G, "_keep_mask",
                        lambda *a: calls.append(a) or 1 / 0)
    plain = G.forward(p, cfg, x, ei)
    assert torch.equal(G.forward(p, cfg, x, ei, dropout_rng=None), plain)
    zero = dataclasses.replace(cfg, dropout=0.0)
    assert torch.equal(G.forward(p, zero, x, ei,
                                 dropout_rng=torch.Generator()), plain)
    assert not calls


def test_kept_activations_scale_by_one_over_keep(monkeypatch):
    cfg_j, cfg, params_j, x, ei, labels, lmask = _case(seed=1)
    p = _port(params_j)
    x, ei, labels, lmask = _t(x, ei, labels, lmask)
    monkeypatch.setattr(G, "_keep_mask", lambda shape, keep_prob, g, dev:
                        torch.ones(shape, dtype=torch.bool))
    got = G.node_loss(p, cfg, x, ei, labels, lmask,
                      dropout_rng=torch.Generator())
    scaled = {"layers": [dict(l) for l in p["layers"]]}
    scaled["layers"][1]["w"] = p["layers"][1]["w"] / (1 - P)
    want = G.node_loss(scaled, cfg, x, ei, labels, lmask)
    np.testing.assert_allclose(got.item(), want.item(), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_node_loss_matches_jax_for_its_mask(seed, monkeypatch):
    cfg_j, cfg, params_j, x, ei, labels, lmask = _case(seed=seed)
    key = jax.random.PRNGKey(100 + seed)

    def loss_j(pj):
        return G_j.node_loss(pj, cfg_j, jnp.asarray(x), jnp.asarray(ei),
                             jnp.asarray(labels), jnp.asarray(lmask),
                             dropout_rng=key)
    want, grads_j = jax.value_and_grad(loss_j)(params_j)
    masks = []

    def jax_mask(shape, keep_prob, generator, device):
        masks.append(shape)
        return torch.from_numpy(np.array(jax.random.bernoulli(
            key, keep_prob, tuple(shape))))
    monkeypatch.setattr(G, "_keep_mask", jax_mask)
    p = _port(params_j)
    leaves = [t for lp in p["layers"] for t in lp.values()]
    for t in leaves:
        t.requires_grad_(True)
    got = G.node_loss(p, cfg, *_t(x, ei, labels, lmask),
                      dropout_rng=torch.Generator())
    got.backward()
    assert len(masks) == cfg.n_layers - 1
    np.testing.assert_allclose(got.item(), float(want), rtol=0, atol=1e-5)
    for lp, lj in zip(p["layers"], grads_j["layers"]):
        for k in lp:
            np.testing.assert_allclose(lp[k].grad.numpy(),
                                       np.asarray(lj[k]), rtol=0,
                                       atol=1e-5)


def test_graph_readout_loss_takes_no_dropout():
    for fn in (G.graph_readout_loss, G_j.graph_readout_loss):
        assert "dropout_rng" not in inspect.signature(fn).parameters
    for fn in (G.forward, G.node_loss):
        assert "dropout_rng" in inspect.signature(fn).parameters
