"""The port's training losses on the CPU against the JAX reference, from
the reference's own initialized parameters (``params_from_jax``) and the
same seeded numpy batches: for each of the registry's ten architectures
at smoke width, the loss and every gradient leaf of the launcher's loss
function (``lm_loss``, each recommender's ``loss_fn``,
``gnn.node_loss``) against ``jax.value_and_grad`` of the reference's:
the loss within 1e-5, each leaf's gradient within 1e-5 of that leaf's
norm (float32; the frameworks sum in other orders; see
``_assert_leaves_close`` for a leaf whose gradient is analytically
zero); and ``gnn.graph_readout_loss``.

None of these batches puts a MoE token at a float32 routing near-tie
(ROADMAP Queue 3), so every token is compared."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as get_config_j
from repro.launch.steps import _recsys_loss as recsys_loss_j
from repro.models import gnn as G_j
from repro.models import transformer as T_j
from repro.training import data as D_j
from repro_torch.configs import get_config
from repro_torch.configs.base import (GNNConfig, RecsysConfig,
                                      TransformerConfig)
from repro_torch.launch.steps import _recsys_loss
from repro_torch.models import gnn as G
from repro_torch.models import transformer as T
from repro_torch.training import train_loop as TL
from repro_torch.training.tree import leaves

ARCHS = ["smollm-135m", "qwen2.5-14b", "gemma2-2b", "moonshot-v1-16b-a3b",
         "qwen3-moe-30b-a3b", "gcn-cora", "bst", "dlrm-mlperf",
         "two-tower-retrieval", "mind"]
REL = 1e-5


def _setup(arch, batch=4, seq=32, seed=0):
    """(reference loss fn, reference params, port loss fn, port params,
    numpy batch): the launcher's loss for ``arch`` on both sides."""
    cfg_j, cfg = get_config_j(arch, smoke=True), get_config(arch, smoke=True)
    key = jax.random.PRNGKey(seed)
    if isinstance(cfg, TransformerConfig):
        params = jax.tree.map(np.asarray, T_j.init_params(key, cfg_j))
        pt = T.params_from_jax(params, cfg, device="cpu")
        batch_np = next(D_j.lm_batches(cfg_j, batch, seq, seed=1))

        def loss_j(p, b):
            return T_j.lm_loss(p, cfg_j, b["tokens"], b["labels"])

        def loss_t(p, b):
            return T.lm_loss(p, cfg, b["tokens"], b["labels"])
    elif isinstance(cfg, RecsysConfig):
        M_j, M = recsys_loss_j(cfg_j), _recsys_loss(cfg)
        params = jax.tree.map(np.asarray, M_j.init_params(key, cfg_j))
        pt = M.params_from_jax(params, device="cpu")
        batch_np = next(D_j.recsys_batches(cfg_j, 16, seed=1))

        def loss_j(p, b):
            return M_j.loss_fn(p, cfg_j, b)

        def loss_t(p, b):
            return M.loss_fn(p, cfg, b)
    else:
        assert isinstance(cfg, GNNConfig)
        params = jax.tree.map(np.asarray, G_j.init_params(key, cfg_j))
        pt = G.params_from_jax(params, device="cpu")
        batch_np = D_j.synthetic_graph(512, 4096, cfg.d_feat, cfg.n_classes,
                                       seed=1)

        def loss_j(p, b):
            return G_j.node_loss(p, cfg_j, b["x"], b["edge_index"],
                                 b["labels"], b["train_mask"])

        def loss_t(p, b):
            return G.node_loss(p, cfg, b["x"], b["edge_index"],
                               b["labels"], b["train_mask"])
    return loss_j, params, loss_t, pt, batch_np


def _scalar(out):
    return out[0] if isinstance(out, tuple) else out


def _assert_leaves_close(got_leaves, want_leaves, rel=REL, what="grad"):
    """Each leaf within ``rel`` of its own norm; a leaf whose gradient is
    analytically zero (BST's key bias: the softmax ignores a shift of a
    row's scores) holds rounding noise only, so norms below 1e-3 of the
    largest leaf's are floored there."""
    assert len(got_leaves) == len(want_leaves)
    want_leaves = [np.asarray(w) for w in want_leaves]
    floor = 1e-3 * max(float(np.linalg.norm(w.ravel())) for w in want_leaves)
    for i, (g, w) in enumerate(zip(got_leaves, want_leaves)):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        assert g.shape == w.shape, (i, g.shape, w.shape)
        err = float(np.linalg.norm((g - w).ravel()))
        scale = float(np.linalg.norm(w.ravel()))
        assert err <= rel * max(scale, floor), (what, i, err, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_leaf_match_jax(arch):
    loss_j, params, loss_t, pt, batch_np = _setup(arch)
    (lj, _), gj = jax.value_and_grad(
        lambda p, b: (_scalar(loss_j(p, b)), 0.0), has_aux=True)(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch_np.items()})
    for p in leaves(pt):
        p.requires_grad_(True)
    lt = _scalar(loss_t(pt, TL.to_device(batch_np, "cpu")))
    lt.backward()
    assert abs(lt.item() - float(lj)) <= 1e-5, (lt.item(), float(lj))
    _assert_leaves_close([p.grad if p.grad is not None
                          else torch.zeros_like(p) for p in leaves(pt)],
                         jax.tree.leaves(gj))


def test_gemma2_loss_and_gradients_at_its_head_dim_match_jax():
    """gemma2-2b cut to 2 layers, a d_model of 64 and 2 query heads over
    1, at its published head dim of 256, attention softcap 50, final
    softcap 30 and query scalar 256, with a 16-key window that bites at S
    64: the loss within 1e-5 and every gradient leaf of ``lm_loss``
    within REL of its norm against ``jax.value_and_grad``, float32 (the
    heads the D 256 attention kernels take on the card, here through the
    plain attention)."""
    import dataclasses
    over = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=1,
                d_head=256, d_ff=128, vocab_size=256, sliding_window=16,
                query_pre_attn_scalar=256.0, remat=False, dtype="float32")
    cfg_j = dataclasses.replace(get_config_j("gemma2-2b"), scan_layers=False,
                                **over)
    cfg = dataclasses.replace(get_config("gemma2-2b"), **over)
    assert cfg.attn_logit_softcap == 50.0 and cfg.local_global_pattern
    params = jax.tree.map(np.asarray,
                          T_j.init_params(jax.random.PRNGKey(2), cfg_j))
    pt = T.params_from_jax(params, cfg, device="cpu")
    b = next(D_j.lm_batches(cfg_j, 2, 64, seed=4))

    def loss_j(p):
        return _scalar(T_j.lm_loss(p, cfg_j, jnp.asarray(b["tokens"]),
                                   jnp.asarray(b["labels"])))
    lj, gj = jax.value_and_grad(loss_j)(jax.tree.map(jnp.asarray, params))
    for p in leaves(pt):
        p.requires_grad_(True)
    t = TL.to_device(b, "cpu")
    lt = _scalar(T.lm_loss(pt, cfg, t["tokens"], t["labels"]))
    lt.backward()
    assert abs(lt.item() - float(lj)) <= 1e-5, (lt.item(), float(lj))
    _assert_leaves_close([p.grad if p.grad is not None
                          else torch.zeros_like(p) for p in leaves(pt)],
                         jax.tree.leaves(gj))


def test_graph_readout_loss_and_gradients_match_jax():
    cfg_j, cfg = get_config_j("gcn-cora", smoke=True), get_config(
        "gcn-cora", smoke=True)
    params = jax.tree.map(np.asarray, G_j.init_params(
        jax.random.PRNGKey(3), cfg_j))
    b = next(D_j.batched_molecule_batches(6, 9, 20, cfg.d_feat,
                                          cfg.n_classes, seed=2))

    def loss_j(p):
        return G_j.graph_readout_loss(p, cfg_j, jnp.asarray(b["x"]),
                                      jnp.asarray(b["edge_index"]),
                                      jnp.asarray(b["graph_ids"]), 6,
                                      jnp.asarray(b["labels"]))
    lj, gj = jax.value_and_grad(loss_j)(jax.tree.map(jnp.asarray, params))
    pt = G.params_from_jax(params, device="cpu")
    for p in leaves(pt):
        p.requires_grad_(True)
    t = TL.to_device(b, "cpu")
    lt = G.graph_readout_loss(pt, cfg, t["x"], t["edge_index"],
                              t["graph_ids"], 6, t["labels"])
    lt.backward()
    assert abs(lt.item() - float(lj)) <= 1e-5
    _assert_leaves_close([p.grad for p in leaves(pt)], jax.tree.leaves(gj))


@pytest.mark.parametrize("aggregator,norm", [("mean", "sym"), ("sum", "rw"),
                                             ("max", "none")])
def test_gcn_gradients_through_every_segment_reduction(aggregator, norm):
    """``node_loss``'s gradient through the ordered ``segment_reduce`` of
    each aggregator (sum for mean and sum, max for max) against the
    reference's ``segment_sum`` / ``segment_max``, with padded edges."""
    import dataclasses
    cfg_j = dataclasses.replace(get_config_j("gcn-cora", smoke=True),
                                aggregator=aggregator, norm=norm, n_layers=3)
    cfg = dataclasses.replace(get_config("gcn-cora", smoke=True),
                              aggregator=aggregator, norm=norm, n_layers=3)
    params = jax.tree.map(np.asarray, G_j.init_params(
        jax.random.PRNGKey(5), cfg_j))
    g = D_j.synthetic_graph(80, 400, cfg.d_feat, cfg.n_classes, seed=7)
    emask = (np.arange(400) % 7 != 0).astype(np.float32)

    def loss_j(p):
        return G_j.node_loss(p, cfg_j, jnp.asarray(g["x"]),
                             jnp.asarray(g["edge_index"]),
                             jnp.asarray(g["labels"]),
                             jnp.asarray(g["train_mask"]),
                             edge_mask=jnp.asarray(emask))
    lj, gj = jax.value_and_grad(loss_j)(jax.tree.map(jnp.asarray, params))
    pt = G.params_from_jax(params, device="cpu")
    for p in leaves(pt):
        p.requires_grad_(True)
    t = TL.to_device({**g, "emask": emask}, "cpu")
    lt = G.node_loss(pt, cfg, t["x"], t["edge_index"], t["labels"],
                     t["train_mask"], edge_mask=t["emask"])
    lt.backward()
    assert abs(lt.item() - float(lj)) <= 1e-5
    _assert_leaves_close([p.grad for p in leaves(pt)], jax.tree.leaves(gj))
