"""The port's transformer evaluator on the CPU against the JAX reference
with the reference's own initialized parameters (``params_from_jax``):
``score_tokens`` and the evaluator's trust scores allclose at atol 1e-4
in float32 (summation order differs between the frameworks). Covers the
smoke smollm (blocks as a list) and a 2-layer config with
``scan_layers=True`` (blocks stacked on a leading layer axis, the form
the full config uses)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as get_config_j
from repro.configs.base import reduced as reduced_j
from repro.models import transformer as T_j
from repro.serving.evaluators import make_evaluator as make_evaluator_j
from repro_torch.configs import get_config, reduced
from repro_torch.models import transformer as T
from repro_torch.serving.evaluators import make_evaluator

ATOL = 1e-4


def _np_params(cfg_j, seed=0):
    params = T_j.init_params(jax.random.PRNGKey(seed), cfg_j)
    return jax.tree.map(np.asarray, params)


def _tokens(n, vocab, doc_len=32, seed=3):
    r = np.random.default_rng(seed)
    return r.integers(0, vocab, size=(n, doc_len)).astype(np.int32)


@pytest.mark.parametrize("scan_layers,n_layers", [(False, 2), (True, 2),
                                                  (True, 3)])
def test_score_tokens_matches_jax(scan_layers, n_layers, monkeypatch):
    cfg_j = reduced_j(get_config_j("smollm-135m", smoke=True),
                      scan_layers=scan_layers, n_layers=n_layers)
    cfg = reduced(get_config("smollm-135m", smoke=True), n_layers=n_layers)
    params = _np_params(cfg_j)
    if scan_layers:         # stacked leaves: (n_layers, ...)
        assert params["blocks"]["attn"]["wq"]["w"].shape[0] == n_layers
    tp = T.params_from_jax(params, cfg, device="cpu")
    assert len(tp["blocks"]) == n_layers
    toks = _tokens(6, cfg.vocab_size)
    want = T_j.score_tokens(jax.tree.map(jnp.asarray, params), cfg_j,
                            jnp.asarray(toks), q_chunk=32)
    # a budget of 4 rows' positions: two chunks of logits, one ragged
    monkeypatch.setattr(T, "SCORE_LOGIT_BYTES",
                        4 * cfg.vocab_size * 4 * (toks.shape[1] - 1))
    got = T.score_tokens(tp, cfg, torch.from_numpy(toks), q_chunk=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    logits_j, _ = T_j.forward(jax.tree.map(jnp.asarray, params), cfg_j,
                              jnp.asarray(toks[:, :-1]), q_chunk=32)
    logits = T.forward(tp, cfg, torch.from_numpy(toks[:, :-1]), q_chunk=32)
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j),
                               atol=ATOL)


def test_evaluator_matches_jax_evaluator():
    """make_evaluator with the reference's parameters scores the same
    documents (``make_features`` is shared) like the reference's."""
    ev_j, mk_j = make_evaluator_j("smollm-135m", smoke=True, seed=0)
    params = _np_params(get_config_j("smollm-135m", smoke=True), seed=0)
    ev, mk = make_evaluator("smollm-135m", smoke=True, params=params,
                            device="cpu")
    feats = mk(9, fseed=4)
    np.testing.assert_array_equal(feats["tokens"], mk_j(9, 4)["tokens"])
    want = ev_j({"tokens": jnp.asarray(feats["tokens"])})
    got = ev({"tokens": torch.from_numpy(feats["tokens"])})
    assert got.shape == (9,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_seeded_init_is_deterministic_and_shaped_like_jax():
    ev_a, mk = make_evaluator("smollm-135m", smoke=True, seed=5,
                              device="cpu")
    ev_b, _ = make_evaluator("smollm-135m", smoke=True, seed=5,
                             device="cpu")
    toks = torch.from_numpy(mk(4)["tokens"])
    torch.testing.assert_close(ev_a({"tokens": toks}),
                               ev_b({"tokens": toks}), rtol=0, atol=0)
    cfg = get_config("smollm-135m", smoke=True)
    tp = T.init_params(cfg, torch.Generator().manual_seed(0))
    ref_shapes = jax.tree.map(lambda a: a.shape, _np_params(
        get_config_j("smollm-135m", smoke=True)))
    assert tp["embed"]["table"].shape == ref_shapes["embed"]["table"]
    for blk, ref in zip(tp["blocks"], ref_shapes["blocks"]):
        got = jax.tree.map(lambda t: tuple(t.shape), blk)
        assert got == jax.tree.map(tuple, ref, is_leaf=lambda x:
                                   isinstance(x, tuple))


def test_full_config_matches_published_widths():
    cfg, cfg_j = get_config("smollm-135m"), get_config_j("smollm-135m")
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_head",
              "d_ff", "vocab_size", "tie_embeddings", "rope_theta",
              "norm_eps", "act", "dtype", "param_dtype"):
        assert getattr(cfg, f) == getattr(cfg_j, f), f
