"""The port's transformer with the dense fields of gemma2-2b and
qwen2.5-14b, on the CPU against the JAX reference with the reference's
own initialized parameters (``params_from_jax``): ``forward``,
``score_tokens``, ``prefill`` and ``decode_step``, allclose at atol 1e-4
in float32 (the frameworks sum in different orders).

The smoke gemma2 has ``sliding_window = 16`` on its even layers, so
documents of 32 tokens and prompts past 16 positions make the window
bite; with it the attention and final softcaps, pre and post norms, the
sqrt(d_model) embedding scale and the query pre-attention scalar. The
smoke qwen2.5 has q/k/v biases, an untied ``unembed`` and d_head 12.
Both the listed (smoke) and the stacked (``scan_layers=True``, the full
configs' form) parameter trees are converted."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as get_config_j
from repro.configs.base import reduced as reduced_j
from repro.models import transformer as T_j
from repro.serving.evaluators import make_evaluator as make_evaluator_j
from repro_torch.configs import get_config
from repro_torch.models import transformer as T
from repro_torch.serving.evaluators import make_evaluator

ATOL = 1e-4
ARCHS = ["gemma2-2b", "qwen2.5-14b"]


def _pair(arch, scan_layers=False, seed=0):
    cfg_j = reduced_j(get_config_j(arch, smoke=True),
                      scan_layers=scan_layers)
    params = jax.tree.map(np.asarray,
                          T_j.init_params(jax.random.PRNGKey(seed), cfg_j))
    # the reference's zero-initialized norms and biases leave their paths
    # untested: give every norm scale and bias seeded values
    r = np.random.default_rng(seed + 11)

    def perturb(path, a):
        name = jax.tree_util.keystr(path)
        if "scale" in name or "['b']" in name:
            return (a + r.normal(scale=0.1, size=a.shape)).astype(a.dtype)
        return a

    params = jax.tree_util.tree_map_with_path(perturb, params)
    cfg = get_config(arch, smoke=True)
    return (cfg_j, jax.tree.map(jnp.asarray, params), cfg,
            T.params_from_jax(params, cfg, device="cpu"), params)


def _tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(
        0, vocab, size=shape).astype(np.int32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol)


def test_smoke_configs_exercise_every_field():
    g, q = get_config("gemma2-2b", smoke=True), get_config("qwen2.5-14b",
                                                           smoke=True)
    assert T.layer_windows(g) == [16, 0] and g.attn_logit_softcap > 0
    assert g.final_logit_softcap > 0 and g.post_norm and g.act == "gelu"
    assert g.scale_embeddings and g.query_pre_attn_scalar == 16.0
    assert q.qkv_bias and not q.tie_embeddings and q.d_head == 12


@pytest.mark.parametrize("arch", ARCHS)
def test_full_configs_match_the_reference_field_for_field(arch):
    for smoke in (False, True):
        cfg, cfg_j = get_config(arch, smoke), get_config_j(arch, smoke)
        for f in dataclasses.fields(cfg):
            assert getattr(cfg, f.name) == getattr(cfg_j, f.name), f.name


@pytest.mark.parametrize("scan_layers", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_score_match_jax(arch, scan_layers, monkeypatch):
    cfg_j, pj, cfg, pt, params = _pair(arch, scan_layers)
    if scan_layers:
        assert params["blocks"]["ln1"]["scale"].shape[0] == cfg.n_layers
    if arch == "qwen2.5-14b":
        assert "unembed" in pt and "b" in pt["blocks"][0]["attn"]["wq"]
    else:
        assert "ln2_post" in pt["blocks"][1]
    toks = _tokens((5, 32), cfg.vocab_size, seed=2)
    logits_j, _ = T_j.forward(pj, cfg_j, jnp.asarray(toks[:, :-1]),
                              q_chunk=32)
    logits = T.forward(pt, cfg, torch.from_numpy(toks[:, :-1]), q_chunk=32)
    _close(logits, logits_j)
    want = T_j.score_tokens(pj, cfg_j, jnp.asarray(toks), q_chunk=32)
    # the default budget (one chunk here), then 37 positions a chunk:
    # chunks that straddle rows, the last one ragged
    for budget in (T.SCORE_LOGIT_BYTES, 4 * cfg.vocab_size * 37):
        monkeypatch.setattr(T, "SCORE_LOGIT_BYTES", budget)
        got = T.score_tokens(pt, cfg, torch.from_numpy(toks), q_chunk=32)
        _close(got, want)
    x, metrics = T.hidden_states(pt, cfg, torch.from_numpy(toks),
                                 q_chunk=32, with_metrics=True)
    assert metrics == {} and x.shape == (5, 32, cfg.d_model)


def test_window_changes_the_gemma2_scores():
    """The local layer's window is what the reference applies: without
    it the scores move past the tolerance."""
    cfg_j, pj, cfg, pt, _ = _pair("gemma2-2b")
    toks = torch.from_numpy(_tokens((3, 32), cfg.vocab_size, seed=4))
    got = T.score_tokens(pt, cfg, toks, q_chunk=32)
    glob = T.score_tokens(pt, dataclasses.replace(cfg, sliding_window=0),
                          toks, q_chunk=32)
    assert float((got - glob).abs().max()) > 10 * ATOL


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_match_jax(arch):
    """A 20-token prefill into a 28-slot cache, then 6 decode steps:
    the local layer's window of 16 bites in both."""
    cfg_j, pj, cfg, pt, _ = _pair(arch, seed=1)
    toks = _tokens((2, 20), cfg.vocab_size, seed=5)
    score_j, cache_j = T_j.prefill(pj, cfg_j, jnp.asarray(toks), max_len=28)
    score, cache = T.prefill(pt, cfg, torch.from_numpy(toks), max_len=28)
    _close(score, score_j)
    for name in ("k", "v"):
        _close(cache[name], cache_j[name])
    nxt = _tokens((6, 2), cfg.vocab_size, seed=6)
    for t in range(6):
        logits_j, cache_j = T_j.decode_step(pj, cfg_j, jnp.asarray(nxt[t]),
                                            cache_j)
        logits, cache = T.decode_step(pt, cfg, torch.from_numpy(nxt[t]),
                                      cache)
        _close(logits, logits_j)
    _close(cache["k"], cache_j["k"])
    np.testing.assert_array_equal(cache["lengths"].numpy(),
                                  np.asarray(cache_j["lengths"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_equals_forward(arch):
    """The port's own property: prefill + decode gives the full
    forward's logits at every decoded position, past the window."""
    _, _, cfg, pt, _ = _pair(arch, seed=2)
    toks = torch.from_numpy(_tokens((2, 26), cfg.vocab_size, seed=9))
    full = T.forward(pt, cfg, toks)
    _, cache = T.prefill(pt, cfg, toks[:, :18], max_len=32)
    for t in range(18, 26):
        logits, cache = T.decode_step(pt, cfg, toks[:, t], cache)
        torch.testing.assert_close(logits, full[:, t], atol=ATOL, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_evaluator_matches_jax_evaluator(arch):
    """make_evaluator with the reference's parameters scores the same
    documents (``make_features`` is shared) like the reference's."""
    ev_j, mk_j = make_evaluator_j(arch, smoke=True, seed=0)
    params = jax.tree.map(np.asarray, T_j.init_params(
        jax.random.PRNGKey(0), get_config_j(arch, smoke=True)))
    ev, mk = make_evaluator(arch, smoke=True, params=params, device="cpu")
    feats = mk(7, fseed=3)
    np.testing.assert_array_equal(feats["tokens"], mk_j(7, 3)["tokens"])
    want = ev_j({"tokens": jnp.asarray(feats["tokens"])})
    got = ev({"tokens": torch.from_numpy(feats["tokens"])})
    assert got.shape == (7,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_seeded_init_is_shaped_like_jax(arch):
    cfg = get_config(arch, smoke=True)
    tp = T.init_params(cfg, torch.Generator().manual_seed(0))
    want = jax.tree.map(lambda a: tuple(a.shape), jax.tree.map(
        np.asarray, T_j.init_params(jax.random.PRNGKey(0),
                                    get_config_j(arch, smoke=True))))
    got = jax.tree.map(lambda t: tuple(t.shape), tp)
    assert got == jax.tree.map(tuple, want, is_leaf=lambda x:
                               isinstance(x, tuple))
    bf = T.init_params(cfg, torch.Generator().manual_seed(0),
                       dtype=torch.bfloat16)
    assert bf["embed"]["table"].dtype == torch.bfloat16
    torch.testing.assert_close(bf["embed"]["table"],
                               tp["embed"]["table"].to(torch.bfloat16),
                               rtol=0, atol=0)
