"""The port's MoE FFN and the MoE transformers (qwen3-moe-30b-a3b and
moonshot-v1-16b-a3b at smoke width) on the CPU against the JAX reference
on the reference's own parameters, in float32: outputs, scores and
logits allclose at atol 1e-4 (summation order), ``moe_drop_frac``
exactly equal (which pairs an expert drops decides which tokens keep
only the residual), ``moe_aux_loss`` allclose. Covers capacity drops (a
capacity factor small enough to drop), shared experts, ``first_k_dense``
and ``norm_topk_prob``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as get_config_j
from repro.configs.base import MoEConfig as MoEConfig_j
from repro.models import moe as M_j
from repro.models import transformer as T_j
from repro.serving.evaluators import make_evaluator as make_evaluator_j
from repro_torch.configs import get_config
from repro_torch.configs.base import MoEConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.serving.evaluators import make_evaluator

ATOL = 1e-4
ARCHS = ["qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b"]


def _moe_pair(d_model, seed=0, **kw):
    cfg_j, cfg = MoEConfig_j(**kw), MoEConfig(**kw)
    p = jax.tree.map(np.asarray, M_j.moe_init(jax.random.PRNGKey(seed),
                                              d_model, cfg_j))
    return cfg_j, jax.tree.map(jnp.asarray, p), cfg, L.to_tensors(p), p


MOE_CASES = {
    "qwen3_smoke": dict(n_experts=8, top_k=2, d_expert=96,
                        capacity_factor=1.5),
    "shared": dict(n_experts=8, top_k=2, d_expert=96, n_shared_experts=1,
                   d_shared=96, capacity_factor=1.5),
    "drops": dict(n_experts=8, top_k=3, d_expert=32, capacity_factor=0.25,
                  n_shared_experts=2, d_shared=16),
    "no_norm_topk": dict(n_experts=16, top_k=4, d_expert=24,
                         norm_topk_prob=False, capacity_factor=0.5),
    "ep_dispatch": dict(n_experts=8, top_k=2, d_expert=96,
                        dispatch="ep_shard_map"),
}


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_apply_matches_jax(case, act):
    D, T_ = 64, 77
    cfg_j, pj, cfg, pt, _ = _moe_pair(D, **MOE_CASES[case])
    x = np.random.default_rng(1).normal(size=(T_, D)).astype(np.float32)
    want, mj = M_j.apply(pj, jnp.asarray(x), cfg_j, act=act,
                         compute_dtype=jnp.float32)
    got, m = M.apply(pt, torch.from_numpy(x), cfg, act=act,
                     compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert float(m["moe_drop_frac"]) == float(mj["moe_drop_frac"])
    np.testing.assert_allclose(float(m["moe_aux_loss"]),
                               float(mj["moe_aux_loss"]), rtol=1e-5)
    if case == "drops":
        assert float(m["moe_drop_frac"]) > 0.3
    else:
        assert float(m["moe_drop_frac"]) < 0.3


def test_capacity_matches_jax():
    for kw in MOE_CASES.values():
        for n in (1, 7, 31, 100, 31 * 3072):
            assert M.capacity(n, MoEConfig(**kw)) == M_j.capacity(
                n, MoEConfig_j(**kw))


def test_dropped_tokens_keep_only_the_shared_path():
    """A capacity of 8 slots per expert for 200 tokens: a dropped pair
    adds nothing, so a token all of whose pairs dropped gets only the
    shared experts' output."""
    cfg_j, pj, cfg, pt, _ = _moe_pair(32, **MOE_CASES["drops"])
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(200, 32)).astype(np.float32))
    out, m = M.moe_apply(pt, x, cfg, compute_dtype=torch.float32)
    shared = L.glu_ffn_apply(pt["shared"], x, compute_dtype=torch.float32)
    assert M.capacity(200, cfg) == 24
    routed = out - shared
    assert (routed.abs().amax(dim=-1) == 0).sum() > 0
    assert float(m["moe_drop_frac"]) > 0.5


def _model_pair(arch, seed=0):
    cfg_j = get_config_j(arch, smoke=True)
    params = jax.tree.map(np.asarray,
                          T_j.init_params(jax.random.PRNGKey(seed), cfg_j))
    cfg = get_config(arch, smoke=True)
    return (cfg_j, jax.tree.map(jnp.asarray, params), cfg,
            T.params_from_jax(params, cfg, device="cpu"), params)


def _tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(
        0, vocab, size=shape).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_transformer_forward_score_and_metrics_match_jax(arch):
    cfg_j, pj, cfg, pt, params = _model_pair(arch)
    assert len(pt.get("dense_blocks", [])) == cfg.moe.first_k_dense
    toks = _tokens((6, 32), cfg.vocab_size, seed=3)
    logits_j, mj = T_j.forward(pj, cfg_j, jnp.asarray(toks[:, :-1]),
                               q_chunk=32)
    logits, m = T.forward(pt, cfg, torch.from_numpy(toks[:, :-1]),
                          q_chunk=32, with_metrics=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j),
                               atol=ATOL)
    assert float(m["moe_drop_frac"]) == float(mj["moe_drop_frac"])
    np.testing.assert_allclose(float(m["moe_aux_loss"]),
                               float(mj["moe_aux_loss"]), rtol=1e-5)
    _, mh = T_j.hidden_states(pj, cfg_j, jnp.asarray(toks), q_chunk=32)
    _, mt = T.hidden_states(pt, cfg, torch.from_numpy(toks), q_chunk=32,
                            with_metrics=True)
    assert float(mt["moe_drop_frac"]) == float(mh["moe_drop_frac"])
    want = T_j.score_tokens(pj, cfg_j, jnp.asarray(toks), q_chunk=32)
    got = T.score_tokens(pt, cfg, torch.from_numpy(toks), q_chunk=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_transformer_prefill_and_decode_match_jax(arch):
    cfg_j, pj, cfg, pt, _ = _model_pair(arch, seed=1)
    toks = _tokens((3, 9), cfg.vocab_size, seed=4)
    score_j, cache_j = T_j.prefill(pj, cfg_j, jnp.asarray(toks), max_len=14)
    score, cache = T.prefill(pt, cfg, torch.from_numpy(toks), max_len=14)
    np.testing.assert_allclose(score.numpy(), np.asarray(score_j), atol=ATOL)
    nxt = _tokens((5, 3), cfg.vocab_size, seed=5)
    for t in range(5):
        logits_j, cache_j = T_j.decode_step(pj, cfg_j, jnp.asarray(nxt[t]),
                                            cache_j)
        logits, cache = T.decode_step(pt, cfg, torch.from_numpy(nxt[t]),
                                      cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j),
                                   atol=ATOL)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(cache_j["k"]),
                               atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_evaluator_matches_jax_evaluator(arch):
    ev_j, mk_j = make_evaluator_j(arch, smoke=True, seed=0)
    params = jax.tree.map(np.asarray, T_j.init_params(
        jax.random.PRNGKey(0), get_config_j(arch, smoke=True)))
    ev, mk = make_evaluator(arch, smoke=True, params=params, device="cpu")
    feats = mk(11, fseed=2)
    want = ev_j({"tokens": jnp.asarray(feats["tokens"])})
    got = ev({"tokens": torch.from_numpy(feats["tokens"])})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_configs_match_the_reference_field_for_field(arch):
    for smoke in (False, True):
        cfg, cfg_j = get_config(arch, smoke), get_config_j(arch, smoke)
        for f in dataclasses.fields(cfg):
            a, b = getattr(cfg, f.name), getattr(cfg_j, f.name)
            if f.name == "moe":
                assert dataclasses.asdict(a) == dataclasses.asdict(b)
            else:
                assert a == b, f.name


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_init_is_shaped_like_jax_and_stacked_params_convert(arch):
    cfg = get_config(arch, smoke=True)
    tp = T.init_params(cfg, torch.Generator().manual_seed(0))
    ref = jax.tree.map(lambda a: tuple(np.asarray(a).shape), T_j.init_params(
        jax.random.PRNGKey(0), get_config_j(arch, smoke=True)))
    got = jax.tree.map(lambda t: tuple(t.shape), tp)
    assert got == jax.tree.map(tuple, ref, is_leaf=lambda x:
                               isinstance(x, tuple))
    # the full configs' stacked form: blocks with a leading layer axis
    cfg_j = dataclasses.replace(get_config_j(arch, smoke=True),
                                scan_layers=True)
    stacked = jax.tree.map(np.asarray, T_j.init_params(
        jax.random.PRNGKey(0), cfg_j))
    n_blocks = cfg.n_layers - cfg.moe.first_k_dense
    assert stacked["blocks"]["moe"]["w_gate"].shape[0] == n_blocks
    pt = T.params_from_jax(stacked, cfg, device="cpu")
    toks = _tokens((2, 12), cfg.vocab_size, seed=7)
    want, _ = T_j.forward(jax.tree.map(jnp.asarray, stacked), cfg_j,
                          jnp.asarray(toks))
    np.testing.assert_allclose(T.forward(pt, cfg, torch.from_numpy(toks)
                                         ).numpy(), np.asarray(want),
                               atol=ATOL)
