"""The port's DLRM evaluator on the CPU against the JAX reference with the
reference's own initialized parameters (``dlrm.params_from_jax``):
``forward`` and ``relevance_scores`` at the smoke config and at a reduced
config with 26 small tables (F = 27 features, as the full model), both
``make_evaluator("dlrm-mlperf", smoke=True)`` on one ``make_features``
output, and out-of-range and negative indices, which ``lookup`` clips as
``jnp.take(mode="clip")`` does. atol 1e-5 in float32 (the MLP sums run in
another order). Also the published config and the row cap the chip run
uses."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as get_config_j
from repro.configs.base import EmbeddingTableConfig as Table_j
from repro.configs.base import reduced as reduced_j
from repro.models.recsys import dlrm as D_j
from repro.models.recsys import embedding as E_j
from repro.serving.evaluators import make_evaluator as make_evaluator_j
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import EmbeddingTableConfig, cap_table_rows
from repro_torch.configs.dlrm_mlperf import CRITEO_1TB_ROWS
from repro_torch.models.recsys import dlrm as D
from repro_torch.models.recsys import embedding as E
from repro_torch.serving.evaluators import make_evaluator

ATOL = 1e-5
ARCH = "dlrm-mlperf"
ROW_CAP = 20_000_000            # the chip run's cap (80 GB card)


def _f27_configs():
    """26 tables of dim 16 with small vocabularies: F = 27 as in the full
    model, at a size the CPU holds."""
    vocabs = [min(v, 1000) for v in CRITEO_1TB_ROWS]
    kw = dict(name=ARCH + "-f27", embed_dim=16, bot_mlp=(13, 64, 16),
              top_mlp=(64, 32, 1))
    cfg_j = reduced_j(get_config_j(ARCH), tables=tuple(
        Table_j(name=f"sparse_{i}", vocab=v, dim=16)
        for i, v in enumerate(vocabs)), **kw)
    cfg = reduced(get_config(ARCH), tables=tuple(
        EmbeddingTableConfig(name=f"sparse_{i}", vocab=v, dim=16)
        for i, v in enumerate(vocabs)), **kw)
    return cfg_j, cfg


def _pair(cfg_j, cfg, seed=0):
    params = jax.tree.map(np.asarray,
                          D_j.init_params(jax.random.PRNGKey(seed), cfg_j))
    return (jax.tree.map(jnp.asarray, params),
            D.params_from_jax(params, device="cpu"))


def _inputs(cfg, n, seed, lo=0, hi_extra=0):
    r = np.random.default_rng(seed)
    dense = r.normal(size=(n, cfg.n_dense)).astype(np.float32)
    sparse = np.stack([r.integers(lo, t.vocab + hi_extra, size=n)
                       for t in cfg.tables], axis=1).astype(np.int32)
    return dense, sparse


@pytest.mark.parametrize("which", ["smoke", "f27"])
def test_forward_and_scores_match_jax(which):
    if which == "smoke":
        cfg_j, cfg = get_config_j(ARCH, smoke=True), get_config(ARCH,
                                                                smoke=True)
    else:
        cfg_j, cfg = _f27_configs()
    assert len(cfg.tables) + 1 == (5 if which == "smoke" else 27)
    pj, pt = _pair(cfg_j, cfg)
    dense, sparse = _inputs(cfg, 33, seed=1)
    want = D_j.forward(pj, cfg_j, jnp.asarray(dense), jnp.asarray(sparse))
    got = D.forward(pt, cfg, torch.from_numpy(dense),
                    torch.from_numpy(sparse))
    assert got.dtype == torch.float32 and tuple(got.shape) == (33,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    want = D_j.relevance_scores(pj, cfg_j, jnp.asarray(dense),
                                jnp.asarray(sparse), trust_scale=5.0)
    got = D.relevance_scores(pt, cfg, torch.from_numpy(dense),
                             torch.from_numpy(sparse), trust_scale=5.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_out_of_range_and_negative_indices_clip_as_jax():
    cfg_j, cfg = _f27_configs()
    pj, pt = _pair(cfg_j, cfg, seed=3)
    # indices from -600 to vocab + 1200: past the vocab, past the padded
    # rows (ROW_PAD = 512) and below zero
    dense, sparse = _inputs(cfg, 64, seed=2, lo=-600, hi_extra=1200)
    assert (sparse < 0).any() and (sparse >= 1024).any()
    want = D_j.forward(pj, cfg_j, jnp.asarray(dense), jnp.asarray(sparse))
    got = D.forward(pt, cfg, torch.from_numpy(dense),
                    torch.from_numpy(sparse))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    table = pt["tables"]["sparse_0"]
    idx = torch.from_numpy(sparse[:, 0])
    np.testing.assert_array_equal(
        E.lookup(table, idx).numpy(),
        np.asarray(E_j.lookup(pj["tables"]["sparse_0"], jnp.asarray(
            sparse[:, 0]))))


def test_evaluator_matches_jax_evaluator():
    ev_j, mk_j = make_evaluator_j(ARCH, smoke=True, seed=0)
    cfg_j = get_config_j(ARCH, smoke=True)
    params = jax.tree.map(np.asarray,
                          D_j.init_params(jax.random.PRNGKey(0), cfg_j))
    ev, mk = make_evaluator(ARCH, smoke=True, params=params, device="cpu")
    feats = mk(40, fseed=4)
    for name, arr in mk_j(40, 4).items():
        np.testing.assert_array_equal(feats[name], arr)
    want = ev_j({k: jnp.asarray(v) for k, v in feats.items()})
    got = ev({k: torch.from_numpy(v) for k, v in feats.items()})
    assert got.shape == (40,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_seeded_init_has_the_reference_shapes():
    cfg = get_config(ARCH, smoke=True)
    ev_a, mk = make_evaluator(ARCH, smoke=True, seed=5, device="cpu")
    ev_b, _ = make_evaluator(ARCH, smoke=True, seed=5, device="cpu")
    feats = {k: torch.from_numpy(v) for k, v in mk(8).items()}
    torch.testing.assert_close(ev_a(feats), ev_b(feats), rtol=0, atol=0)
    tp = D.init_params(cfg, torch.Generator().manual_seed(0))
    ref = jax.tree.map(lambda a: tuple(a.shape), D_j.init_params(
        jax.random.PRNGKey(0), get_config_j(ARCH, smoke=True)))
    got = jax.tree.map(lambda t: tuple(t.shape), tp)
    assert got == jax.tree.map(tuple, ref,
                               is_leaf=lambda x: isinstance(x, tuple))


def test_full_config_and_row_cap():
    cfg, cfg_j = get_config(ARCH), get_config_j(ARCH)
    for f in ("model", "embed_dim", "n_dense", "bot_mlp", "top_mlp",
              "interaction", "dtype", "param_dtype"):
        assert getattr(cfg, f) == getattr(cfg_j, f), f
    assert [(t.name, t.vocab, t.dim) for t in cfg.tables] == \
        [(t.name, t.vocab, t.dim) for t in cfg_j.tables]
    rows = sum(E.padded_rows(t.vocab) for t in cfg.tables)
    assert rows == 187_775_488                      # 96.1 GB in float32
    capped = cap_table_rows(cfg, ROW_CAP)
    cut = [i for i, (a, b) in enumerate(zip(cfg.tables, capped.tables))
           if a.vocab != b.vocab]
    assert cut == [0, 9, 19, 20, 21]
    assert sum(E.padded_rows(t.vocab) for t in capped.tables) == 104_072_192
    assert capped.top_mlp == cfg.top_mlp and capped.bot_mlp == cfg.bot_mlp
    assert {t.dim for t in capped.tables} == {128}
    with pytest.raises(ValueError):
        make_evaluator("smollm-135m", device="cpu", max_table_rows=10)
