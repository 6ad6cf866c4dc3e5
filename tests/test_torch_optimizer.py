"""The port's AdamW, schedules and clipping (``training.optimizer``)
against ``repro.training.optimizer`` on the CPU, on seeded numpy trees
(nested dicts and lists, as the models' parameters): ``schedule_lr``
(cosine and constant, across warmup and decay), ``global_norm``,
``clip_by_global_norm`` (clipping and not), ``adamw_init`` and
``adamw_update`` over several steps (with and without weight decay and
clipping), all within 1e-6 (float32; the frameworks round the same
float32 operations, summed in other orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import optimizer as O_j
from repro_torch.training import optimizer as O
from repro_torch.training.tree import leaves, tree_map

TOL = 1e-6


def _tree(seed, scale=1.0):
    r = np.random.default_rng(seed)
    return {"a": {"w": (scale * r.normal(size=(7, 5))).astype(np.float32),
                  "b": (scale * r.normal(size=(5,))).astype(np.float32)},
            "layers": [(scale * r.normal(size=(3, 4))).astype(np.float32)
                       for _ in range(2)],
            "s": np.float32(scale * r.normal())}


def _t(tree):
    return tree_map(lambda a: torch.tensor(np.asarray(a)), tree)


def _close(got, want, tol=TOL):
    for g, w in zip(leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(g.detach()), np.asarray(w),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("schedule", ["cosine", "constant"])
@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 50, 99, 100, 150])
def test_schedule_lr_matches(schedule, step):
    kw = dict(lr=3e-3, warmup_steps=10, total_steps=100, schedule=schedule)
    want = O_j.schedule_lr(O_j.AdamWConfig(**kw), jnp.int32(step))
    got = O.schedule_lr(O.AdamWConfig(**kw),
                        torch.tensor(step, dtype=torch.int32))
    np.testing.assert_allclose(float(got), float(want), rtol=TOL, atol=0)


def test_default_config_fields_match():
    assert O.AdamWConfig().__dict__ == O_j.AdamWConfig().__dict__


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_global_norm_and_clipping_match(max_norm):
    tree = _tree(1)
    np.testing.assert_allclose(float(O.global_norm(_t(tree))),
                               float(O_j.global_norm(tree)), rtol=TOL)
    want, wn = O_j.clip_by_global_norm(jax.tree.map(jnp.asarray, tree),
                                       max_norm)
    got, gn = O.clip_by_global_norm(_t(tree), max_norm)
    np.testing.assert_allclose(float(gn), float(wn), rtol=TOL)
    _close(got, want)


def test_adamw_init_is_zeros_at_step_0():
    st = O.adamw_init(_t(_tree(2)))
    assert int(st.step) == 0 and st.step.dtype == torch.int32
    assert all(float(x.abs().sum()) == 0 for x in leaves(st.m) + leaves(st.v))


@pytest.mark.parametrize("weight_decay,clip_norm", [(0.1, 1.0), (0.0, 0.0),
                                                    (0.1, 0.0)])
def test_adamw_update_matches_over_steps(weight_decay, clip_norm):
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=8,
              weight_decay=weight_decay, clip_norm=clip_norm)
    cfg_j, cfg = O_j.AdamWConfig(**kw), O.AdamWConfig(**kw)
    params = _tree(3)
    pj, pt = jax.tree.map(jnp.asarray, params), _t(params)
    sj, st = O_j.adamw_init(pj), O.adamw_init(pt)
    for i in range(5):
        grads = _tree(10 + i, scale=0.3 + i)
        pj, sj, mj = O_j.adamw_update(jax.tree.map(jnp.asarray, grads), sj,
                                      pj, cfg_j)
        pt, st, mt = O.adamw_update(_t(grads), st, pt, cfg)
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=TOL)
        _close(pt, pj)
        _close(st.m, sj.m)
        _close(st.v, sj.v)
    assert int(st.step) == int(sj.step) == 5


def test_adamw_update_writes_in_place():
    pt, grads = _t(_tree(4)), _t(_tree(5))
    st = O.adamw_init(pt)
    ids = [id(x) for x in leaves(pt) + leaves(st.m)]
    new_p, new_st, _ = O.adamw_update(grads, st, pt, O.AdamWConfig())
    assert [id(x) for x in leaves(new_p) + leaves(new_st.m)] == ids
