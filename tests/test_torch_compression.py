"""The port's int8 gradient compression with error feedback
(``training.compression``) against ``repro.training.compression`` on the
CPU, on seeded numpy gradients: the int8 codes and per-chunk scales of
``_quant_leaf`` exactly (both round half to even: values on .5 code
boundaries are included), ``_dequant_leaf``, and ``compress_decompress``
over several steps with its error-feedback state and ``ef_l1``, exactly;
sizes below, at and past a chunk, and an all-zero leaf."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import compression as C_j
from repro_torch.training import compression as C
from repro_torch.training.tree import leaves, tree_map


def _leaf(n, seed):
    r = np.random.default_rng(seed)
    return (r.normal(size=n) * 10 ** r.uniform(-3, 1)).astype(np.float32)


@pytest.mark.parametrize("n", [1, 7, 2047, 2048, 2049, 6000])
def test_quant_codes_and_scales_equal(n):
    g = _leaf(n, n)
    q_j, s_j = C_j._quant_leaf(jnp.asarray(g))
    q, s = C._quant_leaf(torch.from_numpy(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))
    d_j = C_j._dequant_leaf(q_j, s_j, (n,), jnp.float32)
    d = C._dequant_leaf(q, s, (n,), torch.float32)
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_j))


def test_half_way_values_round_to_even_as_the_reference():
    # a chunk whose max is 127 makes the scale 1.0: codes are round(x)
    g = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.49],
                 np.float32)
    q, _ = C._quant_leaf(torch.from_numpy(g))
    q_j, _ = C_j._quant_leaf(jnp.asarray(g))
    np.testing.assert_array_equal(q.numpy()[0, :8], np.asarray(q_j)[0, :8])
    assert q.numpy()[0, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, 3]


def test_all_zero_leaf_keeps_the_floor_scale():
    q, s = C._quant_leaf(torch.zeros(10))
    assert float(s.max()) == np.float32(1e-12) and int(q.abs().max()) == 0


def test_compress_decompress_and_error_feedback_equal_over_steps():
    shapes = {"w": (37, 61), "b": (61,), "layers": [(3000,), (5, 5)]}
    like = {"w": np.zeros(shapes["w"], np.float32),
            "b": np.zeros(shapes["b"], np.float32),
            "layers": [np.zeros(s, np.float32) for s in shapes["layers"]]}
    ef_j = C_j.ef_init(jax.tree.map(jnp.asarray, like))
    ef = C.ef_init(tree_map(torch.from_numpy, like))
    for step in range(4):
        grads = jax.tree.map(
            lambda a: _leaf(a.size, step * 100 + a.size).reshape(a.shape),
            like)
        out_j, ef_j, m_j = C_j.compress_decompress(
            jax.tree.map(jnp.asarray, grads), ef_j)
        out, ef, m = C.compress_decompress(tree_map(torch.from_numpy, grads),
                                           ef)
        for a, b in zip(leaves(out) + leaves(ef),
                        jax.tree.leaves(out_j) + jax.tree.leaves(ef_j)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert float(m["ef_l1"]) == pytest.approx(float(m_j["ef_l1"]),
                                                  rel=1e-6)
