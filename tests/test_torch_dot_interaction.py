"""The port's ``dot_interaction`` plain version (what the wrapper runs on
CPU tensors) against the TPU kernel in interpret mode
(``ops.dot_interaction``) and its oracle ``ref.dot_interaction_ref``, at
the shapes of ``tests/test_kernels.py::test_dot_interaction_matches_ref``
with its ``tol(dtype)``; plus the wrapper's checks, and the backward's
plain version against ``jax.vjp`` of the reference's oracle."""
import jax
import numpy as np
import pytest
import torch
from test_kernels import KEY, tol

from repro.kernels import ops, ref
from repro_torch.kernels.dot_interaction import (dot_interaction,
                                                 dot_interaction_bwd,
                                                 dot_interaction_bwd_ref,
                                                 dot_interaction_ref)

DTYPES = {"float32": (jax.numpy.float32, torch.float32),
          "bfloat16": (jax.numpy.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,F,D", [(37, 27, 128), (128, 27, 128),
                                   (16, 8, 64), (5, 12, 32)])
def test_dot_interaction_matches_jax(B, F, D, dtype):
    jdt, tdt = DTYPES[dtype]
    x = jax.random.normal(KEY, (B, F, D), jdt)
    xt = torch.tensor(np.asarray(x, np.float32)).to(tdt)   # exact
    got = dot_interaction(xt)                  # CPU: the plain version
    assert got.dtype == tdt and tuple(got.shape) == (B, F * (F - 1) // 2)
    torch.testing.assert_close(got, dot_interaction_ref(xt), rtol=0, atol=0)
    got = got.to(torch.float32).numpy()
    for want in (ops.dot_interaction(x, block_b=16, interpret=True),
                 ref.dot_interaction_ref(x)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   **tol(jdt))


def test_cpu_calls_do_not_count_as_launches():
    before = dot_interaction.launches
    dot_interaction(torch.ones((2, 3, 4)))
    assert dot_interaction.launches == before


@pytest.mark.parametrize("x,err", [
    (torch.ones((2, 3)), ValueError),                   # not (B, F, D)
    (torch.ones((2, 3, 4), dtype=torch.float64), TypeError),
    (torch.ones((2, 3, 4), device="meta"), ValueError),  # not cuda or cpu
])
def test_wrapper_rejects_what_the_kernel_does_not_take(x, err):
    with pytest.raises(err):
        dot_interaction(x)


# --- the gradient: the backward kernel's plain version ---------------------

@pytest.mark.parametrize("B,F,D", [(37, 27, 128), (16, 8, 64), (5, 12, 32),
                                   (3, 2, 16), (4, 1, 8)])
def test_backward_plain_version_matches_jax_vjp(B, F, D):
    """``dot_interaction_bwd_ref`` against ``jax.vjp`` of the reference's
    einsum and triangle gather (``ref.dot_interaction_ref``) with a
    seeded gradient of the triangle, float32, atol 1e-5."""
    r = np.random.default_rng(B * F + D)
    x = r.normal(size=(B, F, D)).astype(np.float32) * D ** -0.5
    g = r.normal(size=(B, F * (F - 1) // 2)).astype(np.float32)
    _, vjp = jax.vjp(ref.dot_interaction_ref, jax.numpy.asarray(x))
    want, = vjp(jax.numpy.asarray(g))
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    got = dot_interaction_bwd_ref(xt, gt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # autograd through the CPU path is the same function, and the CPU
    # wrapper takes the plain version without counting a launch
    leaf = xt.clone().requires_grad_(True)
    dot_interaction(leaf).backward(gt)
    np.testing.assert_allclose(leaf.grad.numpy(), got.numpy(), atol=1e-5)
    before = dot_interaction_bwd.launches
    torch.testing.assert_close(dot_interaction_bwd(xt, gt), got, rtol=0,
                               atol=0)
    assert dot_interaction_bwd.launches == before


def test_backward_wrapper_rejects_a_mismatched_gradient():
    x = torch.ones((2, 4, 8))
    with pytest.raises(ValueError):
        dot_interaction_bwd(x, torch.ones((2, 5)))
    with pytest.raises(ValueError):
        dot_interaction_bwd(x, torch.ones((2, 6), dtype=torch.bfloat16))
