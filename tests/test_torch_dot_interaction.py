"""The port's ``dot_interaction`` plain version (what the wrapper runs on
CPU tensors) against the TPU kernel in interpret mode
(``ops.dot_interaction``) and its oracle ``ref.dot_interaction_ref``, at
the shapes of ``tests/test_kernels.py::test_dot_interaction_matches_ref``
with its ``tol(dtype)``; plus the wrapper's checks."""
import jax
import numpy as np
import pytest
import torch
from test_kernels import KEY, tol

from repro.kernels import ops, ref
from repro_torch.kernels.dot_interaction import (dot_interaction,
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
