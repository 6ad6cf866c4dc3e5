"""The port's attention on the CPU against the JAX reference, f32, atol
1e-5 (the two frameworks sum the softmax and the products in different
orders): the model-path chunked attention (``models.attention``) and the
kernel wrapper's plain version (``kernels.flash_attention``) against JAX
``attention()`` and the Pallas ``flash_attention`` in interpret mode.
Covers the evaluator's S = 31, GQA 9/3 and 4/2, window and softcap."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as flash_j
from repro.kernels.ref import flash_attention_ref as flash_ref_j
from repro.models.attention import attention as attention_j
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)
from repro_torch.models.attention import attention

ATOL = 1e-5


def _qkv(B, S, Hq, Hkv, D, seed=0):
    r = np.random.default_rng(seed)
    return tuple(r.normal(size=(B, S, h, D)).astype(np.float32)
                 for h in (Hq, Hkv, Hkv))


CASES = [
    # B, S, Hq, Hkv, D, window, softcap, q_chunk
    (3, 31, 9, 3, 64, 0, 0.0, 32),      # the evaluator's shape (smollm)
    (2, 31, 4, 2, 16, 0, 0.0, 32),      # smoke smollm
    (1, 64, 4, 2, 16, 16, 0.0, 32),     # sliding window, chunked
    (2, 32, 9, 3, 64, 0, 50.0, 32),     # softcap
    (1, 64, 4, 2, 32, 24, 30.0, 16),    # window + softcap, 4 chunks
]


@pytest.mark.parametrize("B,S,Hq,Hkv,D,win,cap,q_chunk", CASES)
def test_model_attention_matches_jax(B, S, Hq, Hkv, D, win, cap, q_chunk):
    q, k, v = _qkv(B, S, Hq, Hkv, D)
    want = attention_j(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=True, window=win, softcap=cap,
                       q_chunk=q_chunk)
    got = attention(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v), causal=True, window=win,
                    softcap=cap, q_chunk=q_chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("B,S,Hq,Hkv,D,win,cap,q_chunk", CASES)
def test_kernel_plain_version_matches_jax(B, S, Hq, Hkv, D, win, cap,
                                          q_chunk):
    q, k, v = _qkv(B, S, Hq, Hkv, D, seed=1)
    qj, kj, vj = (jnp.asarray(a) for a in (q, k, v))
    want_ref = flash_ref_j(qj, kj, vj, causal=True, window=win, softcap=cap)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=True, window=win,
                          softcap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), atol=ATOL)
    if S % q_chunk == 0:        # the Pallas wrapper needs S % block == 0
        want = flash_j(qj, kj, vj, causal=True, window=win, softcap=cap,
                       block_q=q_chunk, block_k=q_chunk, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL)


def test_non_causal_plain_versions_agree():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 40, 6, 2, 16, seed=2))
    a = attention(q, k, v, causal=False, window=0, q_chunk=64)
    b = flash_attention_ref(q, k, v, causal=False)
    torch.testing.assert_close(a, b, atol=ATOL, rtol=0)


def test_kernel_wrapper_rejects_mismatched_shapes():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 4, 2, 16))
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :4], v[:, :4])
    with pytest.raises(ValueError):
        flash_attention(q, k.to(torch.float64), v)
    with pytest.raises(ValueError):
        flash_attention(q[:, :, :3], k, v)
