"""The port's attention on the CPU against the JAX reference, f32, atol
1e-5 (the two frameworks sum the softmax and the products in different
orders): the model-path chunked attention (``models.attention``) and the
kernel wrapper's plain version (``kernels.flash_attention``) against JAX
``attention()`` and the Pallas ``flash_attention`` in interpret mode.
Covers the evaluator's S = 31, GQA 9/3 and 4/2, window and softcap; and
the gradient: the backward kernel's plain version against ``jax.vjp``
of the reference's oracle, the forward's log-sum-exp, autograd through
the CPU model path, and a row that saw no key."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as flash_j
from repro.kernels.ref import flash_attention_ref as flash_ref_j
from repro.models.attention import attention as attention_j
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_ref,
                                                 flash_attention_lse_ref,
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


# --- the gradient: the backward kernel's plain version ---------------------
# ``flash_attention_bwd_ref`` against ``jax.vjp`` of the reference's
# ``kernels.ref.flash_attention_ref`` with a seeded output gradient,
# float32, atol 1e-5 on dq, dk, dv (both sum in other orders).

BWD_CASES = [
    # B, S, Hq, Hkv, D, window, softcap
    (2, 31, 9, 3, 64, 0, 0.0),          # the evaluator's GQA 9/3, D 64
    (2, 24, 4, 2, 16, 0, 0.0),          # smoke heads, D 16
    (1, 40, 4, 2, 16, 8, 0.0),          # window
    (1, 33, 4, 1, 64, 0, 2.0),          # softcap that bites, G 4
    (2, 32, 4, 2, 16, 12, 5.0),         # window + softcap
]


def _bwd_inputs(B, S, Hq, Hkv, D, seed):
    q, k, v = _qkv(B, S, Hq, Hkv, D, seed=seed)
    do = np.random.default_rng(seed + 7).normal(
        size=(B, S, Hq, D)).astype(np.float32)
    return q, k, v, do


def _port_bwd(q, k, v, do, **kw):
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    o = flash_attention_ref(qt, kt, vt, **kw)
    lse = flash_attention_lse_ref(qt, kt, **kw)
    return qt, kt, vt, dot, o, lse


@pytest.mark.parametrize("B,S,Hq,Hkv,D,win,cap", BWD_CASES)
def test_backward_plain_version_matches_jax_grad(B, S, Hq, Hkv, D, win, cap):
    q, k, v, do = _bwd_inputs(B, S, Hq, Hkv, D, seed=3)
    kw = dict(causal=True, window=win, softcap=cap)
    _, vjp = jax.vjp(lambda a, b, c: flash_ref_j(a, b, c, **kw),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    qt, kt, vt, dot, o, lse = _port_bwd(q, k, v, do, **kw)
    got = flash_attention_bwd_ref(qt, kt, vt, o, lse, dot, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    # the CPU wrapper takes the plain version and counts no launch
    before = flash_attention_bwd.launches
    for g, w in zip(flash_attention_bwd(qt, kt, vt, o, lse, dot, **kw), got):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert flash_attention_bwd.launches == before


@pytest.mark.parametrize("B,S,Hq,Hkv,D,win,cap", BWD_CASES[:3])
def test_lse_plain_version_matches_jax(B, S, Hq, Hkv, D, win, cap):
    q, k, _, _ = _bwd_inputs(B, S, Hq, Hkv, D, seed=4)
    G = Hq // Hkv
    s = jnp.einsum("bshgd,bthd->bhgst", jnp.asarray(q).reshape(
        B, S, Hkv, G, D), jnp.asarray(k)) * D ** -0.5
    if cap:
        s = cap * jnp.tanh(s / cap)
    pos = jnp.arange(S)
    ok = pos[None, :] <= pos[:, None]
    if win:
        ok &= pos[None, :] > pos[:, None] - win
    want = jax.scipy.special.logsumexp(jnp.where(ok, s, -jnp.inf), axis=-1)
    got = flash_attention_lse_ref(torch.from_numpy(q), torch.from_numpy(k),
                                  causal=True, window=win, softcap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(
        B, Hq, S), atol=ATOL)


@pytest.mark.parametrize("B,S,Hq,Hkv,D,win,cap,q_chunk", CASES)
def test_model_attention_gradient_is_the_backward(B, S, Hq, Hkv, D, win,
                                                  cap, q_chunk):
    """Autograd through the CPU model path (``chunked_attention``) gives
    the gradient the backward kernel's plain version computes."""
    q, k, v, do = _bwd_inputs(B, S, Hq, Hkv, D, seed=5)
    kw = dict(causal=True, window=win, softcap=cap)
    qt, kt, vt, dot, o, lse = _port_bwd(q, k, v, do, **kw)
    want = flash_attention_bwd_ref(qt, kt, vt, o, lse, dot, **kw)
    leaves = [t.clone().requires_grad_(True) for t in (qt, kt, vt)]
    out = attention(*leaves, q_chunk=q_chunk, **kw)
    out.backward(dot)
    for t, w in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), w.numpy(), atol=ATOL)


def test_a_row_that_saw_no_key_gives_and_gets_no_gradient():
    """No causal or windowed mask leaves a row without a key (each row
    sees its own position), so the backward meets such a row only
    through its ``lse`` of -inf (what the forward writes for it): its dq
    is zero and it adds nothing to dk and dv, as if its output gradient
    were zero."""
    q, k, v, do = _bwd_inputs(1, 16, 4, 2, 16, seed=6)
    kw = dict(causal=True, window=4, softcap=0.0)
    qt, kt, vt, dot, o, lse = _port_bwd(q, k, v, do, **kw)
    lse_dead = lse.clone()
    lse_dead[0, 1, 9] = float("-inf")
    dq, dk, dv = flash_attention_bwd_ref(qt, kt, vt, o, lse_dead, dot, **kw)
    do_dead = dot.clone()
    do_dead[0, 9, 1] = 0.0
    dq0, dk0, dv0 = flash_attention_bwd_ref(qt, kt, vt, o, lse, do_dead,
                                            **kw)
    assert torch.isfinite(dq).all() and float(dq[0, 9, 1].abs().max()) == 0
    torch.testing.assert_close(dk, dk0, atol=1e-6, rtol=0)
    torch.testing.assert_close(dv, dv0, atol=1e-6, rtol=0)
    keep = torch.ones_like(dq, dtype=torch.bool)
    keep[0, 9, 1] = False
    torch.testing.assert_close(dq[keep], dq0[keep], atol=1e-6, rtol=0)
