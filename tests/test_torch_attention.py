"""The port's attention on the CPU against the JAX reference, f32, atol
1e-5 (the two frameworks sum the softmax and the products in different
orders): the model-path chunked attention (``models.attention``) and the
kernel wrapper's plain version (``kernels.flash_attention``) against JAX
``attention()`` and the Pallas ``flash_attention`` in interpret mode.
Covers the evaluator's S = 31, GQA 9/3 and 4/2, window and softcap; and
the gradient: the backward kernel's plain version against ``jax.vjp``
of the reference's oracle, the forward's log-sum-exp, autograd through
the CPU model path, and a row that saw no key; and the forward's shape
rule, ``long_instance`` (which bf16 instance a call on the card
takes), ``short_instance`` and the ``instance`` they name together."""
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
    # gemma2's heads: a window, the softcap, S no multiple of 32 (one
    # chunk: the reference's chunks must divide S)
    (1, 77, 8, 4, 256, 40, 50.0, 128),
    # the Qwen families' packed rows at D 128 and the evaluators' S 31
    # (the short instance on the card): G 5 as qwen2.5's 40/8, G 8 as
    # qwen3-moe's 32/4, G 1 as moonshot's MHA; and G 8 at S 32, which the
    # Pallas kernel's blocks divide
    (2, 31, 10, 2, 128, 0, 0.0, 32),
    (2, 31, 16, 2, 128, 0, 0.0, 32),
    (2, 31, 4, 4, 128, 0, 0.0, 32),
    (1, 32, 16, 2, 128, 0, 0.0, 32),
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


# gemma2-2b's heads (D 256, the warpgroup kernel's 32-position query
# tiles and 64-key work tiles on the card): S around one and two query
# tiles, G 1, 2 and 8, a window that leaves whole 32-position tiles out of
# view, and q scaled by q_mult so that logits of spread ~40 meet the
# softcap of 50 (randn inputs give logits ~1, which it leaves alone).
BWD_CASES_D256 = [
    # B, S, Hq, Hkv, D, window, softcap, q_mult
    (1, 31, 8, 4, 256, 0, 50.0, 40.0),
    (1, 32, 4, 4, 256, 0, 50.0, 40.0),      # G 1
    (1, 33, 8, 1, 256, 0, 50.0, 40.0),      # G 8
    (1, 65, 8, 4, 256, 8, 50.0, 40.0),      # window 8: whole tiles out
    (2, 65, 8, 4, 256, 0, 0.0, 1.0),        # no softcap
]


def _backward_matches_jax_grad(B, S, Hq, Hkv, D, win, cap, q_mult=1.0):
    """The plain backward against ``jax.vjp`` of the reference, each
    gradient within ATOL; with q scaled (``q_mult``), within ATOL times
    its largest magnitude (the scaled q gives gradients of ~1e2, whose
    float32 sums round at ~1e-5 relative). Returns the plain
    gradients."""
    q, k, v, do = _bwd_inputs(B, S, Hq, Hkv, D, seed=3)
    q = q * np.float32(q_mult)
    kw = dict(causal=True, window=win, softcap=cap)
    _, vjp = jax.vjp(lambda a, b, c: flash_ref_j(a, b, c, **kw),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    qt, kt, vt, dot, o, lse = _port_bwd(q, k, v, do, **kw)
    got = flash_attention_bwd_ref(qt, kt, vt, o, lse, dot, **kw)
    for g, w in zip(got, want):
        w = np.asarray(w)
        scale = max(1.0, float(np.abs(w).max())) if q_mult != 1.0 else 1.0
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL * scale)
    # the CPU wrapper takes the plain version and counts no launch
    before = flash_attention_bwd.launches
    for g, w in zip(flash_attention_bwd(qt, kt, vt, o, lse, dot, **kw), got):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert flash_attention_bwd.launches == before
    return got


@pytest.mark.parametrize("B,S,Hq,Hkv,D,win,cap", BWD_CASES)
def test_backward_plain_version_matches_jax_grad(B, S, Hq, Hkv, D, win, cap):
    _backward_matches_jax_grad(B, S, Hq, Hkv, D, win, cap)


@pytest.mark.parametrize("B,S,Hq,Hkv,D,win,cap,q_mult", BWD_CASES_D256)
def test_backward_plain_version_matches_jax_grad_at_d256(B, S, Hq, Hkv, D,
                                                         win, cap, q_mult):
    got = _backward_matches_jax_grad(B, S, Hq, Hkv, D, win, cap, q_mult)
    if cap:
        # the softcap bites: without it dq moves by more than 100 times
        # the tolerance of the comparison above
        uncapped = _backward_matches_jax_grad(B, S, Hq, Hkv, D, win, 0.0,
                                              q_mult)
        moved = float((got[0] - uncapped[0]).abs().max())
        assert moved > 100 * ATOL * max(1.0, float(got[0].abs().max()))


@pytest.mark.parametrize("B,S,Hq,Hkv,D,win,cap",
                         BWD_CASES[:3] + [CASES[-1][:7]])
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


# --- the forward's shape rule: which bf16 instance a call takes ------------
# ``long_instance`` sends bf16 calls from S = LONG_FROM on to the
# warp-specialised wgmma kernel at D 256 (gemma2's heads, with or without
# its window and softcap) and at D 64 or 128 with no window and no
# softcap; all else stays on the mma.sync (GQA-packed) or float32
# kernels. The rule reads S, not the packed rows of a GQA group (S 31 x G
# 5 = 155 rows for qwen2.5's evaluator), so no S 31 evaluator shape moves.

from repro_torch.configs.registry import arch_ids, get_config  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402

EVALUATOR_S = 31                 # the trust evaluators' 32 tokens, causal
TRANSFORMERS = [a for a in arch_ids()
                if getattr(get_config(a), "d_head", None)]


def _layer_windows(cfg):
    """The windows a model's layers call attention with."""
    if cfg.sliding_window and cfg.local_global_pattern:
        return (cfg.sliding_window, 0)
    return (cfg.sliding_window,)


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", TRANSFORMERS)
def test_every_evaluator_shape_keeps_its_instance(arch, smoke):
    """Each transformer of the registry at the trust evaluator's S 31, in
    its compute type, on every layer kind: not the wgmma instance."""
    cfg = get_config(arch, smoke=smoke)
    dtype = getattr(torch, cfg.dtype)
    for window in _layer_windows(cfg):
        assert not FA.long_instance(EVALUATOR_S, cfg.d_head, dtype,
                                    window=window,
                                    softcap=cfg.attn_logit_softcap)


@pytest.mark.parametrize("S", [FA.LONG_FROM, 1984, 4096, 8000])
@pytest.mark.parametrize("D,dtype,window,softcap", [
    (64, torch.float32, 0, 0.0),            # float32
    (128, torch.float32, 0, 0.0),
    (16, torch.bfloat16, 0, 0.0),           # the smoke heads
    (64, torch.bfloat16, 256, 0.0),         # a window
    (128, torch.bfloat16, 0, 30.0),         # a softcap
])
def test_long_sequences_outside_the_rule_keep_their_instance(S, D, dtype,
                                                             window,
                                                             softcap):
    assert not FA.long_instance(S, D, dtype, window=window, softcap=softcap)


def _rule_case(S, D, window=0, softcap=0.0):
    """A case of the rule's test, named as before D 256 joined it."""
    name = f"{S}-{D}" + (f"-{window}-{softcap}" if D == 256 else "")
    return pytest.param(S, D, window, softcap, id=name)


@pytest.mark.parametrize("S,D,window,softcap", [
    _rule_case(4096, 64),                   # smollm's training microbatch
    _rule_case(1984, 64),                   # the decode phase's longest prompt
    _rule_case(FA.LONG_FROM, 64),           # the shortest prefill it takes
    _rule_case(FA.LONG_FROM + 1, 64),
    _rule_case(1000, 64),
    _rule_case(4096, 128),                  # qwen2.5's heads in training
    _rule_case(FA.LONG_FROM, 128),
    # gemma2's heads: no cap, its local layer, its global layer; its
    # training microbatch (4096) and prefills up to the decode phase's 8000
    *(_rule_case(S, 256, window, softcap)
      for window, softcap in ((0, 0.0), (4096, 50.0), (0, 50.0))
      for S in (FA.LONG_FROM, 1984, 4096, 8000)),
])
def test_training_and_prefills_take_the_wgmma_instance(S, D, window,
                                                       softcap):
    kw = dict(window=window, softcap=softcap)
    assert FA.long_instance(S, D, torch.bfloat16, **kw)
    assert not FA.long_instance(S, D, torch.bfloat16,
                                long_from=FA.NEVER_LONG, **kw)


@pytest.mark.parametrize("S", [1, 31, 128, FA.LONG_FROM - 1])
def test_short_prefills_keep_the_mma_sync_instance(S):
    """A prompt shorter than LONG_FROM (the decode phase prefills S
    1..1984) stays where it was faster on the card."""
    assert not FA.long_instance(S, 64, torch.bfloat16)


def test_smollm_training_microbatch_takes_the_wgmma_instance():
    cfg = get_config("smollm-135m")
    assert FA.long_instance(4096, cfg.d_head, getattr(torch, cfg.dtype),
                            window=cfg.sliding_window,
                            softcap=cfg.attn_logit_softcap)


def test_gemma2_training_microbatch_takes_the_wgmma_instance():
    """gemma2-2b's training microbatch (S 4096) on both of its layer
    kinds: the local layers' window of 4096 and the global layers' none,
    each with the softcap of 50."""
    cfg = get_config("gemma2-2b")
    assert cfg.d_head == 256 and cfg.attn_logit_softcap > 0
    for window in _layer_windows(cfg):
        assert FA.long_instance(4096, cfg.d_head, getattr(torch, cfg.dtype),
                                window=window,
                                softcap=cfg.attn_logit_softcap)


# --- the short instance's rule -----------------------------------------------
# ``short_instance`` sends bf16 calls at D 64 and 128 with no window or
# softcap, S at most SHORT_TO and S x G at most SHORT_ROWS packed rows, to
# the persistent TMA-fed kernel: the evaluators' S 31 at smollm's heads
# and the Qwen models'. gemma2's D 256, the smoke heads, float32, windows,
# softcaps and the long sequences keep their instances.

FULL_WIDTH_INSTANCE = {"smollm-135m": "short", "qwen2.5-14b": "short",
                       "qwen3-moe-30b-a3b": "short",
                       "moonshot-v1-16b-a3b": "short",
                       "gemma2-2b": "mma.sync"}


def _kernel_d(d_head):
    """The head size the kernel sees (narrower heads are padded)."""
    return max(d_head, FA.MIN_HEAD_DIM)


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", TRANSFORMERS)
def test_every_evaluator_shape_takes_the_instance_the_rule_names(arch,
                                                                 smoke):
    """Each transformer of the registry at the trust evaluator's S 31, on
    every layer kind: the short instance at full width for smollm and
    the Qwen models, ``mma.sync`` for gemma2's D 256, and the smoke
    heads (float32) the float32 kernel."""
    cfg = get_config(arch, smoke=smoke)
    dtype = getattr(torch, cfg.dtype)
    want = "f32" if smoke else FULL_WIDTH_INSTANCE[arch]
    for window in _layer_windows(cfg):
        assert FA.instance(EVALUATOR_S, cfg.n_heads // cfg.n_kv_heads,
                           _kernel_d(cfg.d_head), dtype, window=window,
                           softcap=cfg.attn_logit_softcap) == want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [16, 64, 128, 256])
def test_short_and_long_instance_are_never_both_true(D, dtype):
    for S in (1, 16, 31, FA.SHORT_TO, FA.SHORT_TO + 1, 64,
              FA.LONG_FROM - 1, FA.LONG_FROM, 4096):
        for G in (1, 3, 5, 8, 9):
            for window, softcap in ((0, 0.0), (100, 0.0), (0, 50.0)):
                kw = dict(window=window, softcap=softcap)
                assert not (FA.long_instance(S, D, dtype, **kw)
                            and FA.short_instance(S, G, D, dtype, **kw))


@pytest.mark.parametrize("G,D", [(3, 64), (5, 128), (8, 128), (1, 128)])
@pytest.mark.parametrize("dtype,window,softcap", [
    (torch.float32, 0, 0.0),             # float32
    (torch.bfloat16, 16, 0.0),           # a window inside S
    (torch.bfloat16, 4096, 0.0),         # a window past S (the rule reads
                                         # the argument, as long_instance)
    (torch.bfloat16, 0, 30.0),           # a softcap
])
def test_float32_windows_and_softcaps_never_take_the_short_instance(
        G, D, dtype, window, softcap):
    assert not FA.short_instance(EVALUATOR_S, G, D, dtype, window=window,
                                 softcap=softcap)
    assert FA.instance(EVALUATOR_S, G, D, dtype, window=window,
                       softcap=softcap) in ("mma.sync", "f32")


@pytest.mark.parametrize("S,G,D,want", [
    (1, 3, 64, True),                    # a one-token prompt
    (31, 3, 64, True),                   # smollm's evaluator: 93 rows
    (31, 5, 128, True),                  # qwen2.5's: 155 rows, 3 tiles
    (31, 8, 128, True),                  # qwen3-moe's: 248 rows, 4 tiles
    (31, 1, 128, True),                  # moonshot's: 31 rows, 1 tile
    (FA.SHORT_TO, 8, 128, True),         # 256 rows: four whole tiles
    (FA.SHORT_TO + 1, 3, 64, False),     # past one key tile
    (31, 9, 64, False),                  # 279 rows: past four tiles
    (29, 9, 128, False),                 # 261 rows
    (31, 4, 256, False),                 # gemma2's D 256
    (31, 2, 16, False),                  # the smoke heads' D 16
])
def test_short_instance_geometry(S, G, D, want):
    assert FA.short_instance(S, G, D, torch.bfloat16) is want
    assert (FA.instance(S, G, D, torch.bfloat16) == "short") is want


@pytest.mark.parametrize("arch", [a for a, i in FULL_WIDTH_INSTANCE.items()
                                  if i == "short"])
def test_the_override_restores_the_mma_sync_instance(arch):
    """``short_to=NEVER_SHORT`` (what a timing passes to ``_forward``
    and ``launch_bf16`` to run the replaced kernel at the same shape)
    sends every evaluator shape back to ``mma.sync``; ``short_to`` at the
    key tile forces the short instance wherever the geometry allows."""
    cfg = get_config(arch)
    G, D = cfg.n_heads // cfg.n_kv_heads, cfg.d_head
    assert not FA.short_instance(EVALUATOR_S, G, D, torch.bfloat16,
                                 short_to=FA.NEVER_SHORT)
    assert FA.instance(EVALUATOR_S, G, D, torch.bfloat16,
                       short_to=FA.NEVER_SHORT) == "mma.sync"
    assert FA.instance(EVALUATOR_S, G, D, torch.bfloat16,
                       long_from=FA.NEVER_LONG,
                       short_to=FA.SHORT_KEYS) == "short"
    # forcing the long instance wins over the short one, as in launch_bf16
    assert FA.instance(EVALUATOR_S, G, D, torch.bfloat16,
                       long_from=0) == "wgmma"


def test_launch_counts_by_instance_name_every_instance():
    """``flash_attention.by_instance`` keeps a count for each name
    ``instance`` returns, and a CPU call counts none."""
    names = {FA.instance(S, G, D, dt) for S in (31, 4096)
             for G in (3,) for D in (64, 256)
             for dt in (torch.bfloat16, torch.float32)}
    assert names == set(flash_attention.by_instance)
    before = dict(flash_attention.by_instance)
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 31, 9, 3, 64))
    flash_attention(q.to(torch.bfloat16), k.to(torch.bfloat16),
                    v.to(torch.bfloat16))
    assert flash_attention.by_instance == before
