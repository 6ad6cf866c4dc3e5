"""Attention (causal, sliding window, logit softcap, GQA) and its gradient.

Counterpart of ``repro.kernels.flash_attention``. ``flash_attention``
launches the hand-written CUDA kernel (``csrc/flash_attention.cu``) for
CUDA tensors and takes the plain version ``flash_attention_ref`` only for
CPU tensors. Where grad is enabled and an input requires it, a CUDA call
goes through ``FlashAttentionFn``: its forward also writes each row's
log-sum-exp, and its backward launches ``flash_attention_bwd``
(``csrc/flash_attention_bwd.cu``; plain version
``flash_attention_bwd_ref``). The JAX package differentiates its jnp
attention with ``jax.grad`` and has no backward kernel; the port's
forward on the card is a kernel, so its gradient is one too; in bf16 (D
16, 64, 128 and 256) it is one warp-specialised ``wgmma`` kernel between
a pre-pass and a post-pass. The forward's bf16 has three instances,
chosen by two shape rules (``instance`` names the one a call takes):
``long_instance`` sends long sequences (training, prefills) at D 64 or
128 with no window or softcap, and at D 256 with or without gemma2's
window and softcap, to a warp-specialised ``wgmma`` kernel on TMA
stages; ``short_instance`` sends the evaluators' S 31 at D 64 and 128
with no window or softcap (smollm's heads and the Qwen models') to a
persistent kernel that streams one (batch row, KV head) pair after
another through a TMA ring, the pair's GQA group packed into its rows,
on ``wgmma``; the rest (D 16, D 256 at S 31, prefills from S 33 to
``LONG_FROM``, D 64 and 128 with a window or a softcap) run on
``mma.sync`` with the GQA group packed into the rows of a tile. float32
runs in FP32 FMAs. The kernel accepts any S (the ragged edge is masked); it takes D of
16 (the smoke-width evaluators), 64, 128 or 256 (Gemma-2). A head narrower than 16 (the
qwen2.5 smoke config's 12) is zero-padded to 16 and the output cut back:
zero columns add nothing to q k^T, and the padded columns of v are
dropped.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels._build import (fake_launch, is_fake,
                                        library_function, misaligned,
                                        refuse_grad)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 64, 128, 256)
MIN_HEAD_DIM = 16                        # narrower heads are zero-padded
# S from which ``long_instance`` sends a call to the wgmma instance: where
# it was never slower than the mma.sync instance on an H100 (PERF.md).
LONG_FROM = 256
# A ``long_from`` no S reaches: the mma.sync instance for every shape.
NEVER_LONG = 0x7fffffff
# S up to which ``short_instance`` sends a call to the persistent
# TMA-fed instance: where it was never slower than the mma.sync instance
# on an H100 (PERF.md). Its pairs' keys fit one tile of SHORT_KEYS and
# their packed rows (S x G) four 64-row tiles, SHORT_ROWS.
SHORT_KEYS = 32
SHORT_ROWS = 256
SHORT_TO = 32
# A ``short_to`` no S stays within: no call takes the short instance.
NEVER_SHORT = 0


def long_instance(S: int, D: int, dtype: torch.dtype, *, window: int = 0,
                  softcap: float = 0.0, long_from: int = LONG_FROM) -> bool:
    """Whether a forward call takes the warp-specialised ``wgmma``
    instance: bf16, causal or not, S (positions, not the packed rows of a
    GQA group) at least ``long_from``, and either D 256 (gemma2's heads,
    with or without its window and softcap) or D 64 or 128 with no window
    and no softcap (no path runs those at a long S). ``launch_bf16`` in
    ``csrc/flash_attention.cu`` applies the same rule to the
    ``long_from`` it is passed. A shape rule, not a fallback: a call it
    sends to either instance launches it or raises."""
    return (dtype == torch.bfloat16 and S >= long_from
            and (D == 256 or (D in (64, 128) and window <= 0
                              and softcap <= 0.0)))


def short_instance(S: int, G: int, D: int, dtype: torch.dtype, *,
                   window: int = 0, softcap: float = 0.0,
                   short_to: int = SHORT_TO) -> bool:
    """Whether a forward call that ``long_instance`` does not take goes
    to the persistent TMA-fed instance: bf16, D 64 or 128, no window and
    no softcap, causal or not, S at most ``short_to`` (and one key tile,
    SHORT_KEYS) and the S x G packed rows of a (batch row, KV head) pair
    within SHORT_ROWS. The evaluators' S 31 at smollm's (G 3) and the Qwen
    models' heads (G 5, 8, 1). ``launch_bf16`` applies the same rule to
    the ``short_to`` it is passed, after the long one. A shape rule, not a
    fallback: a call it sends there launches it or raises."""
    return (dtype == torch.bfloat16 and D in (64, 128) and window <= 0
            and softcap <= 0.0 and 1 <= S <= min(short_to, SHORT_KEYS)
            and S * G <= SHORT_ROWS)


def instance(S: int, G: int, D: int, dtype: torch.dtype, *,
             window: int = 0, softcap: float = 0.0,
             long_from: int = LONG_FROM, short_to: int = SHORT_TO) -> str:
    """The forward instance a call launches: ``"wgmma"`` (long
    sequences), ``"short"`` (the persistent TMA-fed one), ``"mma.sync"``
    (every other bf16 call) or ``"f32"``, by the rules above in the order
    ``launch_bf16`` applies them. D is the kernel's (a padded head's)."""
    if dtype != torch.bfloat16:
        return "f32"
    kw = dict(window=window, softcap=softcap)
    if long_instance(S, D, dtype, long_from=long_from, **kw):
        return "wgmma"
    if short_instance(S, G, D, dtype, short_to=short_to, **kw):
        return "short"
    return "mma.sync"


def pad_head_dim(*ts: torch.Tensor):
    """Each tensor's last axis zero-padded to ``MIN_HEAD_DIM`` if it is
    narrower (an exact change for attention: see the module note)."""
    D = ts[0].shape[-1]
    if D >= MIN_HEAD_DIM:
        return ts
    return tuple(F.pad(t, (0, MIN_HEAD_DIM - D)) for t in ts)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """Plain version: full attention in float32 (the reference's
    ``kernels.ref.flash_attention_ref``). q: (B,S,Hq,D); k,v: (B,S,Hkv,D).
    Rows that see no key write zeros, as the kernel does."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    if sm_scale is None:
        sm_scale = D ** -0.5
    qg = q.reshape(B, S, Hkv, G, D).to(torch.float32)
    s = torch.einsum("bshgd,bthd->bhgst", qg, k.to(torch.float32)) * sm_scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(S, device=q.device)
    ok = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        ok &= pos[None, :] <= pos[:, None]
    if window > 0:
        ok &= pos[None, :] > pos[:, None] - window
    s = s.masked_fill(~ok, float("-inf"))
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)
    o = torch.einsum("bhgst,bthd->bshgd", p, v.to(torch.float32))
    return o.reshape(B, S, Hq, D).to(q.dtype)


def _scores(q, k, b, causal, window, softcap, sm_scale):
    """Batch row ``b``'s float32 scores after scale and softcap, t (Hkv,
    G, S, S), and the mask of (query, key) pairs a row sees."""
    S, Hq, D = q.shape[1:]
    Hkv = k.shape[2]
    qg = q[b].reshape(S, Hkv, Hq // Hkv, D).to(torch.float32)
    t = torch.einsum("shgd,thd->hgst", qg, k[b].to(torch.float32)) * sm_scale
    if softcap > 0.0:
        t = softcap * torch.tanh(t / softcap)
    pos = torch.arange(S, device=q.device)
    ok = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        ok &= pos[None, :] <= pos[:, None]
    if window > 0:
        ok &= pos[None, :] > pos[:, None] - window
    return qg, t, ok


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                            causal: bool = True, window: int = 0,
                            softcap: float = 0.0,
                            sm_scale: Optional[float] = None
                            ) -> torch.Tensor:
    """Plain version of the forward's second output: each row's natural
    log-sum-exp of its scaled, softcapped, masked scores, (B, Hq, S)
    float32; ``-inf`` for a row that sees no key."""
    B, S, Hq, D = q.shape
    if sm_scale is None:
        sm_scale = D ** -0.5
    out = []
    for b in range(B):
        _, t, ok = _scores(q, k, b, causal, window, softcap, sm_scale)
        out.append(torch.logsumexp(t.masked_fill(~ok, float("-inf")),
                                   dim=-1).reshape(Hq, S))
    return torch.stack(out)


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                            window: int = 0, softcap: float = 0.0,
                            sm_scale: Optional[float] = None):
    """Plain version of the backward: (dq, dk, dv) of the attention
    ``o`` = softmax(t) v, t the scaled and softcapped scores, from the
    forward's ``o`` and ``lse`` (B, Hq, S) and the output gradient ``do``,
    in explicit float32 formulas, one batch row at a time:

        P = exp(t - lse) on the pairs a row sees, Di = rowsum(do * o),
        dv = P^T do, dP = do v^T, dT = P (dP - Di),
        dS = dT (1 - (t / softcap)^2) with a softcap, else dT,
        dq = scale dS k, dk = scale dS^T q,

    dk and dv summed over the G query heads of their KV head. A row with
    ``lse == -inf`` (it saw no key) gives and gets no gradient. Returns
    each in its input's dtype."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    if sm_scale is None:
        sm_scale = D ** -0.5
    dq, dk, dv = [], [], []
    for b in range(B):
        qg, t, ok = _scores(q, k, b, causal, window, softcap, sm_scale)
        lse_b = lse[b].reshape(Hkv, G, S, 1).to(torch.float32)
        ok = ok & torch.isfinite(lse_b)
        p = torch.where(ok, torch.exp(t - torch.where(ok, lse_b, 0.0)), 0.0)
        dog = do[b].reshape(S, Hkv, G, D).to(torch.float32)
        og = o[b].reshape(S, Hkv, G, D).to(torch.float32)
        di = (dog * og).sum(-1).permute(1, 2, 0)[..., None]   # (Hkv,G,S,1)
        dv.append(torch.einsum("hgst,shgd->thd", p, dog))
        dp = torch.einsum("shgd,thd->hgst", dog, v[b].to(torch.float32))
        ds = p * (dp - di)
        if softcap > 0.0:
            ds = ds * (1.0 - (t / softcap).square())
        dq.append(torch.einsum("hgst,thd->shgd", ds,
                               k[b].to(torch.float32)).reshape(S, Hq, D)
                  * sm_scale)
        dk.append(torch.einsum("hgst,shgd->thd", ds, qg) * sm_scale)
    return (torch.stack(dq).to(q.dtype), torch.stack(dk).to(k.dtype),
            torch.stack(dv).to(v.dtype))


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B,S,Hq,D) and k, v (B,S,Hkv,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, Hq, D = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != D:
        raise ValueError(f"k, v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if Hq % k.shape[2]:
        raise ValueError(f"{Hq} query heads do not group over "
                         f"{k.shape[2]} KV heads")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must share q's dtype and device")


def _kernel_args(name: str, *ts: torch.Tensor):
    """Type, contiguity and alignment checks of a kernel's tensors."""
    if ts[0].dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, got "
                        f"{ts[0].dtype}")
    D = ts[0].shape[-1]
    if D not in _HEAD_DIMS:
        raise ValueError(f"{name} takes D in {_HEAD_DIMS}, got {D}")
    for t in ts:
        if not t.is_contiguous():
            raise ValueError(f"{name}: every tensor must be contiguous")
        if misaligned(t):                # the kernels read 16-byte chunks
            raise ValueError(f"{name}: every tensor must be 16-byte "
                             f"aligned")


def seen_pairs(S: int, causal: bool, window: int) -> int:
    """(query, key) pairs a head sees in a sequence of S positions."""
    if not causal:
        return S * S if window <= 0 else sum(
            min(S, i + window) - max(0, i - window + 1) for i in range(S))
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def cost(B: int, S: int, Hq: int, Hkv: int, D: int, size: int, *,
         causal: bool = True, window: int = 0, lse: bool = False,
         backward: bool = False):
    """(operations, bytes) of one call over the (query, key) pairs that
    the causal window leaves. The forward: QK^T and PV (two products of
    2 D operations a pair and head), q, k, v read and o written, and with
    ``lse`` the (B, Hq, S) float32 lse written. The backward: five
    products (S, dP, dV, dQ, dK), q, o, do read and dq written, k and v
    read and dk, dv written, and the lse read."""
    pairs = seen_pairs(S, causal, window)
    q_el, kv_el = B * S * Hq * D, 2 * B * S * Hkv * D
    lse_bytes = 4 * B * Hq * S
    if backward:
        return (10 * B * Hq * D * pairs,
                size * (4 * q_el + 2 * kv_el) + lse_bytes)
    return (4 * B * Hq * D * pairs,
            size * (2 * q_el + kv_el) + (lse_bytes if lse else 0))


def _forward(q, k, v, causal, window, softcap, sm_scale, lse=None,
             long_from: int = LONG_FROM, short_to: int = SHORT_TO):
    """One launch of the forward kernel; writes ``lse`` (B, Hq, S) float32
    where one is given. ``long_from``: the S from which ``long_instance``
    takes the wgmma instance (``NEVER_LONG``: never); ``short_to``: the S
    up to which ``short_instance`` takes the short one (``NEVER_SHORT``:
    never). A timing compares the instances with them."""
    _kernel_args("flash_attention", q, k, v)
    B, S, Hq, D = q.shape
    if is_fake(q, k, v):
        fake_launch("flash_attention", *cost(
            B, S, Hq, k.shape[2], D, q.element_size(), causal=causal,
            window=window, lse=lse is not None))
        return torch.empty_like(q)
    fn = library_function(
        "flash_attention", "flash_attention_launch",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float,
           ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             None if lse is None else lse.data_ptr(),
             B, S, Hq, k.shape[2], D, _DTYPES[q.dtype], float(sm_scale),
             int(causal), int(window), float(softcap), int(long_from),
             int(short_to), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    flash_attention.launches += 1
    flash_attention.by_instance[instance(
        S, Hq // k.shape[2], D, q.dtype, window=window, softcap=softcap,
        long_from=long_from, short_to=short_to)] += 1
    return out


class FlashAttentionFn(torch.autograd.Function):
    """The kernel pair as one differentiable op on CUDA tensors: the
    forward kernel (writing the row log-sum-exp beside ``o``), and
    ``flash_attention_bwd`` for the gradient. D must be a kernel's head
    dimension (``flash_attention`` pads narrower heads first)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, sm_scale):
        B, S, Hq, _ = q.shape
        lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
        o = _forward(q, k, v, causal, window, softcap, sm_scale, lse)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap,
                        sm_scale=sm_scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         **ctx.opts)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, S, Hq, D); k, v: (B, S, Hkv, D) -> (B, S, Hq, D) in q's type.

    CUDA tensors launch the kernel (counted in
    ``flash_attention.launches``), through ``FlashAttentionFn`` where grad
    is enabled and an input requires it; CPU tensors take the plain
    version (and autograd differentiates it).
    """
    _check(q, k, v)
    if q.device.type == "cpu" and not is_fake(q, k, v):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, sm_scale=sm_scale)
    if q.device.type != "cuda" and not is_fake(q, k, v):
        raise ValueError(f"flash_attention runs on cuda or cpu, "
                         f"not {q.device}")
    D = q.shape[-1]
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if sm_scale is None:
        sm_scale = D ** -0.5
    if D < MIN_HEAD_DIM:
        qp, kp, vp = pad_head_dim(q, k, v)
        return flash_attention(qp, kp, vp, causal=causal, window=window,
                               softcap=softcap,
                               sm_scale=sm_scale)[..., :D].contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, causal, window, softcap,
                                      sm_scale)
    return _forward(q, k, v, causal, window, softcap, sm_scale)


flash_attention.launches = 0
# the same launches by the instance that ran them (``instance``)
flash_attention.by_instance = {"wgmma": 0, "short": 0, "mma.sync": 0,
                               "f32": 0}


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0, softcap: float = 0.0,
                        sm_scale: Optional[float] = None):
    """Gradient of ``flash_attention``: (dq, dk, dv) in the inputs' type
    from q, k, v, the forward's ``o`` and ``lse`` (B, Hq, S) float32, and
    ``do`` (B, S, Hq, D). CUDA tensors launch the backward kernels,
    counted once a call in ``flash_attention_bwd.launches``: in bf16 a
    pre-pass (Di and the lse in log2 units), one persistent warpgroup
    kernel (the five products, each score's exp once, dq added into a
    float32 workspace in a fixed order; at D 16 two independent pipelines
    a block, one a consumer warpgroup) and a post-pass (dq to the input's
    type); in float32 the ``rowsum(do * o)`` pass, the dk/dv kernel and
    the dq kernel. CPU tensors take ``flash_attention_bwd_ref``."""
    _check(q, k, v)
    B, S, Hq, D = q.shape
    if sm_scale is None:
        sm_scale = D ** -0.5
    kw = dict(causal=causal, window=window, softcap=softcap,
              sm_scale=sm_scale)
    if q.device.type == "cpu" and not is_fake(q, k, v, do):
        return flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    if q.device.type != "cuda" and not is_fake(q, k, v, do):
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu, not "
                         f"{q.device}")
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q's shape, dtype and "
                             f"device")
    if lse.shape != (B, Hq, S) or lse.dtype != torch.float32 \
            or lse.device != q.device:
        raise ValueError(f"lse must be ({B}, {Hq}, {S}) float32 on "
                         f"{q.device}")
    _kernel_args("flash_attention_bwd", q, k, v, o, do)
    refuse_grad("flash_attention_bwd", q, k, v, o, lse, do)
    if not lse.is_contiguous():
        raise ValueError("flash_attention_bwd: lse must be contiguous")
    if is_fake(q, k, v, o, lse, do):
        fake_launch("flash_attention_bwd", *cost(
            B, S, Hq, k.shape[2], D, q.element_size(), causal=causal,
            window=window, backward=True))
        return tuple(torch.empty_like(t) for t in (q, k, v))
    fn = library_function(
        "flash_attention_bwd", "flash_attention_bwd_launch",
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float,
           ctypes.c_void_p])
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    work = torch.empty(workspace_bytes(B, S, Hq, D, q.dtype),
                       dtype=torch.uint8, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), work.data_ptr(), B, S, Hq, k.shape[2], D,
             _DTYPES[q.dtype], float(sm_scale), int(causal), int(window),
             float(softcap), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: "
                           f"cudaError {err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


def workspace_bytes(B: int, S: int, Hq: int, D: int,
                    dtype: torch.dtype) -> int:
    """Bytes of the float32 workspace one backward call takes: for bf16
    (the warpgroup kernel, every D) the dq accumulator (B, S, Hq, D), Di
    and the lse padded to whole query tiles (64 positions; 32 at D 256),
    the counters of the ordered adds and the work-tile dispenser; for
    float32 Di (B, Hq, S)."""
    return library_function(
        "flash_attention_bwd", "flash_attention_bwd_workspace_bytes",
        [ctypes.c_int] * 5, restype=ctypes.c_longlong)(
        B, S, Hq, D, _DTYPES[dtype])
