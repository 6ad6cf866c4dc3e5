"""Attention forward (causal, sliding window, logit softcap, GQA).

Counterpart of ``repro.kernels.flash_attention``. ``flash_attention``
launches the hand-written CUDA kernel (``csrc/flash_attention.cu``) for
CUDA tensors and takes the plain version ``flash_attention_ref`` only for
CPU tensors. bf16 runs on the tensor cores with the GQA group packed into
the rows of a tile; float32 runs in FP32 FMAs. The kernel accepts any S
(the ragged edge is masked); it takes D of 16 (the smoke-width
evaluators), 64, 128 or 256 (Gemma-2). A head narrower than 16 (the
qwen2.5 smoke config's 12) is zero-padded to 16 and the output cut back:
zero columns add nothing to q k^T, and the padded columns of v are
dropped.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels._build import library_function

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 64, 128, 256)
MIN_HEAD_DIM = 16                        # narrower heads are zero-padded


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, S, Hq, D); k, v: (B, S, Hkv, D) -> (B, S, Hq, D) in q's type.

    CUDA tensors launch the kernel (counted in
    ``flash_attention.launches``); CPU tensors take the plain version.
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, "
                         f"not {q.device}")
    B, S, Hq, D = q.shape
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
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_attention takes D in {_HEAD_DIMS}, got {D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:            # the kernel reads 16-byte chunks
            raise ValueError(f"{name} must be 16-byte aligned")
    fn = library_function(
        "flash_attention", "flash_attention_launch",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float,
           ctypes.c_void_p])
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             B, S, Hq, k.shape[2], D, _DTYPES[q.dtype], float(sm_scale),
             int(causal), int(window), float(softcap), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
