"""One-token decode attention against a KV cache (GQA, window, softcap).

Counterpart of ``repro.kernels.flash_decode``. ``lengths`` counts each
row's valid positions including the newest token (already in the
cache); position t of row b is seen when ``t < lengths[b]`` and, with
``window > 0``, ``t >= lengths[b] - window``. A row that sees no
position (``lengths[b] == 0``) gives zeros, as the TPU kernel does
(the reference's ``flash_decode_ref`` gives the mean of V there).
With ``return_lse`` each (row, query head) also gets the log-sum-exp of
the scaled (and capped) scores it saw, in float32, -inf where it saw
none: a decode whose cache's sequence is sharded over ranks merges the
ranks' partial outputs with it (``models.transformer``). The kernel
writes it from its combine pass, an instance chosen by a template flag,
so the serving calls run the same code as before.

``flash_decode`` launches the hand-written CUDA kernel
(``csrc/flash_decode.cu``, replacing the TPU kernel ``_decode_kernel``:
split-K flash-decoding over pieces of ``piece_length`` positions of each
row's valid range, walked by a persistent grid, then a combine pass;
bound by the bytes of the valid cache) for CUDA tensors, and takes the plain
version ``flash_decode_ref`` only for CPU tensors.
The kernel takes bf16 or f32, D of 16, 32, 64, 128 or 256, and up to 8
query heads per KV head; a head narrower than 16 is zero-padded to 16
and the output cut back, as ``flash_attention`` does.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels._build import (fake_launch, is_fake,
                                        library_function, misaligned,
                                        refuse_grad)
from repro_torch.kernels.flash_attention import MIN_HEAD_DIM, pad_head_dim

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_GROUP = 8
MIN_PIECE = 32                  # positions: a piece is whole 32-row tiles
NEG_INF = -2.0e38


def flash_decode_ref(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     window: int = 0, softcap: float = 0.0,
                     sm_scale: Optional[float] = None,
                     return_lse: bool = False):
    """Plain version: the reference's ``kernels.ref.flash_decode_ref`` in
    float32, except that a row with no visible position gives zeros (and
    an lse of -inf)."""
    B, L, Hkv, D = k_cache.shape
    Hq = q.shape[1]
    G = Hq // Hkv
    if sm_scale is None:
        sm_scale = D ** -0.5
    qg = q.reshape(B, Hkv, G, D).to(torch.float32)
    s = torch.einsum("bhgd,bthd->bhgt", qg,
                     k_cache.to(torch.float32)) * sm_scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(L, device=q.device)
    lens = lengths.to(torch.int64)[:, None]
    ok = pos[None, :] < lens
    if window > 0:
        ok &= pos[None, :] > lens - 1 - window
    s = s.masked_fill(~ok[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1) * ok.any(-1)[:, None, None, None]
    o = torch.einsum("bhgt,bthd->bhgd", p, v_cache.to(torch.float32))
    o = o.reshape(B, Hq, D).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.logsumexp(s, dim=-1).reshape(B, Hq)
    return o, torch.where(ok.any(-1)[:, None], lse,
                          torch.full_like(lse, float("-inf")))


def piece_length(B: int, Hkv: int, L: int, dtype: torch.dtype,
                 D: int) -> int:
    """Positions per piece of a row's valid range for this shape on the
    current card (a multiple of 32, at most 256): about two pieces per
    resident warp if every row were full."""
    n = library_function("flash_decode", "flash_decode_piece_len",
                         [ctypes.c_int] * 5)(B, Hkv, L, _DTYPES[dtype], D)
    if n <= 0:
        raise RuntimeError(f"flash_decode_piece_len failed: cudaError {-n}")
    return n


def _check(q, k_cache, v_cache, lengths) -> None:
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"q must be (B,Hq,D) and the caches (B,L,Hkv,D); "
                         f"got {tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    B, L, Hkv, D = k_cache.shape
    if q.shape[0] != B or q.shape[2] != D or q.shape[1] % Hkv:
        raise ValueError(f"q {tuple(q.shape)} does not match the cache "
                         f"{tuple(k_cache.shape)}")
    if lengths.shape != (B,):
        raise ValueError(f"lengths must be ({B},), got "
                         f"{tuple(lengths.shape)}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must share q's dtype and device")
    if lengths.device != q.device:
        raise ValueError("lengths must be on q's device")


def cost(B: int, Hq: int, Hkv: int, D: int, size: int, seen: int,
         return_lse: bool = False):
    """(operations, bytes) of one call that sees ``seen`` cache positions
    in all its rows: the k and v rows of those positions read, q read, o
    written, the lengths and, with ``return_lse``, the lse; QK^T and PV
    over them for every query head. A card run counts the positions its
    lengths leave visible, a trace (whose lengths are data) every
    position of the cache."""
    flops = 4 * seen * Hq * D
    n_bytes = (seen * Hkv * D * 2 * size + 2 * B * Hq * D * size + 4 * B
               + (4 * B * Hq if return_lse else 0))
    return flops, n_bytes


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, lengths: torch.Tensor, *,
                 window: int = 0, softcap: float = 0.0,
                 sm_scale: Optional[float] = None,
                 return_lse: bool = False):
    """q: (B, Hq, D); caches: (B, L, Hkv, D); lengths: (B,) int32.
    Returns (B, Hq, D) in q's type, and with ``return_lse`` also the
    (B, Hq) float32 log-sum-exp of the module note.

    CUDA tensors launch the kernel (counted in ``flash_decode.launches``,
    once per call); CPU tensors take the plain version. Fake tensors pass
    the launch's checks and report ``cost`` instead of launching.
    """
    _check(q, k_cache, v_cache, lengths)
    fake = is_fake(q, k_cache, v_cache, lengths)
    if q.device.type == "cpu" and not fake:
        return flash_decode_ref(q, k_cache, v_cache, lengths, window=window,
                                softcap=softcap, sm_scale=sm_scale,
                                return_lse=return_lse)
    if q.device.type != "cuda" and not fake:
        raise ValueError(f"flash_decode runs on cuda or cpu, not {q.device}")
    refuse_grad("flash_decode", q, k_cache, v_cache)
    B, L, Hkv, D = k_cache.shape
    G = q.shape[1] // Hkv
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_decode takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if sm_scale is None:
        sm_scale = D ** -0.5
    if D < MIN_HEAD_DIM:
        qp, kp, vp = pad_head_dim(q, k_cache, v_cache)
        out = flash_decode(qp, kp, vp, lengths, window=window,
                           softcap=softcap, sm_scale=sm_scale,
                           return_lse=return_lse)
        if return_lse:
            return out[0][..., :D].contiguous(), out[1]
        return out[..., :D].contiguous()
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_decode takes D in {_HEAD_DIMS}, got {D}")
    if G > MAX_GROUP:
        raise ValueError(f"flash_decode takes up to {MAX_GROUP} query heads "
                         f"per KV head, got {G}")
    if lengths.dtype != torch.int32:
        raise TypeError(f"lengths must be int32, got {lengths.dtype}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if misaligned(t):                # the kernel reads 16-byte chunks
            raise ValueError(f"{name} must be 16-byte aligned")
    # the piece length is the card's (its SM count); a trace takes the
    # shortest, which gives the most pieces a card could need
    piece = MIN_PIECE if fake else piece_length(B, Hkv, L, q.dtype, D)
    max_pieces = -(-L // piece)
    if max(B * Hkv * max_pieces, B * q.shape[1]) >= 2 ** 31:
        raise ValueError(f"flash_decode takes fewer than 2**31 pieces and "
                         f"(row, head) pairs, got B={B}, Hkv={Hkv}, "
                         f"{max_pieces} pieces per row")
    if fake:
        fake_launch("flash_decode", *cost(B, q.shape[1], Hkv, D,
                                          q.element_size(), B * L,
                                          return_lse))
        o = torch.empty_like(q)
        return (o, torch.empty(q.shape[:2], dtype=torch.float32,
                               device=q.device)) if return_lse else o
    fn = library_function(
        "flash_decode", "flash_decode_launch",
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
        + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    dev = q.device
    # partial state of every piece a row could have (the worst case)
    part_ml = torch.empty((2, B, Hkv, max_pieces, G), dtype=torch.float32,
                          device=dev)
    part_acc = torch.empty((B, Hkv, max_pieces, G, D), dtype=torch.float32,
                           device=dev)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=dev) \
        if return_lse else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             lengths.data_ptr(), part_ml[0].data_ptr(), part_ml[1].data_ptr(),
             part_acc.data_ptr(), out.data_ptr(),
             None if lse is None else lse.data_ptr(), B, L, Hkv, G, D, piece,
             max_pieces, _DTYPES[q.dtype], float(sm_scale), int(window),
             float(softcap), stream)
    if err != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: "
                           f"cudaError {err}")
    flash_decode.launches += 1
    return (out, lse) if return_lse else out


flash_decode.launches = 0
