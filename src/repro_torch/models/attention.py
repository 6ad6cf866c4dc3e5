"""GQA attention: full sequences (prefill, the evaluator's forward) and
one-token decode against a KV cache.

Counterpart of ``repro.models.attention`` (``attention``,
``decode_attention``, ``update_kv_cache``). Shapes are ``(batch, seq,
heads, d_head)``; grouped-query attention keeps the KV heads grouped (no
KV repeat).

On CUDA tensors ``attention`` runs the hand-written flash kernel
(``kernels.flash_attention``, differentiable through its backward
kernel) and ``decode_attention`` the flash-decode kernel
(``kernels.flash_decode``), as on fake tensors (a trace: the kernels'
fake branches); on CPU tensors they run the plain forms
below, the torch twins of the reference's jnp paths.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels._build import is_fake
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import NEG_INF, flash_decode


def _chunk(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lo: int,
           kv_hi: int, C: int, *, scale: float, causal: bool, window: int,
           softcap: float) -> torch.Tensor:
    """One query chunk (B, C, Hkv, G, D) over keys [0, kv_hi) in (C, C)
    blocks, carrying (max, denom, acc) in float32."""
    B, _, Hkv, G, D = qg.shape
    q_pos = torch.arange(lo, lo + C, device=qg.device)
    m = torch.full((B, Hkv, G, C, 1), float("-inf"), device=qg.device)
    l = torch.zeros((B, Hkv, G, C, 1), device=qg.device)
    acc = torch.zeros((B, Hkv, G, C, D), device=qg.device)
    for k0 in range(0, kv_hi, C):
        k_blk, v_blk = k[:, k0:k0 + C], v[:, k0:k0 + C]
        s = torch.einsum("bshgd,bthd->bhgst", qg.to(torch.float32),
                         k_blk.to(torch.float32)) * scale
        if softcap > 0.0:
            s = softcap * torch.tanh(s / softcap)
        k_pos = torch.arange(k0, k0 + k_blk.shape[1], device=qg.device)
        ok = torch.ones((C, k_blk.shape[1]), dtype=torch.bool,
                        device=qg.device)
        if causal:
            ok &= k_pos[None, :] <= q_pos[:, None]
        if window > 0:
            ok &= k_pos[None, :] > q_pos[:, None] - window
        s = s.masked_fill(~ok, float("-inf"))
        m_n = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        m_use = torch.where(torch.isinf(m_n), torch.zeros_like(m_n), m_n)
        p = torch.exp(s - m_use)                  # masked entries -> 0
        corr = torch.exp(m - m_use)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum(
            "bhgst,bthd->bhgsd", p.to(v_blk.dtype),
            v_blk).to(torch.float32)
        m = m_n
    out = acc / torch.where(l > 0, l, torch.ones_like(l))
    return out.to(qg.dtype).permute(0, 3, 1, 2, 4)    # (B, C, Hkv, G, D)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, softcap: float = 0.0,
              scale: Optional[float] = None,
              q_chunk: int = 1024) -> torch.Tensor:
    """Full (prefill, training) attention. q: (B, S, Hq, D); k, v: (B, S,
    Hkv, D). Returns (B, S, Hq, D). On CUDA the flash kernel, whose
    gradient is the backward kernel; on the CPU ``chunked_attention``,
    which autograd differentiates."""
    if q.is_cuda or is_fake(q):
        return flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=causal, window=window,
                               softcap=softcap, sm_scale=scale)
    return chunked_attention(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale, q_chunk=q_chunk)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      softcap: float = 0.0, scale: Optional[float] = None,
                      q_chunk: int = 1024) -> torch.Tensor:
    """The plain form of ``attention`` on any device: the torch twin of
    the reference's jnp online-softmax attention, ``q_chunk`` query rows
    at a time in float32."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    qg = q.reshape(B, S, Hkv, G, D)
    kw = dict(scale=scale, causal=causal, window=window, softcap=softcap)
    if S <= q_chunk:
        out = _chunk(qg, k, v, 0, S, S, **kw)
    else:
        if S % q_chunk:
            raise ValueError(f"S={S} must be a multiple of "
                             f"q_chunk={q_chunk}")
        outs = []
        for lo in range(0, S, q_chunk):
            kv_hi = lo + q_chunk if causal else S
            outs.append(_chunk(qg[:, lo:lo + q_chunk], k, v, lo, kv_hi,
                               q_chunk, **kw))
        out = torch.cat(outs, dim=1)
    return out.reshape(B, S, Hq, D)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     window: int = 0, softcap: float = 0.0,
                     scale: Optional[float] = None,
                     return_lse: bool = False):
    """One-token attention against a KV cache.

    q: (B, Hq, D); k_cache, v_cache: (B, L, Hkv, D); lengths: (B,) int32,
    the valid cache positions *including* the new token (written at
    lengths - 1). Returns (B, Hq, D), and with ``return_lse`` the (B, Hq)
    float32 log-sum-exp of the scores each head saw (-inf where none). A
    row with no valid position gives zeros on both devices (the TPU
    kernel's behaviour; the reference's jnp form gives the mean of V
    there)."""
    if q.is_cuda or is_fake(q):
        return flash_decode(q.contiguous(), k_cache, v_cache,
                            lengths.to(torch.int32).contiguous(),
                            window=window, softcap=softcap, sm_scale=scale,
                            return_lse=return_lse)
    B, L, Hkv, D = k_cache.shape
    G = q.shape[1] // Hkv
    if scale is None:
        scale = D ** -0.5
    qg = q.reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bthd->bhgt", qg.to(torch.float32),
                     k_cache.to(torch.float32)) * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(L, device=q.device)
    lens = lengths.to(torch.int64)[:, None]
    ok = pos[None, :] < lens                               # (B, L)
    if window > 0:
        ok &= pos[None, :] > lens - 1 - window
    s = s.masked_fill(~ok[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1) * ok.any(-1)[:, None, None, None]
    out = torch.einsum("bhgt,bthd->bhgd", p.to(v_cache.dtype), v_cache)
    out = out.reshape(B, Hkv * G, D).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(s, dim=-1).reshape(B, Hkv * G)
    return out, torch.where(ok.any(-1)[:, None], lse,
                            torch.full_like(lse, float("-inf")))


def update_kv_cache(k_cache: torch.Tensor, v_cache: torch.Tensor,
                    k_new: torch.Tensor, v_new: torch.Tensor,
                    write_pos: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write one new (k, v) per sequence at per-row positions, **in
    place** (the reference returns new arrays; a cache of gigabytes is
    not copied per token). Returns the same two tensors.

    k_cache: (B, L, Hkv, D); k_new: (B, Hkv, D); write_pos: (B,) integer.
    A position outside [0, L) writes nothing, as the reference's
    ``mode="drop"``: such rows rewrite their clamped slot with its own
    value, so the device never sees an out-of-range index and the host
    never waits for one."""
    B, L = k_cache.shape[:2]
    rows = torch.arange(B, device=k_cache.device)
    pos = write_pos.to(torch.int64)
    keep = ((pos >= 0) & (pos < L))[:, None, None]
    at = pos.clamp(0, L - 1)
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        cache[rows, at] = torch.where(keep, new.to(cache.dtype),
                                      cache[rows, at])
    return k_cache, v_cache
