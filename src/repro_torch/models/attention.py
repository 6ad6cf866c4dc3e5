"""GQA attention for full sequences (the evaluator's forward).

Counterpart of ``repro.models.attention.attention``. Shapes are
``(batch, seq, heads, d_head)``; grouped-query attention keeps the KV
heads grouped (no KV repeat).

On CUDA tensors ``attention`` runs the hand-written flash kernel
(``kernels.flash_attention``); on CPU tensors it runs the plain chunked
online-softmax form below, the torch twin of the reference's jnp path.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import flash_attention


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
    """Full (prefill) attention. q: (B, S, Hq, D); k, v: (B, S, Hkv, D).
    Returns (B, S, Hq, D)."""
    if q.is_cuda:
        return flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=causal, window=window,
                               softcap=softcap, sm_scale=scale)
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
