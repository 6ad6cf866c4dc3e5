"""Mixture-of-Experts FFN with top-k routing.

Counterpart of ``repro.models.moe`` (``moe_init``, ``capacity``,
``moe_apply``, ``apply``). Dispatch is sort-based: the (token, choice)
pairs are sorted by expert (a stable sort, as ``jnp.argsort``), each
pair's rank within its expert is its position minus the expert's first
position, and the pairs that fit an expert's capacity are scattered into
a fixed ``(n_experts, capacity, d_model)`` buffer. The grouped
SwiGLU/GeGLU runs as batched matrix products over that buffer. Pairs
past an expert's capacity are dropped from expert compute: their token
keeps only the residual path (and the shared experts).

The weighted combine un-sorts the pairs' outputs to (tokens, top_k,
d_model), a permutation with no repeated index, and sums over top_k in
order: no atomics, so the same inputs give the same bits run after run on
the card (the reference adds them with a scatter-add).

The reference's expert-parallel dispatch (``moe_apply_ep``, selected by
``MoEConfig.dispatch == "ep_shard_map"``) falls back to ``moe_apply``
when no mesh is ambient; the port runs on one card with no mesh, so
``apply`` takes ``moe_apply`` for both modes. ``moe_apply_ep`` waits for
``distribution`` (ROADMAP.md, Queue 1, item 6).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.models import layers as L


def moe_init(d_model: int, cfg: MoEConfig, generator: torch.Generator, *,
             device=None, dtype=torch.float32) -> Dict:
    """The reference's shapes and scales: router ``w`` (d_model, E),
    ``w_gate``/``w_up`` (E, d_model, F), ``w_down`` (E, F, d_model) and,
    with shared experts, one GLU FFN of their summed width."""
    E, F = cfg.n_experts, cfg.d_expert
    std_in, std_out = math.sqrt(1.0 / d_model), math.sqrt(1.0 / F)
    kw = dict(device=device, dtype=dtype)
    p = {
        "router": {"w": L.trunc_normal((d_model, E), std_in, generator,
                                       **kw)},
        "w_gate": L.trunc_normal((E, d_model, F), std_in, generator, **kw),
        "w_up": L.trunc_normal((E, d_model, F), std_in, generator, **kw),
        "w_down": L.trunc_normal((E, F, d_model), std_out, generator, **kw),
    }
    if cfg.n_shared_experts > 0:
        d_sh = (cfg.d_shared or cfg.d_expert) * cfg.n_shared_experts
        p["shared"] = L.glu_ffn_init(d_model, d_sh, generator, **kw)
    return p


def capacity(n_tokens: int, cfg: MoEConfig) -> int:
    """Slots per expert for a call of ``n_tokens`` tokens (every token of
    the call, padding included), rounded up to a multiple of 8."""
    c = int(math.ceil(cfg.capacity_factor * cfg.top_k * n_tokens
                      / cfg.n_experts))
    return max(8, ((c + 7) // 8) * 8)


def moe_apply(p: Dict, x: torch.Tensor, cfg: MoEConfig, *,
              act: str = "silu", compute_dtype=torch.bfloat16
              ) -> Tuple[torch.Tensor, Dict]:
    """x: (T, D) flattened tokens -> (out (T, D), metrics): the router's
    load-balance loss ``moe_aux_loss`` and the dropped fraction of
    (token, choice) pairs ``moe_drop_frac``."""
    T, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = capacity(T, cfg)
    xc = x.to(compute_dtype)

    # router in float32
    logits = x.to(torch.float32) @ p["router"]["w"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                      # (T, E)
    topk_w, topk_idx = torch.topk(probs, K, dim=-1)            # (T, K)
    if cfg.norm_topk_prob:
        topk_w = topk_w / topk_w.sum(dim=-1, keepdim=True).clamp(min=1e-9)

    # sort-based dispatch plan
    flat_e = topk_idx.reshape(T * K)
    sorted_e, sort_idx = torch.sort(flat_e, stable=True)       # group by e
    seg_start = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos_in_e = torch.arange(T * K, device=x.device) - seg_start
    token_of = sort_idx // K
    keep = pos_in_e < C
    safe_pos = torch.where(keep, pos_in_e, torch.full_like(pos_in_e, C))

    # expert buffer (E, C, D); dropped pairs land in a spare slot C
    buf = torch.zeros((E, C + 1, D), dtype=compute_dtype, device=x.device)
    buf[sorted_e, safe_pos] = xc[token_of]
    buf = buf[:, :C]

    # grouped expert GLU
    g = torch.bmm(buf, p["w_gate"].to(compute_dtype))          # (E, C, F)
    u = torch.bmm(buf, p["w_up"].to(compute_dtype))
    out_buf = torch.bmm(L.glu(g, u, act), p["w_down"].to(compute_dtype))

    # weighted combine: un-sort to (T, K, D), sum over K in order; a
    # dropped pair reads a clamped slot (as the reference's gather) and
    # weighs 0
    flat_w = topk_w.reshape(T * K)[sort_idx]
    contrib = out_buf[sorted_e, safe_pos.clamp(max=C - 1)] * (
        flat_w * keep)[:, None].to(compute_dtype)
    unsorted = torch.empty_like(contrib)
    unsorted[sort_idx] = contrib
    out = unsorted.reshape(T, K, D).sum(dim=1)

    if "shared" in p:
        out = out + L.glu_ffn_apply(p["shared"], xc, act=act,
                                    compute_dtype=compute_dtype)

    me = probs.mean(dim=0)                                     # (E,)
    routed = torch.zeros((T, E), dtype=torch.float32, device=x.device)
    routed.scatter_(1, topk_idx, 1.0)                          # one-hot sum
    ce = routed.mean(dim=0) / K                                # frac routed
    aux = cfg.router_aux_loss * E * (me * ce).sum()
    dropped = 1.0 - keep.sum() / (T * K)
    return out.to(x.dtype), {"moe_aux_loss": aux,
                             "moe_drop_frac": dropped.to(torch.float32)}


def apply(p: Dict, x: torch.Tensor, cfg: MoEConfig, *, act: str = "silu",
          compute_dtype=torch.bfloat16) -> Tuple[torch.Tensor, Dict]:
    """Dispatch-mode switch (``MoEConfig.dispatch``): both modes run
    ``moe_apply`` on one card (see the module note)."""
    return moe_apply(p, x, cfg, act=act, compute_dtype=compute_dtype)
