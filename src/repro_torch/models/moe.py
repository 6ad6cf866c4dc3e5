"""Mixture-of-Experts FFN with top-k routing.

Counterpart of ``repro.models.moe`` (``moe_init``, ``capacity``,
``moe_apply``, ``_local_dispatch_compute``, ``moe_apply_ep``,
``apply``). Dispatch is sort-based: the (token, choice)
pairs are sorted by expert (a stable sort, as ``jnp.argsort``), each
pair's rank within its expert is its position minus the expert's first
position, and the pairs that fit an expert's capacity are scattered into
a fixed ``(n_experts, capacity, d_model)`` buffer. The grouped
SwiGLU/GeGLU runs as batched matrix products over that buffer. Pairs
past an expert's capacity are dropped from expert compute: their token
keeps only the residual path (and the shared experts).

The weighted combine reads each (token, choice) slot's row of the
expert output in the original slot order, weighs it by its gate (0 when
dropped) and sums over top_k in order: no atomics, so the same inputs
give the same bits run after run on the card (the reference adds them
with a scatter-add). ``_local_dispatch_compute`` is that dispatch for
one rank's experts; ``moe_apply`` calls it with every expert and the
whole call's capacity.

Expert parallelism (``moe_apply_ep``, selected by ``MoEConfig.dispatch
== "ep_shard_map"``): with a mesh ambient (``distribution.constraints.
use_mesh``) the expert weights are pieces over the ``model`` axis
(``distribution.sharding``'s EP rule) and the tokens are this rank's
rows, replicated over ``model``. Each rank dispatches its tokens to its
own E/n_model experts with the capacity of its own rows, and the partial
outputs combine in the original slot order, then with one sum over
``model``. The router, its aux loss and the shared experts run outside
that region; the router's means are taken over every DP rank's rows, as
the reference's global means. With no mesh, or no ``model`` axis, it is
``moe_apply``. On a mesh of one rank it makes ``moe_apply``'s call of the
dispatch: the same bits.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.distribution.placement import (all_gather, all_reduce,
                                                batch_axes, split)
from repro_torch.models import layers as L
from repro_torch.tracing import span, traced


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
              act: str = "silu", compute_dtype=torch.bfloat16,
              with_metrics: bool = True) -> Tuple[torch.Tensor, Dict]:
    """x: (T, D) flattened tokens -> (out (T, D), metrics): the router's
    load-balance loss ``moe_aux_loss`` and the dropped fraction of
    (token, choice) pairs ``moe_drop_frac`` ({} without
    ``with_metrics``: scoring reads neither)."""
    T, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = capacity(T, cfg)

    probs, topk_w, topk_idx = _router(p, x, cfg)               # float32
    # every expert on this rank (pieces gathered whole: this dispatch
    # sees every token's every choice)
    wg, wu, wd = (_whole(p[n]) for n in ("w_gate", "w_up", "w_down"))
    out = _local_dispatch_compute(x, topk_w, topk_idx, wg, wu, wd,
                                  e_offset=0, e_local=E, capacity_local=C,
                                  act=act, compute_dtype=compute_dtype)
    if "shared" in p:
        out = out + _shared_apply(p["shared"], x.to(compute_dtype), act,
                                  compute_dtype)
    if not with_metrics:
        return out.to(x.dtype), {}
    # pairs kept: each expert keeps its first C
    kept = L._counts(topk_idx.reshape(T * K), E).clamp(max=C).sum()
    aux = _aux_loss(probs, topk_idx, cfg)
    dropped = 1.0 - kept / (T * K)
    return out.to(x.dtype), {"moe_aux_loss": aux,
                             "moe_drop_frac": dropped.to(torch.float32)}


def _whole(w) -> torch.Tensor:
    """An expert weight whole on this rank (its pieces gathered when it
    is sharded)."""
    local, sh = split(w)
    return local if sh is None else all_gather(local, sh.axes, sh.dim)


@traced("moe.experts")
def _shared_apply(p: Dict, x: torch.Tensor, act: str,
                  compute_dtype) -> torch.Tensor:
    """The shared experts' GLU FFN; ``gate``/``up`` may be column pieces
    and ``down`` row pieces (summed over their axes)."""
    loc = {k: {n: split(w)[0] for n, w in d.items()} for k, d in p.items()}
    _, sh = split(p["down"]["w"])
    if sh is None:
        return L.glu_ffn_apply(loc, x, act=act, compute_dtype=compute_dtype)
    g = L.dense_apply(loc["gate"], x, compute_dtype)
    u = L.dense_apply(loc["up"], x, compute_dtype)
    return all_reduce(L.dense_apply(loc["down"], L.glu(g, u, act),
                                    compute_dtype), sh.axes)


def _router(p: Dict, x: torch.Tensor, cfg: MoEConfig):
    """(probs (T, E), top-k weights, top-k expert ids), in float32."""
    with span("moe.router"):
        logits = x.to(torch.float32) @ p["router"]["w"].to(torch.float32)
        probs = torch.softmax(logits, dim=-1)
        topk_w, topk_idx = torch.topk(probs, cfg.top_k, dim=-1)
        if cfg.norm_topk_prob:
            topk_w = topk_w / topk_w.sum(dim=-1, keepdim=True).clamp(
                min=1e-9)
    return probs, topk_w, topk_idx


def _aux_loss(probs: torch.Tensor, topk_idx: torch.Tensor,
              cfg: MoEConfig) -> torch.Tensor:
    """Switch-style load-balance loss. Where the batch rows are split
    over DP ranks (``placement.batch_split``) and a gradient is taken,
    the router's mean probability ``me`` and routed fraction ``ce`` are
    averaged over them before their product, so that every rank trains
    on the global batch's loss; scoring without grad reads no aux loss
    and keeps the local means (no collective)."""
    T, E = probs.shape
    me = probs.mean(dim=0)                                     # (E,)
    routed = torch.zeros((T, E), dtype=torch.float32, device=probs.device)
    routed.scatter_(1, topk_idx, 1.0)                          # one-hot sum
    ce = routed.mean(dim=0) / cfg.top_k                        # frac routed
    dp = batch_axes() if torch.is_grad_enabled() else ()
    if dp:
        n_dp = math.prod(a.size for a in dp)
        me = all_reduce(me, dp) / n_dp
        ce = all_reduce(ce, dp) / n_dp
    return cfg.router_aux_loss * E * (me * ce).sum()


def _dispatch_plan(topk_idx: torch.Tensor, e_offset: int, e_local: int,
                   capacity_local: int):
    """The sort-based plan of this rank's experts: pairs sorted by local
    expert id (a stable sort; other ranks' experts last), each pair's
    rank within its expert, and whether it is kept. Returns (sort_idx,
    sorted_e, pos_in_e, keep, flat_e local ids)."""
    n = topk_idx.numel()
    flat_e = topk_idx.reshape(n) - e_offset                    # local ids
    mine = (flat_e >= 0) & (flat_e < e_local)
    sort_key = torch.where(mine, flat_e, torch.full_like(flat_e, e_local))
    sorted_e, sort_idx = torch.sort(sort_key, stable=True)
    seg_start = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos_in_e = torch.arange(n, device=topk_idx.device) - seg_start
    keep = (sorted_e < e_local) & (pos_in_e < capacity_local)
    return sort_idx, sorted_e, pos_in_e, keep, flat_e


def slot_keep(topk_idx: torch.Tensor, e_offset: int, e_local: int,
              capacity_local: int) -> torch.Tensor:
    """Which (token, choice) slots (T, K) this rank's experts keep: the
    keep set in the original slot order."""
    sort_idx, _, _, keep, _ = _dispatch_plan(topk_idx, e_offset, e_local,
                                             capacity_local)
    out = torch.zeros_like(keep)
    out[sort_idx] = keep
    return out.reshape(topk_idx.shape)


def _local_dispatch_compute(x_loc, topk_w, topk_idx, wg, wu, wd, *,
                            e_offset, e_local, capacity_local, act,
                            compute_dtype):
    """Dispatch local tokens to local experts. x_loc: (T, D); topk_*:
    (T, K); w*: (E_loc, D, F) / (E_loc, F, D). Returns the (T, D)
    partial output of this rank's experts.

    The combine runs in the original slot order: each slot reads its
    expert's output row and weighs it by its gate (0 when dropped or
    routed to another rank), and the K slots of a token are summed in
    order, as the reference's (no device-varying gather of the gates)."""
    T, D = x_loc.shape
    K = topk_idx.shape[1]
    C = capacity_local
    with span("moe.dispatch"):
        sort_idx, sorted_e, pos_in_e, keep, flat_e = _dispatch_plan(
            topk_idx, e_offset, e_local, C)
        token_of = sort_idx // K
        safe_e = torch.where(keep, sorted_e,
                             torch.full_like(sorted_e, e_local))
        safe_pos = torch.where(keep, pos_in_e, torch.full_like(pos_in_e, C))
        xc = x_loc.to(compute_dtype)
        # dropped and foreign pairs land in a spare expert row and slot
        buf = torch.zeros((e_local + 1, C + 1, D), dtype=compute_dtype,
                          device=x_loc.device)
        buf[safe_e, safe_pos] = xc[token_of]
        buf = buf[:e_local, :C]
    with span("moe.experts"):
        g = torch.bmm(buf, wg.to(compute_dtype))               # (E, C, F)
        u = torch.bmm(buf, wu.to(compute_dtype))
        out_buf = torch.bmm(L.glu(g, u, act), wd.to(compute_dtype))
    with span("moe.combine"):
        inv_pos = torch.empty_like(pos_in_e)
        inv_pos[sort_idx] = pos_in_e
        inv_keep = torch.empty_like(keep)
        inv_keep[sort_idx] = keep
        vals = out_buf[flat_e.clamp(0, e_local - 1),
                       inv_pos.clamp(0, C - 1)]
        w_flat = topk_w.reshape(T * K) * inv_keep
        return (vals * w_flat[:, None].to(compute_dtype)).reshape(
            T, K, D).sum(dim=1)


def moe_apply_ep(p: Dict, x: torch.Tensor, cfg: MoEConfig, *,
                 act: str = "silu", compute_dtype=torch.bfloat16,
                 with_metrics: bool = True) -> Tuple[torch.Tensor, Dict]:
    """Expert-parallel MoE over the ambient mesh's ``model`` axis (see
    the module note). x: (T, D) this rank's tokens -> (out (T, D),
    metrics). Falls back to ``moe_apply`` when no mesh (or no ``model``
    axis) is ambient. Where the batch is not split over DP ranks (a
    batch-1 decode, or rows that do not divide), every rank dispatches
    the whole batch with its capacity: the keep sets of ``moe_apply``.
    ``moe_drop_frac`` is 0, as the reference's; without
    ``with_metrics`` the metrics are {}."""
    from repro_torch.distribution.constraints import ambient_mesh

    mesh = ambient_mesh()
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return moe_apply(p, x, cfg, act=act, compute_dtype=compute_dtype,
                         with_metrics=with_metrics)
    T, D = x.shape
    E = cfg.n_experts
    wg, sh = split(p["w_gate"])
    wu, wd = split(p["w_up"])[0], split(p["w_down"])[0]
    e_local = wg.shape[0]
    e_offset = 0 if sh is None else sh.offset
    # this rank's rows: T = T_global / n_dp, capacity(T_global / n_dp)
    c_local = capacity(T, cfg)

    probs, topk_w, topk_idx = _router(p, x, cfg)
    out = _local_dispatch_compute(
        x, topk_w, topk_idx, wg, wu, wd, e_offset=e_offset,
        e_local=e_local, capacity_local=c_local, act=act,
        compute_dtype=compute_dtype)
    if sh is not None:
        out = all_reduce(out, sh.axes)
    if "shared" in p:
        out = out + _shared_apply(p["shared"], x.to(compute_dtype), act,
                                  compute_dtype)
    if not with_metrics:
        return out.to(x.dtype), {}
    aux = _aux_loss(probs, topk_idx, cfg)
    return out.to(x.dtype), {"moe_aux_loss": aux,
                             "moe_drop_frac": torch.zeros(
                                 (), dtype=torch.float32, device=x.device)}


def apply(p: Dict, x: torch.Tensor, cfg: MoEConfig, *, act: str = "silu",
          compute_dtype=torch.bfloat16, with_metrics: bool = True
          ) -> Tuple[torch.Tensor, Dict]:
    """Dispatch-mode switch (``MoEConfig.dispatch``)."""
    fn = moe_apply_ep if cfg.dispatch == "ep_shard_map" else moe_apply
    return fn(p, x, cfg, act=act, compute_dtype=compute_dtype,
              with_metrics=with_metrics)
