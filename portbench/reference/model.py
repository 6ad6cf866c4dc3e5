"""Plain PyTorch reference of the trust evaluator (no kernel, no cache,
no batching of its own): a decoder-only transformer as the published
configurations describe it, in float32, scoring each document by the
mean log-probability of its tokens squashed to [0, trust_scale].

    x = E[t_0..t_{S-2}]
    per layer: h = rms(x)(1 + g1); q, k, v = h Wq, h Wk, h Wv; rotary on
      q, k (half split); causal GQA softmax(q k^T / sqrt(Dh)) v; x += o Wo;
      h = rms(x)(1 + g2); x += SwiGLU(h) or the MoE layer
    lp = mean_i log softmax(rms(x_i)(1 + g) U)[t_{i+1}]
    trust = sigmoid(lp + log V) * trust_scale

The MoE layer routes each token to the top-k experts of a softmax over
the router's logits (weights renormalised to sum to 1) and, as the
configuration assumes, keeps for each expert only the first
``capacity`` (token, choice) pairs in token-major order (choices by
falling weight); a dropped pair adds nothing.

``precision="fp8"`` is the control: every matrix product, attention's
two included, takes its operands rounded to float8 e4m3 with one scale
a tensor, accumulating in float32.

It runs layer by layer over the whole set of rows, casting one layer's
weights to float32 at a time, so that a model whose float32 copy does
not fit beside its served weights still fits. Imports nothing of the
system under test.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

F8_MAX = 448.0


def _q8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor (its amax
    mapped to the format's largest), as a float8 inference path scales."""
    s = x.abs().amax().clamp(min=1e-12) / F8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def _mm(x: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    """x (..., d_in) @ w (d_in, d_out), in float32 or from float8
    operands."""
    if fp8:
        x, w = _q8(x), _q8(w)
    return x @ w


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + _f32(scale))


def rotary(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions 0..S-1; the half-split convention."""
    S, D = x.shape[1], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                        device=x.device) / D))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * inv[None]
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    a, b = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], -1)


def attention(q, k, v, fp8: bool = False) -> torch.Tensor:
    """Causal GQA: q (B, S, Hq, D), k/v (B, S, Hkv, D) -> (B, S, Hq, D);
    query head h reads key head h // (Hq / Hkv)."""
    if fp8:
        q, k, v = _q8(q), _q8(k), _q8(v)
    B, S, Hq, D = q.shape
    G = Hq // k.shape[2]
    k = k.repeat_interleave(G, dim=2)
    v = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(D)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, -1)
    return torch.einsum("bhqk,bkhd->bqhd", _q8(p) if fp8 else p, v)


def expert_capacity(n_tokens: int, m: Dict) -> int:
    """Slots per expert of a call of ``n_tokens`` tokens: ceil(cf * k *
    T / E) rounded up to a multiple of 8, at least 8."""
    c = math.ceil(m["capacity_factor"] * m["num_experts_per_tok"]
                  * n_tokens / m["num_experts"])
    return max(8, -(-c // 8) * 8)


def moe(p: Dict, h: torch.Tensor, m: Dict, fp8: bool) -> torch.Tensor:
    """h: (T, d) -> (T, d): top-k routing with capacity drops, one expert
    at a time (its weights cast to float32 alone)."""
    T, d = h.shape
    E, K = m["num_experts"], m["num_experts_per_tok"]
    probs = torch.softmax(_mm(h, _f32(p["router"]["w"]), fp8), -1)
    w, e = torch.topk(probs, K, dim=-1)
    if m["norm_topk_prob"]:
        w = w / w.sum(-1, keepdim=True)
    C = expert_capacity(T, m)
    flat = e.reshape(-1)
    order = torch.argsort(flat, stable=True)      # pairs by expert, in order
    counts = torch.bincount(flat, minlength=E).tolist()
    tok = torch.arange(T, device=h.device).repeat_interleave(K)
    wflat = w.reshape(-1)
    out = torch.zeros(T, d, dtype=torch.float32, device=h.device)
    lo = 0
    for ex in range(E):
        kept = order[lo:lo + min(counts[ex], C)]    # the expert's first C
        lo += counts[ex]
        if not len(kept):
            continue
        x = h[tok[kept]]
        g = _mm(x, _f32(p["w_gate"][ex]), fp8)
        u = _mm(x, _f32(p["w_up"][ex]), fp8)
        y = _mm(torch.nn.functional.silu(g) * u, _f32(p["w_down"][ex]), fp8)
        out.index_add_(0, tok[kept], y * wflat[kept, None])
    return out


def ffn(p: Dict, h: torch.Tensor, fp8: bool) -> torch.Tensor:
    g = _mm(h, _f32(p["gate"]["w"]), fp8)
    u = _mm(h, _f32(p["up"]["w"]), fp8)
    return _mm(torch.nn.functional.silu(g) * u, _f32(p["down"]["w"]), fp8)


@torch.no_grad()
def trust_scores(tree: Dict, m: Dict, tokens: torch.Tensor,
                 trust_scale: float, precision: str = "fp32",
                 vocab_rows: int = 4096) -> torch.Tensor:
    """(B,) trust of each row of ``tokens`` (B, S+1), all rows of one
    evaluator call (the MoE layer's capacity couples them)."""
    fp8 = precision == "fp8"
    if precision not in ("fp32", "fp8"):
        raise ValueError(f"unknown precision {precision!r}")
    eps = m["rms_norm_eps"]
    hq, hkv, dh = (m["num_attention_heads"], m["num_key_value_heads"],
                   m["head_dim"])
    inp, tgt = tokens[:, :-1].long(), tokens[:, 1:].long()
    B, S = inp.shape
    x = _f32(tree["embed"]["table"][inp])
    for bp in tree["blocks"]:
        a = bp["attn"]
        h = rms(x, bp["ln1"]["scale"], eps)
        q = _mm(h, _f32(a["wq"]["w"]), fp8).view(B, S, hq, dh)
        k = _mm(h, _f32(a["wk"]["w"]), fp8).view(B, S, hkv, dh)
        v = _mm(h, _f32(a["wv"]["w"]), fp8).view(B, S, hkv, dh)
        o = attention(rotary(q, m["rope_theta"]), rotary(k, m["rope_theta"]),
                      v, fp8)
        x = x + _mm(o.reshape(B, S, hq * dh), _f32(a["wo"]["w"]), fp8)
        h = rms(x, bp["ln2"]["scale"], eps)
        if "moe" in bp:
            x = x + moe(bp["moe"], h.reshape(B * S, -1), m, fp8).view(
                B, S, -1)
        else:
            x = x + ffn(bp["ffn"], h, fp8)
    x = rms(x, tree["final_norm"]["scale"], eps).reshape(B * S, -1)
    t = tgt.reshape(-1)
    lp = torch.empty(B * S, dtype=torch.float32, device=x.device)
    head = (_f32(tree["embed"]["table"]).T if m["tie_word_embeddings"]
            else _f32(tree["unembed"]["w"]))
    for lo in range(0, B * S, vocab_rows):
        logits = _mm(x[lo:lo + vocab_rows], head, fp8)
        lp[lo:lo + vocab_rows] = torch.log_softmax(logits, -1).gather(
            -1, t[lo:lo + vocab_rows, None])[:, 0]
    mean_lp = lp.view(B, S).mean(-1)
    return torch.sigmoid(mean_lp + math.log(m["vocab_size"])) * trust_scale


def set_exact_float32() -> None:
    """Matrix products in true float32 (TF32 off) on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
