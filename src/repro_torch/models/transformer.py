"""Decoder-only transformer: the trust evaluators' forward.

Counterpart of ``repro.models.transformer`` for every LM config of the
reference, all driven by ``TransformerConfig``:
- GQA with RoPE and an optional QKV bias (qwen2.5);
- SwiGLU or GeGLU FFN, or an MoE FFN (``models.moe``: qwen3-moe,
  moonshot), with ``first_k_dense`` leading dense layers in
  ``dense_blocks``;
- gemma2's extras: alternating local (sliding-window) and global layers,
  attention and final logit softcaps, pre and post RMSNorm, the
  sqrt(d_model) embedding scale and the query pre-attention scalar;
- tied or untied (``unembed``) output embeddings.

The full-sequence forward and scoring head, the training loss
(``lm_loss``), and the KV-cache path (``init_kv_cache``, ``prefill``,
``decode_step``). Layers run in a Python loop over lists of block dicts.
Training keeps the weights in ``param_dtype`` (float32 master weights)
and casts them to ``dtype`` inside the forward, as the reference does;
with ``cfg.remat`` each block runs under ``torch.utils.checkpoint``
(the reference's ``jax.checkpoint``) whenever its input requires grad.

Parameters are nested dicts of tensors with the reference's names and
``(d_in, d_out)`` dense weights; :func:`params_from_jax` converts a JAX
parameter pytree (as numpy arrays) into this form.

Tensor parallel scoring (``serving.evaluators.make_sharded_evaluator``):
a weight may be a DTensor sharded by ``distribution.sharding``'s rules
over a mesh axis of more than one rank. Each rank then computes on its
own pieces, Megatron style, with explicit collectives where the
reference constrains: ``wq``/``wk``/``wv`` by columns (this rank's
heads), ``wo`` by rows and an all-reduce; ``gate``/``up`` by columns,
``down`` by rows and an all-reduce; a tied embedding by vocab rows (a
masked local lookup, then an all-reduce) and an untied one by columns
(an all-gather); vocab-sharded logits in the score take a cross-shard
log-sum-exp. When the model axis does not divide the KV heads, q/k/v
are gathered before attention and each rank takes its rows of ``wo``
after it. Plain tensors (and DTensors on a mesh of one device) take the
replicated code unchanged. The sharded path covers the whole model: the
score, the loss (its collectives carry gradients,
``distribution.placement``), the MoE layers (``models.moe.
moe_apply_ep``), ``prefill`` and ``decode_step``. With ``seq_axes`` the
KV cache holds this rank's piece of the sequence for every head (the
reference's SP layout, ``distribution.sharding.lm_batch_specs``):
``prefill`` keeps its piece, and ``decode_step`` writes the new token
where it falls, attends over its piece, and merges the ranks' partial
outputs by their log-sum-exps.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import TransformerConfig
from repro_torch.distribution.constraints import recompute_context
from repro_torch.distribution.placement import (all_gather, all_reduce,
                                                flat_coord, split)
from repro_torch.kernels import score_head as SH
from repro_torch.kernels._build import is_fake
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.tracing import span

# float32 logits the scoring head materializes at once: 256 sequences of
# S 31 at smollm's vocab of 49152 (1.56 GB), which is 1,523 positions at
# gemma2's vocab of 256000.
SCORE_LOGIT_BYTES = 256 * 31 * 49152 * 4


def _block_init(cfg: TransformerConfig, generator: torch.Generator, kw,
                moe_layer: bool, d_ff: int) -> Dict:
    d, Hq, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    bias = dict(bias=cfg.qkv_bias, **kw)
    p = {
        "ln1": L.rmsnorm_init(d, **kw),
        "ln2": L.rmsnorm_init(d, **kw),
        "attn": {
            "wq": L.dense_init(d, Hq * Dh, generator, **bias),
            "wk": L.dense_init(d, Hkv * Dh, generator, **bias),
            "wv": L.dense_init(d, Hkv * Dh, generator, **bias),
            "wo": L.dense_init(Hq * Dh, d, generator, **kw,
                               std=math.sqrt(1.0 / (Hq * Dh))
                               / math.sqrt(2.0 * cfg.n_layers)),
        },
    }
    if cfg.post_norm:
        p["ln1_post"] = L.rmsnorm_init(d, **kw)
        p["ln2_post"] = L.rmsnorm_init(d, **kw)
    if moe_layer:
        p["moe"] = M.moe_init(d, cfg.moe, generator, **kw)
    else:
        p["ffn"] = L.glu_ffn_init(d, d_ff, generator, **kw)
    return p


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device=None, dtype: Optional[torch.dtype] = None) -> Dict:
    """Seeded init with the reference's shapes and scales (not its
    numbers: torch and JAX draw different bits from a seed). Built in
    ``dtype`` (default ``cfg.param_dtype``), one float32 draw at a time:
    a 30 B model is built straight in bf16 on the card."""
    dt = dtype or L.dtype_of(cfg.param_dtype)
    kw = dict(device=device, dtype=dt)
    first_dense = _first_dense(cfg)
    params: Dict = {"embed": L.embed_init(cfg.vocab_size, cfg.d_model,
                                          generator, **kw)}
    if first_dense:
        params["dense_blocks"] = [
            _block_init(cfg, generator, kw, False, cfg.moe.d_ff_dense)
            for _ in range(first_dense)]
    params["blocks"] = [
        _block_init(cfg, generator, kw, cfg.moe is not None, cfg.d_ff)
        for _ in range(cfg.n_layers - first_dense)]
    params["final_norm"] = L.rmsnorm_init(cfg.d_model, **kw)
    if not cfg.tie_embeddings:
        params["unembed"] = L.dense_init(cfg.d_model, cfg.vocab_size,
                                         generator, **kw)
    return params


def params_from_jax(params, cfg: TransformerConfig, device=None) -> Dict:
    """The reference's parameter pytree (leaves as numpy arrays) as the
    port's tensors: ``embed``, ``unembed``, ``final_norm``, the
    ``dense_blocks`` list and ``blocks``, with every subtree a block
    holds (q/k/v biases, ``ln*_post``, ``moe``). ``blocks`` may be the
    stacked form (one dict whose leaves carry a leading layer axis:
    ``scan_layers=True``) or a list of per-layer dicts
    (``scan_layers=False``)."""
    def layer(tree, i):
        if isinstance(tree, dict):
            return {k: layer(v, i) for k, v in tree.items()}
        return tree[i]

    out = L.to_tensors({k: v for k, v in params.items() if k != "blocks"},
                       device)
    blocks = params["blocks"]
    n_blocks = cfg.n_layers - _first_dense(cfg)
    if isinstance(blocks, dict):                     # stacked: (L, ...)
        blocks = [layer(blocks, i) for i in range(n_blocks)]
    if len(blocks) != n_blocks:
        raise ValueError(f"{len(blocks)} blocks for {n_blocks} layers")
    if len(out.get("dense_blocks", [])) != _first_dense(cfg):
        raise ValueError("dense_blocks do not match moe.first_k_dense")
    out["blocks"] = [L.to_tensors(b, device) for b in blocks]
    return out


def cast_params(params: Dict, dtype: torch.dtype) -> Dict:
    """Every floating leaf in ``dtype`` (a one-off cast of the weights to
    the compute type; ``dense_apply`` would cast them on every call)."""
    if isinstance(params, dict):
        return {k: cast_params(v, dtype) for k, v in params.items()}
    if isinstance(params, list):
        return [cast_params(v, dtype) for v in params]
    return params.to(dtype) if params.is_floating_point() else params


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------

def _first_dense(cfg: TransformerConfig) -> int:
    return cfg.moe.first_k_dense if cfg.moe else 0


def layer_windows(cfg: TransformerConfig) -> List[int]:
    """Per-layer sliding-window size (0 = global): with
    ``local_global_pattern`` even layers are local, odd ones global."""
    if cfg.local_global_pattern and cfg.sliding_window > 0:
        return [cfg.sliding_window if i % 2 == 0 else 0
                for i in range(cfg.n_layers)]
    return [cfg.sliding_window] * cfg.n_layers


def _attn_scale(cfg: TransformerConfig) -> float:
    if cfg.query_pre_attn_scalar > 0:
        return cfg.query_pre_attn_scalar ** -0.5
    return cfg.d_head ** -0.5


def _layers(params: Dict) -> List[Dict]:
    """Every block in depth order: the leading dense ones, then the
    rest."""
    return list(params.get("dense_blocks", [])) + list(params["blocks"])


def _local(p: Dict):
    """A dense layer's dict of this rank's pieces, and the placement of
    its weight (None when it is whole here)."""
    w, sh = split(p["w"])
    lp = {"w": w}
    if "b" in p:
        lp["b"] = split(p["b"])[0]
    return lp, sh


def _row_parallel(p: Dict, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """A dense layer whose weight may be sharded by rows: the partial
    products of every rank summed, then the (replicated) bias."""
    lp, sh = _local(p)
    if sh is None:
        return L.dense_apply(lp, x, compute_dtype)
    y = all_reduce(L.dense_apply({"w": lp["w"]}, x, compute_dtype),
                   sh.axes)
    return y + lp["b"].to(y.dtype) if "b" in lp else y


def _embed(params: Dict, cfg: TransformerConfig, tokens: torch.Tensor,
           compute_dtype) -> torch.Tensor:
    t, sh = split(params["embed"]["table"])
    if sh is None or sh.dim == 1:
        x = L.embed_apply({"table": t}, tokens, compute_dtype)
        if sh is not None:                   # d_model columns
            x = all_gather(x, sh.axes, dim=-1)
    else:                                    # vocab rows: masked lookup
        loc = tokens - sh.offset
        mine = (loc >= 0) & (loc < t.shape[0])
        x = L.embed_apply({"table": t}, loc.clamp(0, t.shape[0] - 1),
                          compute_dtype)
        x = all_reduce(torch.where(mine[..., None], x,
                                   torch.zeros((), dtype=x.dtype,
                                               device=x.device)), sh.axes)
    if cfg.scale_embeddings:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=compute_dtype,
                             device=x.device)
    return x


def _vocab_logits(params: Dict, cfg: TransformerConfig, x: torch.Tensor):
    """Logits of this rank's vocab columns, in x's dtype, and their
    placement (None: every column)."""
    if cfg.tie_embeddings:
        t, sh = split(params["embed"]["table"])
        logits = L.unembed_apply({"table": t}, x)
    else:
        lp, sh = _local(params["unembed"])
        logits = L.dense_apply(lp, x, x.dtype)
    if cfg.final_logit_softcap > 0:
        logits = L.softcap(logits, cfg.final_logit_softcap)
    return logits, sh


def unembed(params: Dict, cfg: TransformerConfig,
            x: torch.Tensor) -> torch.Tensor:
    """Output logits of final hidden states, in x's dtype."""
    logits, sh = _vocab_logits(params, cfg, x)
    return logits if sh is None else all_gather(logits, sh.axes, dim=-1)


def _add_metrics(acc: Dict, m: Dict) -> Dict:
    return {k: acc[k] + m[k] for k in acc} if acc else dict(m)


def _qkv(bp: Dict, cfg: TransformerConfig, x: torch.Tensor,
         positions: torch.Tensor, compute_dtype):
    """Projections with RoPE. x: (B, S, d) -> q (B, S, Hq, Dh), k and v
    (B, S, Hkv, Dh); with the heads sharded, this rank's Hq/m and Hkv/m
    heads, or all of them gathered when m does not divide Hkv."""
    B, S, _ = x.shape
    out = []
    for name in ("wq", "wk", "wv"):
        lp, sh = _local(bp["attn"][name])
        y = L.dense_apply(lp, x, compute_dtype)
        if sh is not None and cfg.n_kv_heads % sh.ways:
            y = all_gather(y, sh.axes, dim=-1)
        out.append(y.reshape(B, S, -1, cfg.d_head))
    q, k, v = out
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _glu_ffn(p: Dict, h: torch.Tensor, act: str,
             compute_dtype) -> torch.Tensor:
    """``down(act(gate(h)) * up(h))``, ``gate``/``up`` by columns and
    ``down`` by rows when sharded."""
    g = L.dense_apply(_local(p["gate"])[0], h, compute_dtype)
    u = L.dense_apply(_local(p["up"])[0], h, compute_dtype)
    return _row_parallel(p["down"], L.glu(g, u, act), compute_dtype)


def _attn_out_ffn(bp: Dict, cfg: TransformerConfig, x: torch.Tensor,
                  o: torch.Tensor, compute_dtype, with_metrics: bool = False
                  ) -> Tuple[torch.Tensor, Dict]:
    """The block after attention: output projection, (post-norm,)
    residual, FFN or MoE, (post-norm,) residual. Returns the new x and
    the MoE metrics ({} for a dense block, or without
    ``with_metrics``)."""
    o = o.reshape(*o.shape[:-2], o.shape[-2] * o.shape[-1])
    _, sh = split(bp["attn"]["wo"]["w"])
    if sh is not None and o.shape[-1] == sh.total:   # heads were gathered
        o = o.narrow(-1, sh.offset, sh.total // sh.ways)
    o = _row_parallel(bp["attn"]["wo"], o, compute_dtype)
    if cfg.post_norm:
        o = L.rmsnorm_apply(bp["ln1_post"], o, cfg.norm_eps)
    x = x + o
    h = L.rmsnorm_apply(bp["ln2"], x, cfg.norm_eps)
    metrics: Dict = {}
    if "moe" in bp:
        f, metrics = M.apply(bp["moe"], h.reshape(-1, h.shape[-1]), cfg.moe,
                             act=cfg.act, compute_dtype=compute_dtype,
                             with_metrics=with_metrics)
        f = f.reshape(h.shape)
    else:
        f = _glu_ffn(bp["ffn"], h, cfg.act, compute_dtype)
    if cfg.post_norm:
        f = L.rmsnorm_apply(bp["ln2_post"], f, cfg.norm_eps)
    return x + f, metrics


def _block_fwd(bp: Dict, cfg: TransformerConfig, x: torch.Tensor,
               positions: torch.Tensor, window: int, compute_dtype,
               q_chunk: int, with_metrics: bool = False):
    """Full-sequence block forward. x: (B, S, D). Returns the new x, the
    block's k, v (B, S, Hkv, Dh) and its MoE metrics (with
    ``with_metrics``)."""
    h = L.rmsnorm_apply(bp["ln1"], x, cfg.norm_eps)
    q, k, v = _qkv(bp, cfg, h, positions, compute_dtype)
    o = A.attention(q, k, v, causal=True, window=window,
                    softcap=cfg.attn_logit_softcap, scale=_attn_scale(cfg),
                    q_chunk=q_chunk)
    x, metrics = _attn_out_ffn(bp, cfg, x, o, compute_dtype, with_metrics)
    return x, k, v, metrics


def _trunk(params: Dict, cfg: TransformerConfig, tokens: torch.Tensor,
           q_chunk: int, kv_sink=None, with_metrics: bool = False
           ) -> Tuple[torch.Tensor, Dict]:
    """Embedding, every block, final norm. ``kv_sink(i, k, v)`` receives
    each layer's keys and values. Returns (x, summed MoE metrics); the
    metrics are computed only ``with_metrics`` ({} otherwise)."""
    cdt = L.dtype_of(cfg.dtype)
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    x = _embed(params, cfg, tokens, cdt)
    metrics: Dict = {}
    remat = cfg.remat and torch.is_grad_enabled() and x.requires_grad
    for i, (bp, w) in enumerate(zip(_layers(params), layer_windows(cfg))):
        if remat:
            x, k, v, m = checkpoint(_block_fwd, bp, cfg, x, positions, w,
                                    cdt, q_chunk, with_metrics,
                                    use_reentrant=False,
                                    context_fn=recompute_context)
        else:
            x, k, v, m = _block_fwd(bp, cfg, x, positions, w, cdt, q_chunk,
                                    with_metrics)
        if kv_sink is not None:
            kv_sink(i, k, v)
        metrics = _add_metrics(metrics, m) if m else metrics
    return L.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps), metrics


def hidden_states(params: Dict, cfg: TransformerConfig,
                  tokens: torch.Tensor, q_chunk: int = 1024,
                  with_metrics: bool = False):
    """Forward up to (and including) the final norm. tokens: (B, S).
    With ``with_metrics`` returns (x, metrics): the MoE layers' summed
    ``moe_aux_loss`` and ``moe_drop_frac`` ({} for a dense model);
    without it they are not computed."""
    x, metrics = _trunk(params, cfg, tokens, q_chunk,
                        with_metrics=with_metrics)
    return (x, metrics) if with_metrics else x


def forward(params: Dict, cfg: TransformerConfig, tokens: torch.Tensor,
            q_chunk: int = 1024, with_metrics: bool = False):
    """tokens: (B, S) -> logits (B, S, V) in the compute dtype (and the
    MoE metrics with ``with_metrics``, as ``hidden_states``)."""
    x, metrics = _trunk(params, cfg, tokens, q_chunk,
                        with_metrics=with_metrics)
    logits = unembed(params, cfg, x)
    return (logits, metrics) if with_metrics else logits


def _onehot_ce_sum(logits: torch.Tensor, labels: torch.Tensor,
                   mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked CE sum and mask sum of one chunk of logits, in float32, with
    the row max held constant (the reference's ``stop_gradient``). The
    reference selects the label's logit with a one-hot product to keep a
    vocab-sharded chunk local; on one card ``gather`` is the same sum."""
    logits = logits.to(torch.float32)
    m = logits.amax(dim=-1, keepdim=True).detach()
    shifted = logits - m
    lse = torch.log(torch.exp(shifted).sum(dim=-1)) + m[..., 0]
    ll = shifted.gather(-1, labels.long()[..., None])[..., 0] + m[..., 0]
    return ((lse - ll) * mask).sum(), mask.sum()


def _chunk_ce(params: Dict, cfg: TransformerConfig, x: torch.Tensor,
              labels: torch.Tensor, mask: torch.Tensor):
    """The reference's ``chunk_fn``: logits of one sequence chunk
    (``unembed``, its ``_chunk_logits``) and their CE sum."""
    return _onehot_ce_sum(unembed(params, cfg, x), labels, mask)


def lm_loss(params: Dict, cfg: TransformerConfig, tokens: torch.Tensor,
            labels: torch.Tensor, mask: Optional[torch.Tensor] = None,
            q_chunk: int = 1024, loss_chunk: int = 1024,
            weight: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict]:
    """Chunked LM loss: mean masked next-token CE over (B, S) tokens and
    labels, plus the MoE load-balance loss over ``n_layers``. Returns
    (loss, MoE metrics). The (B, S, V) logits never exist whole: the
    unembedding and CE run ``loss_chunk`` positions at a time, each chunk
    under ``torch.utils.checkpoint`` while training, as the reference's
    ``jax.checkpoint``-ed ``chunk_fn``. ``weight`` (optional) replaces
    the mask sum the CE sum is divided by: a DP rank of a sharded step
    divides by the whole batch's mean weight a rank."""
    B, S = tokens.shape
    x, metrics = _trunk(params, cfg, tokens, q_chunk, with_metrics=True)
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=x.device)
    mask = mask.to(torch.float32)
    remat = torch.is_grad_enabled() and x.requires_grad
    if S > loss_chunk and S % loss_chunk:
        raise ValueError(f"S={S} must be a multiple of "
                         f"loss_chunk={loss_chunk}")
    mask_weight = weight
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    weight = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, S, loss_chunk):
        args = (params, cfg, x[:, lo:lo + loss_chunk],
                labels[:, lo:lo + loss_chunk], mask[:, lo:lo + loss_chunk])
        ct, cw = (checkpoint(_chunk_ce, *args, use_reentrant=False,
                             context_fn=recompute_context)
                  if remat else _chunk_ce(*args))
        total = total + ct
        weight = weight + cw
    loss = total / (weight if mask_weight is None
                    else mask_weight).clamp(min=1.0)
    if cfg.moe is not None:
        loss = loss + metrics["moe_aux_loss"] / cfg.n_layers
    return loss, metrics


def _token_chunk(cfg: TransformerConfig) -> int:
    return max(1, SCORE_LOGIT_BYTES // (4 * cfg.vocab_size))


def _head_weight(params: Dict, cfg: TransformerConfig):
    """The vocabulary weight as this rank holds it, its placement (None:
    whole here) and whether the untied head has a bias."""
    if cfg.tie_embeddings:
        w, sh = split(params["embed"]["table"])
        return w, sh, False
    lp, sh = _local(params["unembed"])
    return lp["w"], sh, "b" in lp


def _mean_token_logprob(params: Dict, cfg: TransformerConfig,
                        x: torch.Tensor, tgt: torch.Tensor,
                        token_chunk: int) -> torch.Tensor:
    """Per-sequence mean logprob of ``tgt`` (B, T) under the final hidden
    states ``x`` (B, T, d); zeros where T is 0. The head takes the path
    ``kernels.score_head.instance`` gives it: the fused kernel, or
    ``token_chunk`` positions (over rows and positions alike) of logits at
    a time (``_chunked_token_logprob``)."""
    B, T = tgt.shape
    if T == 0:
        return torch.zeros((B,), dtype=torch.float32, device=x.device)
    xf = x.reshape(B * T, x.shape[-1])
    tf = tgt.reshape(B * T)
    with span("transformer.score_head"):
        w, sh, bias = _head_weight(params, cfg)
        path = SH.instance(xf, w, tied=cfg.tie_embeddings,
                           sharded=sh is not None,
                           softcap=cfg.final_logit_softcap, bias=bias)
        SH.score_head.by_instance[path] += 1
        if path == "fused":
            tok_lp = SH.score_head(xf, w, tf, tied=cfg.tie_embeddings)
        else:
            tok_lp = _chunked_token_logprob(params, cfg, xf, tf.long(),
                                            token_chunk)
    return tok_lp.reshape(B, T).mean(dim=-1)


def _chunked_token_logprob(params: Dict, cfg: TransformerConfig,
                           xf: torch.Tensor, tf: torch.Tensor,
                           token_chunk: int) -> torch.Tensor:
    """Each position's logprob of its target, ``token_chunk`` positions of
    float32 logits at a time: xf (P, d), tf (P,) int64 -> (P,) float32."""
    tok_lp = torch.empty((xf.shape[0],), dtype=torch.float32,
                         device=xf.device)
    for lo in range(0, xf.shape[0], token_chunk):
        logits, sh = _vocab_logits(params, cfg, xf[lo:lo + token_chunk])
        logits = logits.to(torch.float32)
        tgt = tf[lo:lo + token_chunk]
        if sh is None:
            lse = torch.logsumexp(logits, dim=-1)
            tok_lp[lo:lo + token_chunk] = logits.gather(
                -1, tgt[:, None])[:, 0] - lse
            continue
        # vocab-sharded: max and sum of exponentials across the shards,
        # the label's logit from the one shard that holds it
        n = logits.shape[-1]
        mx = all_reduce(logits.amax(dim=-1), sh.axes, op="max")
        lse = torch.log(all_reduce(torch.exp(logits - mx[:, None]).sum(
            dim=-1), sh.axes)) + mx
        loc = tgt - sh.offset
        lab = logits.gather(-1, loc.clamp(0, n - 1)[:, None])[:, 0]
        lab = torch.where((loc >= 0) & (loc < n), lab,
                          torch.zeros_like(lab))
        tok_lp[lo:lo + token_chunk] = all_reduce(lab, sh.axes) - lse
    return tok_lp


def score_tokens(params: Dict, cfg: TransformerConfig, tokens: torch.Tensor,
                 q_chunk: int = 1024) -> torch.Tensor:
    """Sequence log-likelihood score, the LM trust-evaluator head:
    per-sequence mean token logprob (B,).

    The same function as the reference's. After the trunk the head runs
    as one fused kernel (``kernels.score_head``, no logit in device
    memory) or, where its rule says so, a chunk of positions at a time
    (``SCORE_LOGIT_BYTES`` of float32 logits), so the (B, S, V) logits and
    their float32 log-softmax never exist whole."""
    x = hidden_states(params, cfg, tokens[:, :-1], q_chunk)
    return _mean_token_logprob(params, cfg, x, tokens[:, 1:],
                               _token_chunk(cfg))


# ---------------------------------------------------------------------------
# KV cache: prefill + decode
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: int,
                  device=None, n_kv_heads: Optional[int] = None) -> Dict:
    """Zeroed cache: k, v (n_layers, batch, max_len, Hkv, Dh) in the
    compute dtype (``n_kv_heads`` of them, all by default); lengths
    (batch,) int32."""
    cdt = L.dtype_of(cfg.dtype)
    shape = (cfg.n_layers, batch, max_len, n_kv_heads or cfg.n_kv_heads,
             cfg.d_head)
    return {"k": torch.zeros(shape, dtype=cdt, device=device),
            "v": torch.zeros(shape, dtype=cdt, device=device),
            "lengths": torch.zeros((batch,), dtype=torch.int32,
                                   device=device)}


def _all_heads(bp: Dict, cfg: TransformerConfig, t: torch.Tensor
               ) -> torch.Tensor:
    """q, k or v (..., heads, Dh) with every head: this rank's heads
    gathered over the projection's axes (unless ``_qkv`` gathered them
    already)."""
    _, sh = split(bp["attn"]["wq"]["w"])
    if sh is None or cfg.n_kv_heads % sh.ways:
        return t
    return all_gather(t, sh.axes, dim=-2)


def _seq_offset(seq_axes, length: int) -> int:
    """First global position of this rank's piece of the sequence."""
    return flat_coord(seq_axes)[0] * length


def _piece_attention(q, k_c, v_c, new_len, off: int, window: int,
                     softcap: float, scale: float):
    """Attention of the newest token over this rank's piece [off, off +
    L) of each row's cache: (o, lse) of the positions the row sees
    there. The kernel takes a row's valid positions as [len - w, len);
    a piece that ends before the row does ends its valid range at L, so
    its w differs row by row: rows of one w are one call (on fake tensors
    one call stands for them)."""
    L_loc = k_c.shape[1]
    hi = (new_len.to(torch.int64) - off).clamp(0, L_loc)
    if window <= 0:
        return A.decode_attention(q, k_c, v_c, hi.to(torch.int32),
                                  softcap=softcap, scale=scale,
                                  return_lse=True)
    lo = (new_len.to(torch.int64) - window - off).clamp(0, L_loc)
    lens = torch.where(hi > lo, hi, torch.zeros_like(hi)).to(torch.int32)
    wins = torch.where(lo > 0, hi - lo, torch.full_like(hi, L_loc))
    if is_fake(q):
        return A.decode_attention(q, k_c, v_c, lens, window=window,
                                  softcap=softcap, scale=scale,
                                  return_lse=True)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    for w in sorted(set(wins.tolist())):
        rows = (wins == w).nonzero()[:, 0]
        o[rows], lse[rows] = A.decode_attention(
            q[rows], k_c[rows], v_c[rows], lens[rows], window=int(w),
            softcap=softcap, scale=scale, return_lse=True)
    return o, lse


def _merge_pieces(o: torch.Tensor, lse: torch.Tensor, seq_axes):
    """One output from every rank's (o, lse) over its piece: the pieces
    weighed by exp(lse - max lse), summed over ``seq_axes``; a head that
    saw nothing anywhere gives zeros."""
    m = all_reduce(lse.clone(), seq_axes, op="max")
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(lse - m)
    num = all_reduce(o.to(torch.float32) * w[..., None], seq_axes)
    den = all_reduce(w, seq_axes)
    return (num / torch.where(den > 0, den, torch.ones_like(den))[..., None]
            ).to(o.dtype)


@torch.no_grad()
def decode_step(params: Dict, cfg: TransformerConfig, token: torch.Tensor,
                cache: Dict, seq_axes=()) -> Tuple[torch.Tensor, Dict]:
    """One decoding step.

    token: (B,) integer, the newest token; cache: see ``init_kv_cache``
    (``lengths`` counts tokens already in the cache). Returns
    (logits (B, V), cache). With ``seq_axes`` (``placement.Axis`` es,
    outer first) the cache holds this rank's piece of the sequence for
    every head: see the module note.

    Unlike the reference, which returns new arrays, the new token's k and
    v are written **in place** into ``cache["k"]`` and ``cache["v"]``
    (at the full-width decode shape the cache is gigabytes; a copy per
    step is out of the question). The returned cache holds those same
    tensors and new ``lengths``; the cache passed in no longer describes
    the state before the step."""
    cdt = L.dtype_of(cfg.dtype)
    lengths = cache["lengths"]
    positions = lengths[:, None]                     # new token position
    new_len = lengths + 1
    x = _embed(params, cfg, token, cdt)              # (B, d)
    off = _seq_offset(seq_axes, cache["k"].shape[2]) if seq_axes else 0
    for i, (bp, w) in enumerate(zip(_layers(params), layer_windows(cfg))):
        k_c, v_c = cache["k"][i], cache["v"][i]
        h = L.rmsnorm_apply(bp["ln1"], x, cfg.norm_eps)
        q, k, v = _qkv(bp, cfg, h[:, None, :], positions, cdt)
        if not seq_axes:
            A.update_kv_cache(k_c, v_c, k[:, 0], v[:, 0], lengths)
            o = A.decode_attention(q[:, 0], k_c, v_c, new_len, window=w,
                                   softcap=cfg.attn_logit_softcap,
                                   scale=_attn_scale(cfg))
        else:
            q, k, v = (_all_heads(bp, cfg, t[:, 0]) for t in (q, k, v))
            A.update_kv_cache(k_c, v_c, k, v, lengths - off)
            o = _merge_pieces(*_piece_attention(
                q, k_c, v_c, new_len, off, w, cfg.attn_logit_softcap,
                _attn_scale(cfg)), seq_axes)
        x, _ = _attn_out_ffn(bp, cfg, x, o, cdt)
    x = L.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    return unembed(params, cfg, x), {**cache, "lengths": new_len}


@torch.no_grad()
def prefill(params: Dict, cfg: TransformerConfig, tokens: torch.Tensor,
            max_len: Optional[int] = None, q_chunk: int = 1024,
            seq_axes=()) -> Tuple[torch.Tensor, Dict]:
    """Prefill scoring pass: returns (per-seq score (B,), KV cache).

    The score is the mean next-token logprob over the prompt (0 for a
    one-token prompt), as the reference's; the cache holds every prompt
    position, zero-padded to ``max_len``, so decode can continue. With
    the heads sharded the cache holds this rank's heads; with
    ``seq_axes`` it holds this rank's piece of the positions, every head
    (see the module note)."""
    B, S = tokens.shape
    n = max_len or S
    first = _layers(params)[0]
    _, sh = split(first["attn"]["wk"]["w"])
    heads = cfg.n_kv_heads
    if sh is not None and not seq_axes and cfg.n_kv_heads % sh.ways == 0:
        heads //= sh.ways
    ways = math.prod(a.size for a in seq_axes)
    if n % ways:
        raise ValueError(f"a cache of {n} positions does not divide over "
                         f"{ways} ranks")
    cache = init_kv_cache(cfg, B, n // ways, device=tokens.device,
                          n_kv_heads=heads)
    cache["lengths"].fill_(S)
    off = _seq_offset(seq_axes, n // ways) if seq_axes else 0

    def keep(i, k, v):
        if seq_axes:
            k, v = (_all_heads(first, cfg, t)[:, off:off + n // ways]
                    for t in (k, v))
        cache["k"][i, :, :k.shape[1]] = k
        cache["v"][i, :, :v.shape[1]] = v

    x, _ = _trunk(params, cfg, tokens, q_chunk, kv_sink=keep)
    return _mean_token_logprob(params, cfg, x[:, :-1], tokens[:, 1:],
                               _token_chunk(cfg)), cache
