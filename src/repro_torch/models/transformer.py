"""Dense decoder-only transformer: the trust evaluator's forward.

Counterpart of ``repro.models.transformer`` for the dense llama-style
configs (smollm-135m): GQA with RoPE, SwiGLU/GeGLU FFN, RMSNorm, tied
embeddings. It has no MoE, no decode path and no remat; layers run in a
Python loop over a list of block dicts.

Parameters are nested dicts of tensors with the reference's names and
``(d_in, d_out)`` dense weights; :func:`params_from_jax` converts a JAX
parameter pytree (as numpy arrays) into this form.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import TransformerConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L

# Rows of the (rows, S, vocab) logits that score_tokens materializes at
# once: 256 x 31 x 49152 bf16 logits are 0.8 GB, their float32
# log-softmax temporaries about 3 GB.
SCORE_ROW_CHUNK = 256


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device=None) -> Dict:
    """Seeded init with the reference's shapes and scales (not its
    numbers: torch and JAX draw different bits from a seed)."""
    if not cfg.tie_embeddings:
        raise ValueError("the port's transformer supports tied "
                         "embeddings only")
    dt = L.dtype_of(cfg.param_dtype)
    kw = dict(device=device, dtype=dt)
    d, Hq, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    params: Dict = {"embed": L.embed_init(cfg.vocab_size, d, generator,
                                          **kw)}
    blocks = []
    for _ in range(cfg.n_layers):
        blocks.append({
            "ln1": L.rmsnorm_init(d, **kw),
            "ln2": L.rmsnorm_init(d, **kw),
            "attn": {
                "wq": L.dense_init(d, Hq * Dh, generator, **kw),
                "wk": L.dense_init(d, Hkv * Dh, generator, **kw),
                "wv": L.dense_init(d, Hkv * Dh, generator, **kw),
                "wo": L.dense_init(Hq * Dh, d, generator, **kw,
                                   std=math.sqrt(1.0 / (Hq * Dh))
                                   / math.sqrt(2.0 * cfg.n_layers)),
            },
            "ffn": L.glu_ffn_init(d, cfg.d_ff, generator, **kw),
        })
    params["blocks"] = blocks
    params["final_norm"] = L.rmsnorm_init(d, **kw)
    return params


def params_from_jax(params, cfg: TransformerConfig, device=None) -> Dict:
    """The reference's parameter pytree (leaves as numpy arrays) as the
    port's tensors. ``blocks`` may be the stacked form (one dict whose
    leaves carry a leading layer axis: ``scan_layers=True``) or a list
    of per-layer dicts (``scan_layers=False``)."""
    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [conv(v) for v in tree]
        return torch.as_tensor(np.array(tree), device=device)

    def layer(tree, i):
        if isinstance(tree, dict):
            return {k: layer(v, i) for k, v in tree.items()}
        return tree[i]

    out = conv({k: v for k, v in params.items() if k != "blocks"})
    blocks = params["blocks"]
    if isinstance(blocks, dict):                     # stacked: (L, ...)
        blocks = [layer(blocks, i) for i in range(cfg.n_layers)]
    if len(blocks) != cfg.n_layers:
        raise ValueError(f"{len(blocks)} blocks for {cfg.n_layers} layers")
    out["blocks"] = [conv(b) for b in blocks]
    return out


def cast_params(params: Dict, dtype: torch.dtype) -> Dict:
    """Every floating leaf in ``dtype`` (a one-off cast of the weights to
    the compute type; ``dense_apply`` would cast them on every call)."""
    if isinstance(params, dict):
        return {k: cast_params(v, dtype) for k, v in params.items()}
    if isinstance(params, list):
        return [cast_params(v, dtype) for v in params]
    return params.to(dtype) if params.is_floating_point() else params


def _block_fwd(bp: Dict, cfg: TransformerConfig, x: torch.Tensor,
               positions: torch.Tensor, compute_dtype,
               q_chunk: int) -> torch.Tensor:
    """Full-sequence block forward. x: (B, S, D)."""
    B, S, _ = x.shape
    h = L.rmsnorm_apply(bp["ln1"], x, cfg.norm_eps)
    q = L.dense_apply(bp["attn"]["wq"], h, compute_dtype)
    k = L.dense_apply(bp["attn"]["wk"], h, compute_dtype)
    v = L.dense_apply(bp["attn"]["wv"], h, compute_dtype)
    q = L.apply_rope(q.reshape(B, S, cfg.n_heads, cfg.d_head), positions,
                     cfg.rope_theta)
    k = L.apply_rope(k.reshape(B, S, cfg.n_kv_heads, cfg.d_head), positions,
                     cfg.rope_theta)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.d_head)
    o = A.attention(q, k, v, causal=True, scale=cfg.d_head ** -0.5,
                    q_chunk=q_chunk)
    o = L.dense_apply(bp["attn"]["wo"],
                      o.reshape(B, S, cfg.n_heads * cfg.d_head),
                      compute_dtype)
    x = x + o
    h = L.rmsnorm_apply(bp["ln2"], x, cfg.norm_eps)
    return x + L.glu_ffn_apply(bp["ffn"], h, act=cfg.act,
                               compute_dtype=compute_dtype)


def hidden_states(params: Dict, cfg: TransformerConfig,
                  tokens: torch.Tensor, q_chunk: int = 1024
                  ) -> torch.Tensor:
    """Forward up to (and including) the final norm. tokens: (B, S)."""
    cdt = L.dtype_of(cfg.dtype)
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    x = L.embed_apply(params["embed"], tokens, cdt)
    for bp in params["blocks"]:
        x = _block_fwd(bp, cfg, x, positions, cdt, q_chunk)
    return L.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)


def forward(params: Dict, cfg: TransformerConfig, tokens: torch.Tensor,
            q_chunk: int = 1024) -> torch.Tensor:
    """tokens: (B, S) -> logits (B, S, V) in the compute dtype."""
    return L.unembed_apply(params["embed"],
                           hidden_states(params, cfg, tokens, q_chunk))


def score_tokens(params: Dict, cfg: TransformerConfig, tokens: torch.Tensor,
                 q_chunk: int = 1024,
                 row_chunk: int = SCORE_ROW_CHUNK) -> torch.Tensor:
    """Sequence log-likelihood score, the LM trust-evaluator head:
    per-sequence mean token logprob (B,).

    The same function as the reference's, computed ``row_chunk``
    sequences at a time after the trunk, so the (B, S, V) logits and
    their float32 log-softmax never exist whole."""
    x = hidden_states(params, cfg, tokens[:, :-1], q_chunk)
    tgt = tokens[:, 1:].long()
    tok_lp = torch.empty(tgt.shape, dtype=torch.float32,
                         device=tokens.device)
    for lo in range(0, x.shape[0], row_chunk):
        logits = L.unembed_apply(params["embed"],
                                 x[lo:lo + row_chunk]).to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        tok_lp[lo:lo + row_chunk] = logits.gather(
            -1, tgt[lo:lo + row_chunk, :, None])[..., 0] - lse
    return tok_lp.mean(dim=-1)
