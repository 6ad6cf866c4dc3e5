"""Dense decoder-only transformer: the trust evaluator's forward.

Counterpart of ``repro.models.transformer`` for the dense llama-style
configs (smollm-135m): GQA with RoPE, SwiGLU FFN, RMSNorm, tied
embeddings; the full-sequence forward and scoring head, and the KV-cache
path (``init_kv_cache``, ``prefill``, ``decode_step``). It has no MoE, no
sliding window and no remat; layers run in a Python loop over a list of
block dicts.

Parameters are nested dicts of tensors with the reference's names and
``(d_in, d_out)`` dense weights; :func:`params_from_jax` converts a JAX
parameter pytree (as numpy arrays) into this form.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

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
    def layer(tree, i):
        if isinstance(tree, dict):
            return {k: layer(v, i) for k, v in tree.items()}
        return tree[i]

    out = L.to_tensors({k: v for k, v in params.items() if k != "blocks"},
                       device)
    blocks = params["blocks"]
    if isinstance(blocks, dict):                     # stacked: (L, ...)
        blocks = [layer(blocks, i) for i in range(cfg.n_layers)]
    if len(blocks) != cfg.n_layers:
        raise ValueError(f"{len(blocks)} blocks for {cfg.n_layers} layers")
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


def _qkv(bp: Dict, cfg: TransformerConfig, x: torch.Tensor,
         positions: torch.Tensor, compute_dtype):
    """Projections with RoPE. x: (B, S, d) -> q (B, S, Hq, Dh), k and v
    (B, S, Hkv, Dh)."""
    B, S, _ = x.shape
    q = L.dense_apply(bp["attn"]["wq"], x, compute_dtype)
    k = L.dense_apply(bp["attn"]["wk"], x, compute_dtype)
    v = L.dense_apply(bp["attn"]["wv"], x, compute_dtype)
    q = L.apply_rope(q.reshape(B, S, cfg.n_heads, cfg.d_head), positions,
                     cfg.rope_theta)
    k = L.apply_rope(k.reshape(B, S, cfg.n_kv_heads, cfg.d_head), positions,
                     cfg.rope_theta)
    return q, k, v.reshape(B, S, cfg.n_kv_heads, cfg.d_head)


def _attn_out_ffn(bp: Dict, cfg: TransformerConfig, x: torch.Tensor,
                  o: torch.Tensor, compute_dtype) -> torch.Tensor:
    """The block after attention: output projection, residual, FFN."""
    o = L.dense_apply(bp["attn"]["wo"],
                      o.reshape(*o.shape[:-2], cfg.n_heads * cfg.d_head),
                      compute_dtype)
    x = x + o
    h = L.rmsnorm_apply(bp["ln2"], x, cfg.norm_eps)
    return x + L.glu_ffn_apply(bp["ffn"], h, act=cfg.act,
                               compute_dtype=compute_dtype)


def _block_fwd(bp: Dict, cfg: TransformerConfig, x: torch.Tensor,
               positions: torch.Tensor, compute_dtype, q_chunk: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence block forward. x: (B, S, D). Returns the new x and
    the block's k, v (B, S, Hkv, Dh)."""
    h = L.rmsnorm_apply(bp["ln1"], x, cfg.norm_eps)
    q, k, v = _qkv(bp, cfg, h, positions, compute_dtype)
    o = A.attention(q, k, v, causal=True, scale=cfg.d_head ** -0.5,
                    q_chunk=q_chunk)
    return _attn_out_ffn(bp, cfg, x, o, compute_dtype), k, v


def hidden_states(params: Dict, cfg: TransformerConfig,
                  tokens: torch.Tensor, q_chunk: int = 1024
                  ) -> torch.Tensor:
    """Forward up to (and including) the final norm. tokens: (B, S)."""
    cdt = L.dtype_of(cfg.dtype)
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    x = L.embed_apply(params["embed"], tokens, cdt)
    for bp in params["blocks"]:
        x, _, _ = _block_fwd(bp, cfg, x, positions, cdt, q_chunk)
    return L.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)


def forward(params: Dict, cfg: TransformerConfig, tokens: torch.Tensor,
            q_chunk: int = 1024) -> torch.Tensor:
    """tokens: (B, S) -> logits (B, S, V) in the compute dtype."""
    return L.unembed_apply(params["embed"],
                           hidden_states(params, cfg, tokens, q_chunk))


def _mean_token_logprob(params: Dict, x: torch.Tensor, tgt: torch.Tensor,
                        row_chunk: int) -> torch.Tensor:
    """Per-sequence mean logprob of ``tgt`` (B, T) under the final hidden
    states ``x`` (B, T, d), ``row_chunk`` sequences of logits at a time;
    zeros where T is 0."""
    B, T = tgt.shape
    if T == 0:
        return torch.zeros((B,), dtype=torch.float32, device=x.device)
    tgt = tgt.long()
    tok_lp = torch.empty((B, T), dtype=torch.float32, device=x.device)
    for lo in range(0, B, row_chunk):
        logits = L.unembed_apply(params["embed"],
                                 x[lo:lo + row_chunk]).to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        tok_lp[lo:lo + row_chunk] = logits.gather(
            -1, tgt[lo:lo + row_chunk, :, None])[..., 0] - lse
    return tok_lp.mean(dim=-1)


def score_tokens(params: Dict, cfg: TransformerConfig, tokens: torch.Tensor,
                 q_chunk: int = 1024,
                 row_chunk: int = SCORE_ROW_CHUNK) -> torch.Tensor:
    """Sequence log-likelihood score, the LM trust-evaluator head:
    per-sequence mean token logprob (B,).

    The same function as the reference's, computed ``row_chunk``
    sequences at a time after the trunk, so the (B, S, V) logits and
    their float32 log-softmax never exist whole."""
    x = hidden_states(params, cfg, tokens[:, :-1], q_chunk)
    return _mean_token_logprob(params, x, tokens[:, 1:], row_chunk)


# ---------------------------------------------------------------------------
# KV cache: prefill + decode
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: int,
                  device=None) -> Dict:
    """Zeroed cache: k, v (n_layers, batch, max_len, Hkv, Dh) in the
    compute dtype; lengths (batch,) int32."""
    cdt = L.dtype_of(cfg.dtype)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=cdt, device=device),
            "v": torch.zeros(shape, dtype=cdt, device=device),
            "lengths": torch.zeros((batch,), dtype=torch.int32,
                                   device=device)}


@torch.no_grad()
def decode_step(params: Dict, cfg: TransformerConfig, token: torch.Tensor,
                cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """One decoding step.

    token: (B,) integer, the newest token; cache: see ``init_kv_cache``
    (``lengths`` counts tokens already in the cache). Returns
    (logits (B, V), cache).

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
    x = L.embed_apply(params["embed"], token, cdt)   # (B, d)
    for i, bp in enumerate(params["blocks"]):
        k_c, v_c = cache["k"][i], cache["v"][i]
        h = L.rmsnorm_apply(bp["ln1"], x, cfg.norm_eps)
        q, k, v = _qkv(bp, cfg, h[:, None, :], positions, cdt)
        A.update_kv_cache(k_c, v_c, k[:, 0], v[:, 0], lengths)
        o = A.decode_attention(q[:, 0], k_c, v_c, new_len,
                               scale=cfg.d_head ** -0.5)
        x = _attn_out_ffn(bp, cfg, x, o, cdt)
    x = L.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed_apply(params["embed"], x)
    return logits, {**cache, "lengths": new_len}


@torch.no_grad()
def prefill(params: Dict, cfg: TransformerConfig, tokens: torch.Tensor,
            max_len: Optional[int] = None, q_chunk: int = 1024,
            row_chunk: int = SCORE_ROW_CHUNK) -> Tuple[torch.Tensor, Dict]:
    """Prefill scoring pass: returns (per-seq score (B,), KV cache).

    The score is the mean next-token logprob over the prompt (0 for a
    one-token prompt), as the reference's; the cache holds every prompt
    position, zero-padded to ``max_len``, so decode can continue."""
    cdt = L.dtype_of(cfg.dtype)
    B, S = tokens.shape
    max_len = max_len or S
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    cache = init_kv_cache(cfg, B, max_len, device=tokens.device)
    cache["lengths"].fill_(S)
    x = L.embed_apply(params["embed"], tokens, cdt)
    for i, bp in enumerate(params["blocks"]):
        x, k, v = _block_fwd(bp, cfg, x, positions, cdt, q_chunk)
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
    x = L.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    return _mean_token_logprob(params, x[:, :-1], tokens[:, 1:],
                               row_chunk), cache
