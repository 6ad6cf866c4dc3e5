"""BST — Behavior Sequence Transformer. [arXiv:1905.06874]

Counterpart of ``repro.models.recsys.bst`` (``init_params``,
``forward``, ``loss_fn``, ``relevance_scores``). Embeds the user behavior sequence
(+ target item), runs ``n_blocks`` transformer blocks over (seq_len + 1)
positions with learned positional embeddings, flattens, concatenates
other-feature embeddings, and feeds the 1024-512-256 MLP -> CTR logit.

The blocks' attention has d_head 4 over 21 positions. The reference
computes it with a plain ``einsum`` (scores in float32), not a Pallas
kernel, so here it is two plain matmuls with the softmax in float32.
:func:`params_from_jax` converts the reference's parameter pytree (as
numpy arrays) into this form.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.configs.base import RecsysConfig
from repro_torch.models import layers as L
from repro_torch.models.recsys import embedding as E


def init_params(cfg: RecsysConfig, generator: torch.Generator,
                device=None) -> Dict:
    """Seeded init with the reference's shapes and scales (not its
    numbers), every tensor drawn on ``device`` by ``generator`` (a
    generator of that device)."""
    dt = L.dtype_of(cfg.param_dtype)
    kw = dict(device=device, dtype=dt)
    d = cfg.embed_dim
    n_other = len(cfg.tables) - 1          # tables beyond "item"
    blocks = [{
        "ln1": L.layernorm_init(d, **kw),
        "ln2": L.layernorm_init(d, **kw),
        "wq": L.dense_init(d, d, generator, bias=True, **kw),
        "wk": L.dense_init(d, d, generator, bias=True, **kw),
        "wv": L.dense_init(d, d, generator, bias=True, **kw),
        "wo": L.dense_init(d, d, generator, bias=True, **kw),
        "ffn": L.mlp_init((4 * d, d), d, generator, **kw),
    } for _ in range(cfg.n_blocks)]
    seq = cfg.seq_len + 1
    return {
        "tables": {t.name: E.table_init(t, generator, **kw)
                   for t in cfg.tables},
        "pos": L.trunc_normal((seq, d), 0.02, generator, device, dt),
        "blocks": blocks,
        "mlp": L.mlp_init(tuple(cfg.mlp) + (1,), seq * d + n_other * d,
                          generator, **kw),
    }


def params_from_jax(params, device=None) -> Dict:
    """The reference's parameter pytree (leaves as numpy arrays) as the
    port's tensors."""
    return L.to_tensors(params, device)


def _block(bp: Dict, x: torch.Tensor, n_heads: int, cdt) -> torch.Tensor:
    B, S, d = x.shape
    dh = d // n_heads
    h = L.layernorm_apply(bp["ln1"], x)

    def heads(p):                          # (B, S, d) -> (B, H, S, dh)
        return L.dense_apply(p, h, cdt).reshape(B, S, n_heads,
                                                dh).transpose(1, 2)

    q, k, v = heads(bp["wq"]), heads(bp["wk"]), heads(bp["wv"])
    s = (q.to(torch.float32) @ k.to(torch.float32).transpose(-1, -2)) \
        / math.sqrt(dh)
    p = torch.softmax(s, dim=-1).to(cdt)
    o = (p @ v).transpose(1, 2).reshape(B, S, d)
    x = x + L.dense_apply(bp["wo"], o, cdt)
    h = L.layernorm_apply(bp["ln2"], x)
    return x + L.mlp_apply(bp["ffn"], h, compute_dtype=cdt)


def forward(params: Dict, cfg: RecsysConfig, hist: torch.Tensor,
            target: torch.Tensor, other_idx: torch.Tensor) -> torch.Tensor:
    """hist: (B, seq_len) item ids; target: (B,); other_idx: (B, n_other).

    Returns CTR logits (B,) in float32.
    """
    cdt = L.dtype_of(cfg.dtype)
    items = E.lookup(params["tables"]["item"],
                     torch.cat([hist, target[:, None]], dim=1), cdt)
    x = items + params["pos"].to(cdt)[None]
    for bp in params["blocks"]:
        x = _block(bp, x, cfg.n_heads, cdt)
    B = x.shape[0]
    other_names = [t.name for t in cfg.tables if t.name != "item"]
    others = [E.lookup(params["tables"][n], other_idx[:, i], cdt)
              for i, n in enumerate(other_names)]
    flat = torch.cat([x.reshape(B, -1)] + others, dim=-1)
    out = L.mlp_apply(params["mlp"], flat, compute_dtype=cdt)
    return out[:, 0].to(torch.float32)


def loss_fn(params: Dict, cfg: RecsysConfig, batch: Dict) -> torch.Tensor:
    """Mean BCE of the CTR logits against ``batch["labels"]``."""
    logits = forward(params, cfg, batch["hist"], batch["target"],
                     batch["other"])
    return L.bce_with_logits(logits, batch["labels"])


def relevance_scores(params: Dict, cfg: RecsysConfig, hist, target, other,
                     trust_scale: float = 5.0) -> torch.Tensor:
    """Trust-evaluator head: CTR probability scaled to [0, trust_scale]."""
    return torch.sigmoid(forward(params, cfg, hist, target, other)) \
        * trust_scale
