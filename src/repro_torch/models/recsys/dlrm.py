"""DLRM (MLPerf config): bottom MLP + 26 embedding lookups + dot
interaction + top MLP. [arXiv:1906.00091]

Counterpart of ``repro.models.recsys.dlrm`` (``init_params``,
``forward``, ``loss_fn``, ``relevance_scores``). The dot interaction
runs ``kernels.dot_interaction``: the hand-written CUDA kernel on CUDA
tensors (its backward kernel gives the gradient), its plain version on
CPU tensors. The MLPs stay ``torch.matmul``, as the reference left them to
XLA. :func:`params_from_jax` converts the reference's parameter pytree
(as numpy arrays) into this form.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import RecsysConfig
from repro_torch.kernels.dot_interaction import dot_interaction
from repro_torch.models import layers as L
from repro_torch.models.recsys import embedding as E


def init_params(cfg: RecsysConfig, generator: torch.Generator,
                device=None) -> Dict:
    """Seeded init with the reference's shapes and scales (not its
    numbers). Every tensor, the tables included, is drawn on ``device``
    by ``generator`` (a generator of that device)."""
    dt = L.dtype_of(cfg.param_dtype)
    kw = dict(device=device, dtype=dt)
    n_f = len(cfg.tables) + 1
    d_int = n_f * (n_f - 1) // 2 + cfg.bot_mlp[-1]
    return {
        "tables": {t.name: E.table_init(t, generator, **kw)
                   for t in cfg.tables},
        "bot_mlp": L.mlp_init(cfg.bot_mlp[1:], cfg.bot_mlp[0], generator,
                              **kw),
        "top_mlp": L.mlp_init(cfg.top_mlp, d_int, generator, **kw),
    }


def params_from_jax(params, device=None) -> Dict:
    """The reference's parameter pytree (leaves as numpy arrays) as the
    port's tensors."""
    return L.to_tensors(params, device)


def forward(params: Dict, cfg: RecsysConfig, dense: torch.Tensor,
            sparse_idx: torch.Tensor) -> torch.Tensor:
    """dense: (B, n_dense) float; sparse_idx: (B, n_tables) integer.

    Returns CTR logits (B,) in float32.
    """
    cdt = L.dtype_of(cfg.dtype)
    bot = L.mlp_apply(params["bot_mlp"], dense.to(cdt), final_act=True,
                      compute_dtype=cdt)                       # (B, d_emb)
    embs = [E.lookup(params["tables"][t.name], sparse_idx[:, i], cdt)
            for i, t in enumerate(cfg.tables)]                 # each (B, d)
    feats = torch.stack([bot] + embs, dim=1)                   # (B, F, d)
    inter = dot_interaction(feats)                             # (B, F(F-1)/2)
    top_in = torch.cat([bot, inter], dim=-1)
    out = L.mlp_apply(params["top_mlp"], top_in, compute_dtype=cdt)
    return out[:, 0].to(torch.float32)


def loss_fn(params: Dict, cfg: RecsysConfig, batch: Dict) -> torch.Tensor:
    """Mean BCE of the CTR logits against ``batch["labels"]``."""
    logits = forward(params, cfg, batch["dense"], batch["sparse"])
    return L.bce_with_logits(logits, batch["labels"])


def relevance_scores(params: Dict, cfg: RecsysConfig, dense, sparse_idx,
                     trust_scale: float = 5.0) -> torch.Tensor:
    """Trust-evaluator head: CTR probability scaled to [0, trust_scale]."""
    return torch.sigmoid(forward(params, cfg, dense, sparse_idx)) \
        * trust_scale
