"""Two-tower retrieval. [Yi et al., RecSys'19 (YouTube)]

Counterpart of ``repro.models.recsys.two_tower`` (inference:
``init_params``, ``user_embed``, ``item_embed``, ``retrieval_scores``).
User and item towers are MLPs over an id embedding beside a mean bag of
multi-hot feature embeddings; retrieval scores 1..B queries against N
candidates with one (N, d) matmul. Each tower's output is divided by its
float32 norm cast back and clipped at 1e-6, as in the reference.
:func:`params_from_jax` converts the reference's parameter pytree (as
numpy arrays) into this form.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import RecsysConfig
from repro_torch.models import layers as L
from repro_torch.models.recsys import embedding as E

N_USER_HOT = 8      # multi-hot user feature slots
N_ITEM_HOT = 8      # multi-hot item feature slots


def init_params(cfg: RecsysConfig, generator: torch.Generator,
                device=None) -> Dict:
    """Seeded init with the reference's shapes and scales (not its
    numbers), every tensor drawn on ``device`` by ``generator``."""
    dt = L.dtype_of(cfg.param_dtype)
    kw = dict(device=device, dtype=dt)
    dims = tuple(cfg.tower_mlp) + (cfg.embed_dim,)
    return {
        "tables": {t.name: E.table_init(t, generator, **kw)
                   for t in cfg.tables},
        "user_tower": L.mlp_init(dims, 2 * cfg.embed_dim, generator, **kw),
        "item_tower": L.mlp_init(dims, 2 * cfg.embed_dim, generator, **kw),
    }


def params_from_jax(params, device=None) -> Dict:
    """The reference's parameter pytree (leaves as numpy arrays) as the
    port's tensors."""
    return L.to_tensors(params, device)


def _tower(params: Dict, cfg: RecsysConfig, side: str, ids: torch.Tensor,
           feats: torch.Tensor) -> torch.Tensor:
    cdt = L.dtype_of(cfg.dtype)
    emb = E.lookup(params["tables"][f"{side}_id"], ids, cdt)
    bag = E.embedding_bag(params["tables"][f"{side}_feats"], feats,
                          combiner="mean", compute_dtype=cdt)
    v = L.mlp_apply(params[f"{side}_tower"], torch.cat([emb, bag], dim=-1),
                    compute_dtype=cdt)
    norm = v.to(torch.float32).norm(dim=-1, keepdim=True).to(cdt)
    return v / norm.clamp(min=1e-6)


def user_embed(params: Dict, cfg: RecsysConfig, user_id: torch.Tensor,
               user_feats: torch.Tensor) -> torch.Tensor:
    """user_id: (B,); user_feats: (B, N_USER_HOT) -> (B, d) L2-normed."""
    return _tower(params, cfg, "user", user_id, user_feats)


def item_embed(params: Dict, cfg: RecsysConfig, item_id: torch.Tensor,
               item_feats: torch.Tensor) -> torch.Tensor:
    """item_id: (N,); item_feats: (N, N_ITEM_HOT) -> (N, d) L2-normed."""
    return _tower(params, cfg, "item", item_id, item_feats)


def retrieval_scores(params: Dict, cfg: RecsysConfig, query: Dict,
                     cand_item_id: torch.Tensor,
                     cand_item_feats: torch.Tensor,
                     trust_scale: float = 5.0) -> torch.Tensor:
    """Score 1..B queries against N candidates: (B, N) in [0, scale]."""
    u = user_embed(params, cfg, query["user_id"], query["user_feats"])
    c = item_embed(params, cfg, cand_item_id, cand_item_feats)  # (N, d)
    sim = u.to(torch.float32) @ c.to(torch.float32).T           # (B, N)
    return (sim * 0.5 + 0.5) * trust_scale
