"""MIND — Multi-Interest Network with Dynamic routing. [arXiv:1904.08030]

Counterpart of ``repro.models.recsys.mind`` (``init_params``,
``user_interests``, ``loss_fn``, ``relevance_scores``). Behavior-to-Interest (B2I)
dynamic routing extracts ``n_interests`` capsules from the user history;
serving scores an item by the max over interests. The routing runs in
float32 with the reference's ``-1e30`` history mask and its squash
``n2 / (1 + n2) * v * rsqrt(n2 + 1e-9)``. :func:`params_from_jax`
converts the reference's parameter pytree (as numpy arrays) into this
form.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import RecsysConfig
from repro_torch.models import layers as L
from repro_torch.models.recsys import embedding as E


def init_params(cfg: RecsysConfig, generator: torch.Generator,
                device=None) -> Dict:
    """Seeded init with the reference's shapes and scales (not its
    numbers), every tensor drawn on ``device`` by ``generator``."""
    dt = L.dtype_of(cfg.param_dtype)
    kw = dict(device=device, dtype=dt)
    d = cfg.embed_dim
    return {
        "tables": {t.name: E.table_init(t, generator, **kw)
                   for t in cfg.tables},
        "bilinear": L.trunc_normal((d, d), d ** -0.5, generator, device, dt),
        # fixed (non-trained) routing-logit init, as in the paper
        "routing_init": L.trunc_normal((cfg.n_interests, cfg.hist_len), 1.0,
                                       generator, device, dt),
        "interest_mlp": L.mlp_init((4 * d, d), d, generator, **kw),
    }


def params_from_jax(params, device=None) -> Dict:
    """The reference's parameter pytree (leaves as numpy arrays) as the
    port's tensors."""
    return L.to_tensors(params, device)


def _squash(v: torch.Tensor) -> torch.Tensor:
    v32 = v.to(torch.float32)
    n2 = v32.square().sum(dim=-1, keepdim=True)
    return ((n2 / (1.0 + n2)) * v32 * torch.rsqrt(n2 + 1e-9)).to(v.dtype)


def user_interests(params: Dict, cfg: RecsysConfig, hist: torch.Tensor,
                   hist_mask: torch.Tensor) -> torch.Tensor:
    """hist: (B, L) item ids; mask (B, L) -> interests (B, K, d)."""
    cdt = L.dtype_of(cfg.dtype)
    e = E.lookup(params["tables"]["item"], hist, cdt)        # (B, L, d)
    u = e @ params["bilinear"].to(cdt)                       # (B, L, d)
    B, Lh, d = u.shape
    K = cfg.n_interests
    b = params["routing_init"].to(torch.float32)[None].expand(B, K, Lh)
    u32 = u.to(torch.float32)
    m = hist_mask.to(torch.float32)[:, None, :]             # (B, 1, L)
    neg = torch.full((), -1e30, dtype=torch.float32, device=u.device)
    v = torch.zeros((B, K, d), dtype=torch.float32, device=u.device)
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(torch.where(m > 0, b, neg), dim=1)
        z = (w * m) @ u32                                    # (B, K, d)
        v = _squash(z)
        b = b + v @ u32.transpose(1, 2)                      # (B, K, L)
    # per-interest nonlinearity (H in the paper)
    return L.mlp_apply(params["interest_mlp"], v.to(cdt), final_act=True,
                       compute_dtype=cdt)


def loss_fn(params: Dict, cfg: RecsysConfig, batch: Dict,
            pow_p: float = 2.0) -> torch.Tensor:
    """Label-aware attention over the interests, then in-batch sampled
    softmax. batch: hist (B, L), hist_mask (B, L), target (B,)."""
    v = user_interests(params, cfg, batch["hist"], batch["hist_mask"])
    t = E.lookup(params["tables"]["item"], batch["target"], v.dtype)
    att = (v @ t[:, :, None])[..., 0].to(torch.float32)      # (B, K)
    w = torch.softmax(pow_p * att, dim=-1)
    u = (w.to(v.dtype)[:, None, :] @ v)[:, 0]                # (B, d)
    logits = u.to(torch.float32) @ t.to(torch.float32).T
    return L.cross_entropy(logits, torch.arange(u.shape[0],
                                                device=u.device))


def relevance_scores(params: Dict, cfg: RecsysConfig, hist, hist_mask,
                     item_ids, trust_scale: float = 5.0) -> torch.Tensor:
    """Serve: max-over-interests dot score for (B,) items -> [0, scale]."""
    v = user_interests(params, cfg, hist, hist_mask)          # (B, K, d)
    t = E.lookup(params["tables"]["item"], item_ids, v.dtype)  # (B, d)
    s = (v @ t[:, :, None])[..., 0].to(torch.float32).amax(dim=-1)
    return torch.sigmoid(s) * trust_scale
