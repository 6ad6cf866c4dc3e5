"""Quality subsystem (paper §4, after the Load Shedder), on torch tensors.

Counterpart of ``repro.core.quality``. Filtered URLs are scored on three
metrics — Content, Context, Ratings — and the Decision Maker combines
them with weight factors, composing the final quality level with the
trust value.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import TrustIRConfig


def quality_level(metrics: torch.Tensor,
                  weights: Tuple[float, float, float]) -> torch.Tensor:
    """metrics: (N, 3) content/context/ratings in [0, 1] -> (N,) in [0, 5]."""
    w = torch.as_tensor(weights, dtype=torch.float32, device=metrics.device)
    w = w / torch.sum(w)
    return 5.0 * metrics.to(torch.float32) @ w


def decide(trust: torch.Tensor, metrics: torch.Tensor,
           cfg: TrustIRConfig, trust_weight: float = 0.5,
           min_trust: float = 0.0) -> Dict[str, torch.Tensor]:
    """Decision Maker: final ranking score + trust filter mask."""
    q = quality_level(metrics, cfg.quality_weights)
    score = trust_weight * trust + (1 - trust_weight) * q
    keep = trust >= min_trust
    return {"quality": q,
            "score": torch.where(keep, score,
                                 torch.full_like(score, -float("inf"))),
            "keep": keep}


def rank(scores: torch.Tensor, top_k: int = 10) -> torch.Tensor:
    """Indices of the top-k results by decision score (a stable sort, so
    equal scores keep their order, as ``jnp.argsort`` does)."""
    k = min(top_k, scores.shape[0])
    return torch.argsort(-scores, stable=True)[:k]
