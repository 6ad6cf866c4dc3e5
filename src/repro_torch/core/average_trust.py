"""Average-trustworthiness prior (paper §4.2-4.3).

After the deadline, remaining Drop Queue items are assigned an average
trustworthiness value: per-bucket EWMA priors (bucket = source-domain
hash), with ``n_buckets=1`` reproducing the paper's single global
average. Functional like the cache: ``update`` returns a new state.
"""
from __future__ import annotations

from typing import Dict

import torch


def init(n_buckets: int = 1, init_value: float = 2.5,
         device=None) -> Dict[str, torch.Tensor]:
    return {
        "mean": torch.full((n_buckets,), init_value, dtype=torch.float32,
                           device=device),
        "count": torch.zeros((n_buckets,), dtype=torch.float32,
                             device=device),
    }


def query(state: Dict, buckets: torch.Tensor) -> torch.Tensor:
    """buckets: (N,) int -> prior trust (N,) f32."""
    n = state["mean"].shape[0]
    return state["mean"][buckets.long() % n]


def update(state: Dict, buckets: torch.Tensor, values: torch.Tensor,
           mask: torch.Tensor, ewma: float = 0.05) -> Dict:
    """Fold observed trust values into the per-bucket means."""
    mean = state["mean"]
    n = mean.shape[0]
    b = buckets.long() % n
    m = mask.to(torch.float32)
    sums = torch.zeros_like(mean).index_add_(
        0, b, values.to(torch.float32) * m)
    cnts = torch.zeros_like(mean).index_add_(0, b, m)
    batch_mean = sums / cnts.clamp(min=1.0)
    new_mean = torch.where(cnts > 0,
                           (1 - ewma) * mean + ewma * batch_mean, mean)
    return {"mean": new_mean, "count": state["count"] + cnts}
