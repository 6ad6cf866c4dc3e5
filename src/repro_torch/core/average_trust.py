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


def _bucket_sums(b: torch.Tensor, x: torch.Tensor, n: int) -> torch.Tensor:
    """Per-bucket sums of ``x``. ``index_add_`` adds in index order on the
    CPU (the bits of the reference's ``segment_sum``), but with atomics,
    in no fixed order, on CUDA; there one masked reduction per bucket
    gives the same bits run after run, so a replay stays bit-identical."""
    if x.is_cuda:
        hit = b[:, None] == torch.arange(n, device=x.device)
        return torch.where(hit, x[:, None], 0.0).sum(dim=0)
    return torch.zeros(n, dtype=x.dtype, device=x.device).index_add_(0, b, x)


def update(state: Dict, buckets: torch.Tensor, values: torch.Tensor,
           mask: torch.Tensor, ewma: float = 0.05) -> Dict:
    """Fold observed trust values into the per-bucket means."""
    mean = state["mean"]
    n = mean.shape[0]
    b = buckets.long() % n
    m = mask.to(torch.float32)
    sums = _bucket_sums(b, values.to(torch.float32) * m, n)
    cnts = _bucket_sums(b, m, n)
    batch_mean = sums / cnts.clamp(min=1.0)
    new_mean = torch.where(cnts > 0,
                           (1 - ewma) * mean + ewma * batch_mean, mean)
    return {"mean": new_mean, "count": state["count"] + cnts}
