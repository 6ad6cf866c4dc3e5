"""Sparse embedding tables, single-hot lookup and embedding bags.

Counterpart of ``repro.models.recsys.embedding``: ``ROW_PAD``,
``padded_rows``, ``table_init``, ``lookup``, ``embedding_bag`` (a
multi-hot ``(B, n_hot)`` bag) and ``ragged_embedding_bag`` (offsets-style
bags). Tables are ``(padded_rows(vocab), dim)`` as in the reference.

The ragged bag sums each bag's rows in index order, one elementwise add
a position, on every device: ``index_add_`` would add in no fixed order
on CUDA (atomics), so its bits would change run to run. The same order
is the reference's ``segment_sum`` order on the CPU.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import EmbeddingTableConfig
from repro_torch.models import layers as L

ROW_PAD = 512   # table rows padded so row-sharding divides any mesh axis
                # combination up to 512-way (the reference's layout)


def padded_rows(vocab: int) -> int:
    return ((vocab + ROW_PAD - 1) // ROW_PAD) * ROW_PAD


def table_init(cfg: EmbeddingTableConfig, generator: torch.Generator, *,
               device=None, dtype=torch.float32) -> Dict:
    """``1/sqrt(dim)`` truncated-normal rows, drawn where the table lives
    (``generator`` must be on ``device``)."""
    return {"table": L.trunc_normal((padded_rows(cfg.vocab), cfg.dim),
                                    cfg.dim ** -0.5, generator, device,
                                    dtype)}


def lookup(p: Dict, idx: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """Single-hot lookup. idx: (...,) integer -> (..., dim).

    Indices clip to the table's padded row count, as the reference's
    ``jnp.take(..., mode="clip")`` does. Rows are gathered first and cast
    after, so only the gathered rows are converted."""
    t = p["table"]
    flat = idx.reshape(-1).clamp(0, t.shape[0] - 1)
    e = t.index_select(0, flat).reshape(*idx.shape, t.shape[1])
    return e if compute_dtype is None else e.to(compute_dtype)


def embedding_bag(p: Dict, idx: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  combiner: str = "sum",
                  weights: Optional[torch.Tensor] = None,
                  compute_dtype=None) -> torch.Tensor:
    """Multi-hot bag reduce. idx: (B, n_hot) -> (B, dim).

    mask: (B, n_hot) 1.0 for valid entries; combiner in {sum, mean, max};
    weights: (B, n_hot) per-entry scale applied before the combiner."""
    if combiner not in ("sum", "mean", "max"):
        raise ValueError(f"unknown combiner {combiner!r}")
    e = lookup(p, idx, compute_dtype)                 # (B, n_hot, dim)
    if weights is not None:
        e = e * weights[..., None].to(e.dtype)
    m = (torch.ones(idx.shape, dtype=e.dtype, device=e.device)
         if mask is None else mask.to(e.dtype))[..., None]
    if combiner == "max":
        return torch.where(m > 0, e, torch.full_like(e, -1e30)).amax(dim=-2)
    s = (e * m).sum(dim=-2)
    if combiner == "mean":
        s = s / m.sum(dim=-2).clamp(min=1.0)
    return s


def ragged_embedding_bag(p: Dict, flat_idx: torch.Tensor,
                         segment_ids: torch.Tensor, n_bags: int,
                         combiner: str = "sum",
                         compute_dtype=None) -> torch.Tensor:
    """EmbeddingBag over a ragged (offsets-style) layout.

    flat_idx: (nnz,) indices; segment_ids: (nnz,) bag id of each index
    (ids outside ``[0, n_bags)`` are dropped, as ``segment_sum`` drops
    them). Returns (n_bags, dim); an empty bag is 0.

    The rows are laid out as a ``(n_bags, longest bag, dim)`` block in
    their original order within each bag (a stable sort by bag id), then
    reduced one position at a time: the same order, and bits, run after
    run on every device."""
    if combiner not in ("sum", "mean", "max"):
        raise ValueError(f"unknown combiner {combiner!r}")
    e = lookup(p, flat_idx, compute_dtype)            # (nnz, dim)
    seg = segment_ids.reshape(-1).long()
    keep = (seg >= 0) & (seg < n_bags)
    e, seg = e[keep], seg[keep]
    seg, order = torch.sort(seg, stable=True)
    e = e[order]
    counts = torch.bincount(seg, minlength=n_bags)
    start = torch.cumsum(counts, 0) - counts
    pos = torch.arange(len(seg), device=e.device) - start[seg]
    longest = max(int(counts.max()) if len(seg) else 0, 1)
    fill = float("-inf") if combiner == "max" else 0.0
    block = torch.full((n_bags, longest, e.shape[-1]), fill,
                       dtype=e.dtype, device=e.device)
    block[seg, pos] = e                               # one row per slot
    if combiner == "max":                             # empty bags -> 0
        out = block.amax(dim=1)
        return torch.where(torch.isfinite(out), out, 0.0)
    out = block[:, 0]
    for j in range(1, longest):
        out = out + block[:, j]
    if combiner == "mean":
        out = out / counts.to(e.dtype).clamp(min=1.0)[:, None]
    return out
