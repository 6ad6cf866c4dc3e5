"""Sparse embedding tables and single-hot lookup.

Counterpart of ``repro.models.recsys.embedding`` for what DLRM reads:
``ROW_PAD``, ``padded_rows``, ``table_init`` and ``lookup``. Tables are
``(padded_rows(vocab), dim)`` as in the reference.
"""
from __future__ import annotations

from typing import Dict

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
