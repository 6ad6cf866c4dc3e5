"""GCN message passing over an edge index: the trust propagator.

Counterpart of ``repro.models.gnn``: ``init_params``, ``propagate``,
``forward``, ``trust_scores`` and the training losses ``node_loss`` and
``graph_readout_loss``. ``forward`` and ``node_loss`` take the
reference's dropout: given a ``dropout_rng`` (a ``torch.Generator`` on
the features' device) and ``cfg.dropout`` p > 0, each hidden layer's
activations are kept with probability 1 - p and scaled by 1 / (1 - p);
``graph_readout_loss`` and the trust head run without it, as the
reference's. Message passing is gather -> edge message -> segment sum,
the reference's SpMM; autograd differentiates the ordered segment sums
(``torch.segment_reduce``'s backward) on both devices, and the max
aggregator's ``layers.segment_max`` splits its gradient over ties as
JAX does.

Two details follow the reference where plain torch indexing would not:
- Out-of-range node ids. The reference gathers ``x[src]``, ``deg[src]``
  and ``deg[dst]`` with ids clamped into ``[0, n)`` and its
  ``segment_sum`` drops messages whose ``dst`` is out of range. The
  evaluator's star subgraphs carry absolute node ids, which point past a
  chunk the fused drain gathered out of a larger batch; the port clamps
  and drops the same way, so such a chunk scores the same on both
  devices (and as the reference does) instead of raising.
- Order. Segment sums add each node's messages in edge order, one at a
  time (``layers.segment_sum``): no atomics, the same bits run after run
  on the card.

In the serving engine the GCN doubles as the trust-propagation evaluator:
the max-class logit is squashed to a trust score in [0, trust_scale].
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import GNNConfig
from repro_torch.models import layers as L


def init_params(cfg: GNNConfig, generator: torch.Generator,
                device=None) -> Dict:
    """Seeded init with the reference's shapes and scales (not its
    numbers): ``layers`` of biased dense maps d_feat -> d_hidden ... ->
    n_classes."""
    dt = L.dtype_of(cfg.param_dtype)
    dims = ([cfg.d_feat] + [cfg.d_hidden] * (cfg.n_layers - 1)
            + [cfg.n_classes])
    return {"layers": [L.dense_init(dims[i], dims[i + 1], generator,
                                    bias=True, device=device, dtype=dt)
                       for i in range(cfg.n_layers)]}


def params_from_jax(params, device=None) -> Dict:
    """The reference's parameter pytree (numpy leaves) as tensors."""
    return {"layers": [L.to_tensors(lp, device)
                       for lp in params["layers"]]}


def _degree(dst: torch.Tensor, n: int,
            edge_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """In-degree + 1 (the self loop) in float32; out-of-range ``dst``
    dropped."""
    ones = torch.ones(dst.shape, dtype=torch.float32, device=dst.device)
    if edge_mask is not None:
        ones = ones * edge_mask
    return L.segment_sum(ones, dst, n) + 1.0


def propagate(x: torch.Tensor, edge_index: torch.Tensor, *,
              norm: str = "sym", aggregator: str = "mean",
              edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One round of A~ X message passing with self loops.

    x: (N, F); edge_index: (2, E) integer rows (src, dst). ``edge_mask``
    zeroes padded edges."""
    n = x.shape[0]
    src, dst = edge_index[0].long(), edge_index[1].long()
    src_c, dst_c = src.clamp(0, n - 1), dst.clamp(0, n - 1)
    deg = _degree(dst, n, edge_mask)
    if norm == "sym":
        coef = torch.rsqrt(deg[src_c]) * torch.rsqrt(deg[dst_c])
        self_coef = 1.0 / deg
    elif norm == "rw":
        coef = 1.0 / deg[dst_c]
        self_coef = 1.0 / deg
    else:
        coef = torch.ones_like(deg[src_c])
        self_coef = torch.ones((n,), dtype=torch.float32, device=x.device)
    if edge_mask is not None:
        coef = coef * edge_mask
    msgs = x[src_c] * coef[:, None].to(x.dtype)
    if aggregator == "max":
        if edge_mask is not None:
            msgs = torch.where(edge_mask[:, None] > 0, msgs,
                               torch.full_like(msgs, float("-inf")))
        agg = L.segment_max(msgs, dst, n)
        agg = torch.where(torch.isfinite(agg), agg, torch.zeros_like(agg))
    else:           # mean/sum are both expressed through the norm coefficient
        agg = L.segment_sum(msgs, dst, n)
    return agg + x * self_coef[:, None].to(x.dtype)


def _keep_mask(shape, keep_prob: float,
               generator: torch.Generator, device) -> torch.Tensor:
    """Bernoulli(keep_prob) draws of ``shape`` (``jax.random.bernoulli``:
    a uniform draw below ``keep_prob``)."""
    u = torch.rand(shape, generator=generator, device=device)
    return u < keep_prob


def forward(params: Dict, cfg: GNNConfig, x: torch.Tensor,
            edge_index: torch.Tensor,
            edge_mask: Optional[torch.Tensor] = None,
            dropout_rng: Optional[torch.Generator] = None) -> torch.Tensor:
    """Node logits (N, n_classes); dropout on the hidden layers with a
    ``dropout_rng`` (see the module note)."""
    cdt = L.dtype_of(cfg.dtype)
    h = x.to(cdt)
    n_layers = len(params["layers"])
    for i, lp in enumerate(params["layers"]):
        h = propagate(h, edge_index, norm=cfg.norm,
                      aggregator=cfg.aggregator, edge_mask=edge_mask)
        h = L.dense_apply(lp, h, cdt)
        if i < n_layers - 1:
            h = torch.relu(h)
            if cfg.dropout > 0 and dropout_rng is not None:
                keep = _keep_mask(h.shape, 1 - cfg.dropout, dropout_rng,
                                  h.device)
                h = torch.where(keep, h / (1 - cfg.dropout),
                                torch.zeros((), dtype=h.dtype,
                                            device=h.device))
    return h


def node_loss(params: Dict, cfg: GNNConfig, x: torch.Tensor,
              edge_index: torch.Tensor, labels: torch.Tensor,
              label_mask: torch.Tensor,
              edge_mask: Optional[torch.Tensor] = None,
              dropout_rng: Optional[torch.Generator] = None
              ) -> torch.Tensor:
    """Masked node-classification CE."""
    logits = forward(params, cfg, x, edge_index, edge_mask, dropout_rng)
    return L.cross_entropy(logits, labels, label_mask)


def graph_readout_loss(params: Dict, cfg: GNNConfig, x: torch.Tensor,
                       edge_index: torch.Tensor, graph_ids: torch.Tensor,
                       n_graphs: int, labels: torch.Tensor,
                       edge_mask: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Batched small graphs: node logits mean-pooled per graph, CE."""
    logits = forward(params, cfg, x, edge_index, edge_mask)
    pooled = L.segment_sum(logits, graph_ids, n_graphs)
    counts = L.segment_sum(torch.ones((x.shape[0],), dtype=logits.dtype,
                                      device=x.device), graph_ids, n_graphs)
    return L.cross_entropy(pooled / counts.clamp(min=1.0)[:, None], labels)


def trust_scores(params: Dict, cfg: GNNConfig, x: torch.Tensor,
                 edge_index: torch.Tensor, trust_scale: float = 5.0,
                 edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Trust-propagation head: the max-class logit squashed to [0,
    trust_scale]."""
    logits = forward(params, cfg, x, edge_index, edge_mask)
    return torch.sigmoid(logits.to(torch.float32).amax(dim=-1)) * trust_scale
