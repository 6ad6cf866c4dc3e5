"""Data pipelines: deterministic synthetic streams per arch family plus a
CSR neighbor sampler for GNN minibatch training.

Counterpart of ``repro.training.data``, a numpy copy: every generator
yields the reference's arrays bit for bit from the same ``(seed, step)``,
so a restart resumes on the exact batch sequence. Batches stay numpy;
the train step moves them to the device.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from repro_torch.configs.base import (GNNConfig, RecsysConfig,
                                     TransformerConfig)


def _rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


# ---------------------------------------------------------------------------
# LM tokens
# ---------------------------------------------------------------------------

def lm_batches(cfg: TransformerConfig, batch: int, seq: int,
               seed: int = 0, start_step: int = 0) -> Iterator[Dict]:
    step = start_step
    while True:
        r = _rng(seed, step)
        toks = r.integers(0, cfg.vocab_size, size=(batch, seq + 1),
                          dtype=np.int32)
        # Learnable structure: with prob 0.9 the next token is the
        # (prev*7+1) successor; 10% noise keeps the task non-degenerate.
        noise = r.random(size=(batch, seq)) < 0.1
        for t in range(1, seq + 1):
            succ = (toks[:, t - 1] * 7 + 1) % cfg.vocab_size
            toks[:, t] = np.where(noise[:, t - 1], toks[:, t], succ)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:],
               "mask": np.ones((batch, seq), np.float32)}
        step += 1


# ---------------------------------------------------------------------------
# RecSys batches
# ---------------------------------------------------------------------------

def recsys_batches(cfg: RecsysConfig, batch: int, seed: int = 0,
                   start_step: int = 0) -> Iterator[Dict]:
    step = start_step
    vocabs = [t.vocab for t in cfg.tables]
    while True:
        r = _rng(seed, step)
        if cfg.model == "dlrm":
            dense = r.normal(size=(batch, cfg.n_dense)).astype(np.float32)
            sparse = np.stack([r.integers(0, v, size=batch)
                               for v in vocabs], axis=1).astype(np.int32)
            w = np.sin(np.arange(cfg.n_dense))
            labels = (dense @ w + 0.1 * r.normal(size=batch) > 0)
            yield {"dense": dense, "sparse": sparse,
                   "labels": labels.astype(np.float32)}
        elif cfg.model == "bst":
            hist = r.integers(0, vocabs[0], size=(batch, cfg.seq_len),
                              dtype=np.int32)
            target = r.integers(0, vocabs[0], size=batch, dtype=np.int32)
            other = np.stack([r.integers(0, v, size=batch)
                              for v in vocabs[1:]], axis=1).astype(np.int32)
            labels = ((hist[:, -1] + target) % 2 == 0)
            yield {"hist": hist, "target": target, "other": other,
                   "labels": labels.astype(np.float32)}
        elif cfg.model == "two_tower":
            yield {
                "user_id": r.integers(0, vocabs[0], size=batch
                                      ).astype(np.int32),
                "user_feats": r.integers(0, vocabs[2], size=(batch, 8)
                                         ).astype(np.int32),
                "item_id": r.integers(0, vocabs[1], size=batch
                                      ).astype(np.int32),
                "item_feats": r.integers(0, vocabs[3], size=(batch, 8)
                                         ).astype(np.int32),
                "logq": np.zeros((batch,), np.float32),
            }
        elif cfg.model == "mind":
            hist = r.integers(0, vocabs[0], size=(batch, cfg.hist_len),
                              dtype=np.int32)
            lens = r.integers(1, cfg.hist_len + 1, size=batch)
            mask = (np.arange(cfg.hist_len)[None] < lens[:, None])
            yield {"hist": hist, "hist_mask": mask.astype(np.float32),
                   "target": r.integers(0, vocabs[0], size=batch
                                        ).astype(np.int32)}
        else:
            raise ValueError(cfg.model)
        step += 1


# ---------------------------------------------------------------------------
# Graphs: synthetic corpora + CSR neighbor sampler
# ---------------------------------------------------------------------------

def synthetic_graph(n_nodes: int, n_edges: int, d_feat: int,
                    n_classes: int, seed: int = 0,
                    homophily: float = 0.8) -> Dict[str, np.ndarray]:
    """Community graph: edges are intra-class with prob ``homophily`` —
    GCN propagation then helps (cora-like), unlike uniform random edges."""
    r = np.random.default_rng(seed)
    labels = r.integers(0, n_classes, size=n_nodes).astype(np.int32)
    src = r.integers(0, n_nodes, size=n_edges).astype(np.int32)
    dst = r.integers(0, n_nodes, size=n_edges).astype(np.int32)
    intra = r.random(n_edges) < homophily
    for c in range(n_classes):
        nodes_c = np.where(labels == c)[0]
        sel = intra & (labels[src] == c)
        if len(nodes_c) and sel.any():
            dst[sel] = nodes_c[r.integers(0, len(nodes_c),
                                          size=int(sel.sum()))]
    dst = dst.astype(np.int32)
    centers = r.normal(size=(n_classes, d_feat)).astype(np.float32)
    x = centers[labels] + 1.2 * r.normal(size=(n_nodes, d_feat)
                                         ).astype(np.float32)
    return {"x": x, "edge_index": np.stack([src, dst]),
            "labels": labels,
            "train_mask": (r.random(n_nodes) < 0.3).astype(np.float32)}


class CSRGraph:
    """CSR adjacency for host-side neighbor sampling."""

    def __init__(self, edge_index: np.ndarray, n_nodes: int):
        src, dst = edge_index
        order = np.argsort(dst, kind="stable")
        self.col = src[order].astype(np.int32)      # in-neighbors of dst
        counts = np.bincount(dst, minlength=n_nodes)
        self.ptr = np.zeros(n_nodes + 1, np.int64)
        np.cumsum(counts, out=self.ptr[1:])
        self.n_nodes = n_nodes

    def sample_neighbors(self, nodes: np.ndarray, fanout: int,
                         rng: np.random.Generator
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """Uniform with-replacement fanout sample.

        Returns (neighbors (len(nodes), fanout) int32,
                 mask (len(nodes), fanout) — 0 where the node is isolated).
        """
        starts = self.ptr[nodes]
        degs = self.ptr[nodes + 1] - starts
        safe_deg = np.maximum(degs, 1)
        offs = rng.integers(0, safe_deg[:, None],
                            size=(len(nodes), fanout))
        nbrs = self.col[(starts[:, None] + offs).astype(np.int64)
                        % max(len(self.col), 1)]
        mask = (degs > 0)[:, None] * np.ones((1, fanout))
        return nbrs.astype(np.int32), mask.astype(np.float32)


def sampled_subgraph_batches(graph: Dict[str, np.ndarray],
                             batch_nodes: int, fanout: Tuple[int, ...],
                             seed: int = 0, start_step: int = 0
                             ) -> Iterator[Dict]:
    """GraphSAGE-style k-hop sampled subgraphs, padded to static shapes.

    Layout: nodes = [batch | hop1 | hop2 ...]; edges connect each hop to
    its parents (direction: neighbor -> parent, matching GCN aggregation).
    """
    n = graph["x"].shape[0]
    csr = CSRGraph(graph["edge_index"], n)
    step = start_step
    # static sizes
    layer_sizes = [batch_nodes]
    for f in fanout:
        layer_sizes.append(layer_sizes[-1] * f)
    n_sub = sum(layer_sizes)
    n_sub_edges = sum(layer_sizes[i + 1] for i in range(len(fanout)))
    while True:
        r = _rng(seed, step)
        seeds = r.integers(0, n, size=batch_nodes).astype(np.int32)
        node_list = [seeds]
        edge_src, edge_dst, edge_m = [], [], []
        base = 0
        frontier = seeds
        for f in fanout:
            nbrs, m = csr.sample_neighbors(frontier, f, r)
            child_base = base + len(frontier)
            src_local = child_base + np.arange(nbrs.size, dtype=np.int32)
            dst_local = base + np.repeat(np.arange(len(frontier),
                                                   dtype=np.int32), f)
            node_list.append(nbrs.reshape(-1))
            edge_src.append(src_local)
            edge_dst.append(dst_local)
            edge_m.append(m.reshape(-1))
            base = child_base
            frontier = nbrs.reshape(-1)
        nodes = np.concatenate(node_list)
        assert len(nodes) == n_sub
        edge_index = np.stack([np.concatenate(edge_src),
                               np.concatenate(edge_dst)])
        yield {
            "x": graph["x"][nodes],
            "edge_index": edge_index.astype(np.int32),
            "edge_mask": np.concatenate(edge_m).astype(np.float32),
            "labels": graph["labels"][nodes],
            "label_mask": (np.arange(n_sub) < batch_nodes
                           ).astype(np.float32),
        }
        step += 1


def batched_molecule_batches(n_graphs: int, nodes_per_graph: int,
                             edges_per_graph: int, d_feat: int,
                             n_classes: int, seed: int = 0,
                             start_step: int = 0) -> Iterator[Dict]:
    step = start_step
    N = n_graphs * nodes_per_graph
    E = n_graphs * edges_per_graph
    while True:
        r = _rng(seed, step)
        x = r.normal(size=(N, d_feat)).astype(np.float32)
        offs = np.repeat(np.arange(n_graphs) * nodes_per_graph,
                         edges_per_graph)
        src = (r.integers(0, nodes_per_graph, size=E) + offs
               ).astype(np.int32)
        dst = (r.integers(0, nodes_per_graph, size=E) + offs
               ).astype(np.int32)
        yield {
            "x": x, "edge_index": np.stack([src, dst]),
            "graph_ids": np.repeat(np.arange(n_graphs),
                                   nodes_per_graph).astype(np.int32),
            "labels": r.integers(0, n_classes, size=n_graphs
                                 ).astype(np.int32),
        }
        step += 1
