"""End-to-end Trustworthy-IR pipeline (paper Fig. 1 with the Load Shedder).

Counterpart of ``repro.core.pipeline``; the searcher and the fidelity
metric are host numpy, the decision maker runs on the shedder's device.

User query -> Searcher (retrieves result URLs) -> Load Shedder (this
paper) -> Trust Evaluator (pluggable backbone) -> Quality subsystem ->
ranked trustworthy results.

The Searcher here is a synthetic corpus with per-query result-set sizes —
the experimental driver for overload ("book" retrieved 276k pages in the
paper). The *hidden* exact trust of each URL provides ground truth for the
trust-fidelity metric (the paper's "Trustworthiness" axis in Fig 3.1).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.configs.base import TrustIRConfig
from repro_torch.core import quality as Q
from repro_torch.core.shedder import LoadShedder, ShedResult, TIER_INVALID


@dataclass
class SearchResults:
    url_ids: np.ndarray          # (N,) uint32, nonzero
    buckets: np.ndarray          # (N,) int32 source-domain buckets
    features: Dict[str, np.ndarray]   # evaluator inputs, leading dim N
    quality_metrics: np.ndarray  # (N, 3) content/context/ratings in [0,1]
    exact_trust: np.ndarray      # (N,) hidden ground truth (benchmark only)


class SyntheticSearcher:
    """Synthetic corpus + query model.

    Each URL has a feature vector; the *exact* trust is a fixed nonlinear
    function of the features, so any evaluator that computes it exactly
    yields trust fidelity 5/5 and shedding-induced approximation shows up
    as fidelity loss, mirroring the paper's Fig 3.1 metric.
    """

    def __init__(self, corpus_size: int = 200_000, d_feat: int = 16,
                 n_domains: int = 256, seed: int = 0,
                 trust_scale: float = 5.0):
        rng = np.random.default_rng(seed)
        self.d_feat = d_feat
        self.trust_scale = trust_scale
        self.features = rng.normal(size=(corpus_size, d_feat)
                                   ).astype(np.float32)
        self.domains = rng.integers(0, n_domains,
                                    size=corpus_size).astype(np.int32)
        # domain-level base trust + per-URL variation
        dom_trust = rng.uniform(0.2, 0.95, size=n_domains)
        w = rng.normal(size=(d_feat,)).astype(np.float32) / np.sqrt(d_feat)
        sig = 1.0 / (1.0 + np.exp(-(self.features @ w)))
        t = 0.6 * dom_trust[self.domains] + 0.4 * sig
        self.exact_trust = (t * trust_scale).astype(np.float32)
        self.quality = rng.uniform(0.3, 1.0,
                                   size=(corpus_size, 3)).astype(np.float32)
        self._rng = rng

    def search(self, query: str, n_results: int) -> SearchResults:
        """Draw ``n_results`` corpus entries for ``query`` (seeded hash)."""
        h = abs(hash(query)) % (2 ** 31)
        rng = np.random.default_rng(h)
        idx = rng.choice(len(self.features), size=min(n_results,
                                                      len(self.features)),
                         replace=False)
        return SearchResults(
            url_ids=(idx.astype(np.uint32) + 1),      # 0 reserved = empty
            buckets=self.domains[idx],
            features={"x": self.features[idx]},
            quality_metrics=self.quality[idx],
            exact_trust=self.exact_trust[idx],
        )


def exact_oracle_evaluator(searcher: SyntheticSearcher) -> Callable:
    """Chunk evaluator that returns the exact trust (the ``trust``
    feature the pipeline attaches), in the port's evaluator protocol:
    a dict of tensors in, a tensor of scores out."""

    def evaluate(chunk: Dict[str, torch.Tensor]) -> torch.Tensor:
        return chunk["trust"] if "trust" in chunk else chunk["x"][:, 0]

    return evaluate


@dataclass
class PipelineOutput:
    shed: ShedResult
    ranked_idx: np.ndarray
    trust_fidelity: float        # paper Fig 3.1 "Trustworthiness" (0..5)
    response_time_s: float
    recall: float                # fraction of items answered (1.0 for ours)


class TrustIRPipeline:
    """Searcher -> Load Shedder -> Quality -> ranked results."""

    def __init__(self, cfg: TrustIRConfig, searcher: SyntheticSearcher,
                 shedder: LoadShedder, top_k: int = 10):
        self.cfg = cfg
        self.searcher = searcher
        self.shedder = shedder
        self.top_k = top_k

    def run_query(self, query: str, n_results: int) -> PipelineOutput:
        res = self.searcher.search(query, n_results)
        feats = dict(res.features)
        feats["trust"] = res.exact_trust   # oracle evaluators may use this
        shed = self.shedder.process(res.url_ids, res.buckets, feats)
        answered = shed.tier != TIER_INVALID
        fidelity = trust_fidelity(shed.trust, res.exact_trust, answered,
                                  self.searcher.trust_scale)
        dev = self.shedder.device
        decision = Q.decide(torch.as_tensor(shed.trust, device=dev),
                            torch.as_tensor(res.quality_metrics, device=dev),
                            self.cfg)
        ranked = Q.rank(decision["score"], self.top_k).cpu().numpy()
        return PipelineOutput(
            shed=shed, ranked_idx=ranked, trust_fidelity=fidelity,
            response_time_s=shed.response_time_s,
            recall=float(answered.mean()) if len(answered) else 1.0)


def trust_fidelity(assigned: np.ndarray, exact: np.ndarray,
                   answered: np.ndarray, scale: float = 5.0) -> float:
    """Paper Fig 3.1 "Trustworthiness" on a scale of ``scale``.

    Mean agreement between assigned and exact trust over *answered* items;
    unanswered (dropped — only RLS-EDA produces these) count as zero
    agreement, so dropping is penalized exactly as the paper argues.
    """
    if len(assigned) == 0:
        return scale
    err = np.abs(assigned - exact) / scale
    agree = np.where(answered, 1.0 - np.clip(err, 0.0, 1.0), 0.0)
    return float(scale * agree.mean())
