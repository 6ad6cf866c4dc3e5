"""Trust evaluator backends in the shedder's ``evaluate(features)``
protocol: a dict of tensors (leading dim = items) -> (items,) scores.

Counterpart of ``repro.serving.evaluators.make_evaluator`` for the
transformer archs (the default evaluator is ``smollm-135m``) and the
recommenders (``dlrm-mlperf``, ``bst``, ``mind`` and
``two-tower-retrieval``). Returns ``(evaluate, make_features)``;
``make_features(n, seed)`` makes numpy evaluator inputs for n items
(documents) exactly as the reference does, so both packages can score
the same documents.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import RecsysConfig, cap_table_rows
from repro_torch.device import resolve
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.recsys import bst, dlrm, mind, two_tower


def make_evaluator(arch_id: str, *, smoke: bool = True, seed: int = 0,
                   trust_scale: float = 5.0, doc_len: int = 32,
                   params=None, device=None,
                   max_table_rows: int = 0) -> Tuple[Callable, Callable]:
    """``params`` (optional) is the reference's parameter pytree with
    numpy leaves (``params_from_jax`` of the arch's model); without it
    the port draws its own weights from ``seed`` with a
    ``torch.Generator`` on ``device``. Transformer weights are cast to
    the compute dtype once. ``max_table_rows`` (recommenders only) caps
    every embedding table at that many rows, as MLPerf DLRM's
    ``--max-ind-range`` does where the tables outgrow the card; 0 keeps
    the published rows."""
    dev = resolve(device)
    cfg = get_config(arch_id, smoke=smoke)
    if isinstance(cfg, RecsysConfig):
        if max_table_rows:
            cfg = cap_table_rows(cfg, max_table_rows)
        return _recsys_evaluator(cfg, seed, trust_scale, params, dev)
    if max_table_rows:
        raise ValueError(f"max_table_rows applies to recommenders, not "
                         f"{arch_id}")
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        tparams = T.init_params(cfg, gen, device=dev)
    else:
        tparams = T.params_from_jax(params, cfg, device=dev)
    tparams = T.cast_params(tparams, L.dtype_of(cfg.dtype))
    log_vocab = math.log(float(cfg.vocab_size))

    @torch.no_grad()
    def evaluate(chunk: Dict[str, torch.Tensor]) -> torch.Tensor:
        # mean token logprob -> squashed to [0, trust_scale]
        lp = T.score_tokens(tparams, cfg, chunk["tokens"], q_chunk=doc_len)
        return torch.sigmoid(lp + log_vocab) * trust_scale

    def make_features(n: int, fseed: int = 0) -> Dict[str, np.ndarray]:
        r = np.random.default_rng(fseed)
        return {"tokens": r.integers(0, cfg.vocab_size,
                                     size=(n, doc_len)).astype(np.int32)}

    return evaluate, make_features


def _recsys_evaluator(cfg: RecsysConfig, seed: int, trust_scale: float,
                      params, dev) -> Tuple[Callable, Callable]:
    if cfg.model not in _RECSYS:
        raise ValueError(f"no evaluator for recommender {cfg.model!r}")
    Mdl, score, features = _RECSYS[cfg.model]
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        tparams = Mdl.init_params(cfg, gen, device=dev)
    else:
        tparams = Mdl.params_from_jax(params, device=dev)

    @torch.no_grad()
    def evaluate(chunk: Dict[str, torch.Tensor]) -> torch.Tensor:
        return score(Mdl, tparams, cfg, chunk, trust_scale)

    def make_features(n: int, fseed: int = 0) -> Dict[str, np.ndarray]:
        return features(cfg, np.random.default_rng(fseed), n)

    return evaluate, make_features


# Each recommender: its model module, its scores from a feature chunk,
# and the reference's feature draw for n items.

def _dlrm_scores(Mdl, p, cfg, chunk, scale):
    return Mdl.relevance_scores(p, cfg, chunk["dense"], chunk["sparse"],
                                trust_scale=scale)


def _dlrm_features(cfg, r, n):
    return {
        "dense": r.normal(size=(n, cfg.n_dense)).astype(np.float32),
        "sparse": np.stack([r.integers(0, t.vocab, size=n)
                            for t in cfg.tables], axis=1).astype(np.int32),
    }


def _bst_scores(Mdl, p, cfg, chunk, scale):
    return Mdl.relevance_scores(p, cfg, chunk["hist"], chunk["target"],
                                chunk["other"], trust_scale=scale)


def _bst_features(cfg, r, n):
    iv = cfg.tables[0].vocab
    return {
        "hist": r.integers(0, iv, size=(n, cfg.seq_len)).astype(np.int32),
        "target": r.integers(0, iv, size=n).astype(np.int32),
        "other": np.stack([r.integers(0, t.vocab, size=n)
                           for t in cfg.tables[1:]], axis=1
                          ).astype(np.int32),
    }


def _two_tower_scores(Mdl, p, cfg, chunk, scale):
    # one query (the chunk's first user) against every item of the chunk
    q = {"user_id": chunk["user_id"][:1],
         "user_feats": chunk["user_feats"][:1]}
    return Mdl.retrieval_scores(p, cfg, q, chunk["item_id"],
                                chunk["item_feats"], trust_scale=scale)[0]


def _two_tower_features(cfg, r, n):
    return {
        "user_id": np.full((n,), 1, np.int32),
        "user_feats": np.zeros((n, 8), np.int32),
        "item_id": r.integers(0, cfg.tables[1].vocab,
                              size=n).astype(np.int32),
        "item_feats": r.integers(0, cfg.tables[3].vocab,
                                 size=(n, 8)).astype(np.int32),
    }


def _mind_scores(Mdl, p, cfg, chunk, scale):
    return Mdl.relevance_scores(p, cfg, chunk["hist"], chunk["hist_mask"],
                                chunk["item"], trust_scale=scale)


def _mind_features(cfg, r, n):
    iv = cfg.tables[0].vocab
    return {
        "hist": r.integers(0, iv, size=(n, cfg.hist_len)).astype(np.int32),
        "hist_mask": np.ones((n, cfg.hist_len), np.float32),
        "item": r.integers(0, iv, size=n).astype(np.int32),
    }


_RECSYS = {
    "dlrm": (dlrm, _dlrm_scores, _dlrm_features),
    "bst": (bst, _bst_scores, _bst_features),
    "two_tower": (two_tower, _two_tower_scores, _two_tower_features),
    "mind": (mind, _mind_scores, _mind_features),
}
