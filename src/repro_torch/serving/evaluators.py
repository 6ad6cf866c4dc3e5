"""Trust evaluator backends in the shedder's ``evaluate(features)``
protocol: a dict of tensors (leading dim = items) -> (items,) scores.

Counterpart of ``repro.serving.evaluators.make_evaluator`` for the
transformer archs (the default evaluator is ``smollm-135m``) and the
DLRM recommender (``dlrm-mlperf``). Returns ``(evaluate,
make_features)``; ``make_features(n, seed)`` makes numpy evaluator
inputs for n items (documents) exactly as the reference does, so both
packages can score the same documents.
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
    if cfg.model != "dlrm":
        raise ValueError(f"the port has no {cfg.model!r} evaluator yet")
    from repro_torch.models.recsys import dlrm as Mdl
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        tparams = Mdl.init_params(cfg, gen, device=dev)
    else:
        tparams = Mdl.params_from_jax(params, device=dev)

    @torch.no_grad()
    def evaluate(chunk: Dict[str, torch.Tensor]) -> torch.Tensor:
        return Mdl.relevance_scores(tparams, cfg, chunk["dense"],
                                    chunk["sparse"],
                                    trust_scale=trust_scale)

    def make_features(n: int, fseed: int = 0) -> Dict[str, np.ndarray]:
        r = np.random.default_rng(fseed)
        return {
            "dense": r.normal(size=(n, cfg.n_dense)).astype(np.float32),
            "sparse": np.stack(
                [r.integers(0, t.vocab, size=n) for t in cfg.tables],
                axis=1).astype(np.int32),
        }

    return evaluate, make_features
