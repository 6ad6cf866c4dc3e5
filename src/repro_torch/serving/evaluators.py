"""Trust evaluator backends in the shedder's ``evaluate(features)``
protocol: a dict of tensors (leading dim = items) -> (items,) scores.

Counterpart of ``repro.serving.evaluators.make_evaluator`` for every
arch of the registry: the transformers (``smollm-135m``, the default,
``qwen2.5-14b``, ``gemma2-2b``, ``moonshot-v1-16b-a3b`` and
``qwen3-moe-30b-a3b``), the GCN trust propagator (``gcn-cora``) and the
recommenders (``dlrm-mlperf``, ``bst``, ``mind`` and
``two-tower-retrieval``). Returns ``(evaluate, make_features)``;
``make_features(n, seed)`` makes numpy evaluator inputs for n items
(documents) exactly as the reference does, so both packages can score
the same documents.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import (GNNConfig, RecsysConfig,
                                      cap_table_rows)
from repro_torch.device import resolve
from repro_torch.models import gnn as G
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.recsys import bst, dlrm, mind, two_tower


def _params(cfg, seed: int, params, dev):
    """The port's parameter tree of ``cfg``: drawn from ``seed`` with a
    ``torch.Generator`` on ``dev``, or ``params`` converted (the
    reference's numpy tree; tensors of the port's own are kept as they
    are); a transformer's in its compute dtype."""
    if isinstance(cfg, RecsysConfig):
        if cfg.model not in _RECSYS:
            raise ValueError(f"no evaluator for recommender {cfg.model!r}")
        Mdl = _RECSYS[cfg.model][0]
    else:
        Mdl = G if isinstance(cfg, GNNConfig) else T
    if params is not None:
        if Mdl is T:
            return T.cast_params(T.params_from_jax(params, cfg, device=dev),
                                 L.dtype_of(cfg.dtype))
        return Mdl.params_from_jax(params, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if Mdl is T:
        return T.init_params(cfg, gen, device=dev,
                             dtype=L.dtype_of(cfg.dtype))
    return Mdl.init_params(cfg, gen, device=dev)


def _config(arch_id: str, smoke: bool, max_table_rows: int):
    cfg = get_config(arch_id, smoke=smoke)
    if isinstance(cfg, RecsysConfig):
        return cap_table_rows(cfg, max_table_rows) if max_table_rows \
            else cfg
    if max_table_rows:
        raise ValueError(f"max_table_rows applies to recommenders, not "
                         f"{arch_id}")
    return cfg


def make_evaluator(arch_id: str, *, smoke: bool = True, seed: int = 0,
                   trust_scale: float = 5.0, doc_len: int = 32,
                   params=None, device=None, max_table_rows: int = 0,
                   place_params: Optional[Callable] = None
                   ) -> Tuple[Callable, Callable]:
    """``params`` (optional) is the reference's parameter pytree with
    numpy leaves (``params_from_jax`` of the arch's model), or a tree of
    the port's own tensors, used as they are; without it the port draws
    its own weights from ``seed`` with a ``torch.Generator`` on
    ``device``. Transformer weights are built in (or cast once to) the
    compute dtype. ``max_table_rows`` (recommenders only) caps
    every embedding table at that many rows, as MLPerf DLRM's
    ``--max-ind-range`` does where the tables outgrow the card; 0 keeps
    the published rows. ``place_params(params, cfg) -> params``
    (optional) re-homes the built parameters — the mesh-sharding hook
    :func:`make_sharded_evaluator` uses. ``evaluate`` carries the
    weights it runs on as ``evaluate.params``, for checks that hold a
    layer of them against a plain version and for a sharded evaluator
    over the same tensors."""
    dev = resolve(device)
    cfg = _config(arch_id, smoke, max_table_rows)
    tparams = _params(cfg, seed, params, dev)
    if place_params is not None:
        tparams = place_params(tparams, cfg)
    evaluate, make_features = _evaluator(cfg, tparams, trust_scale,
                                         doc_len)
    evaluate.params = tparams
    return evaluate, make_features


def _evaluator(cfg, tparams, trust_scale: float, doc_len: int
               ) -> Tuple[Callable, Callable]:
    if isinstance(cfg, RecsysConfig):
        return _recsys_evaluator(cfg, tparams, trust_scale)
    if isinstance(cfg, GNNConfig):
        return _gnn_evaluator(cfg, tparams, trust_scale)
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


# Neighbours of each item's node in the GCN evaluator's star subgraphs.
GNN_DEGREE = 8


def _gnn_evaluator(cfg: GNNConfig, gparams, trust_scale: float
                   ) -> Tuple[Callable, Callable]:
    """Per-chunk star subgraphs: each item's node and its GNN_DEGREE
    neighbours, trust propagated from the neighbours' features. The edge
    ids are absolute node ids of the ``make_features`` batch, as the
    reference's: a chunk gathered out of a larger batch has ids past its
    own nodes, which ``models.gnn`` clamps and drops as the reference
    does."""
    deg = GNN_DEGREE

    @torch.no_grad()
    def evaluate(chunk: Dict[str, torch.Tensor]) -> torch.Tensor:
        n = chunk["x"].shape[0]
        x = chunk["x"].reshape(-1, cfg.d_feat)          # (n * (deg+1), F)
        ei = torch.stack([chunk["edge_src"].reshape(-1),
                          chunk["edge_dst"].reshape(-1)])
        scores = G.trust_scores(gparams, cfg, x, ei,
                                trust_scale=trust_scale)
        return scores[torch.arange(n, device=x.device) * (deg + 1)]

    def make_features(n: int, fseed: int = 0) -> Dict[str, np.ndarray]:
        r = np.random.default_rng(fseed)
        x = r.normal(size=(n, deg + 1, cfg.d_feat)).astype(np.float32)
        base = (np.arange(n) * (deg + 1))[:, None]
        src = (base + 1 + np.arange(deg)[None]).astype(np.int32)
        dst = np.broadcast_to(base, (n, deg)).astype(np.int32)
        return {"x": x, "edge_src": src, "edge_dst": dst}

    return evaluate, make_features


def _recsys_evaluator(cfg: RecsysConfig, tparams, trust_scale: float
                      ) -> Tuple[Callable, Callable]:
    Mdl, score, features = _RECSYS[cfg.model]

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


# ---------------------------------------------------------------------------
# Mesh-sharded evaluators
# ---------------------------------------------------------------------------

class ShardedEvaluator(NamedTuple):
    """Production-config evaluator bundle for the fused drain:
    ``evaluate`` (params mesh-sharded per ``distribution.sharding``),
    ``make_features``, the ``feature_sharding`` callable to hand to
    :class:`~repro_torch.core.fused_shedder.FusedLoadShedder` (and
    through ``ServingEngine(feature_sharding=...)``), and the mesh
    itself. ``evaluate.params`` is the DTensor parameter tree."""
    evaluate: Callable
    make_features: Callable
    feature_sharding: Callable
    mesh: Any


# Feature leaves every rank keeps whole: the two-tower chunk's query is
# its first user, whichever rank scores which items.
_WHOLE = {"two_tower": ("user_id", "user_feats")}


def make_sharded_evaluator(arch_id: str, *, mesh=None,
                           smoke: bool = False, seed: int = 0,
                           trust_scale: float = 5.0, doc_len: int = 32,
                           device=None, params=None,
                           max_table_rows: int = 0) -> ShardedEvaluator:
    """Mesh-sharded evaluator (default ``smoke=False``).

    Parameters are placed as DTensors with the arch family's
    ``distribution.sharding`` rules — heads, FFN hidden and vocab over
    the ``model`` axis for transformers, embedding tables row-sharded over
    (``data``, ``model``) for recommenders, the GCN replicated — and the
    forward runs on each rank's pieces with explicit collectives
    (``models.transformer``, ``models.recsys.embedding``). ``evaluate``
    takes the port's protocol (a dict of tensors, or of DTensors) and
    returns every item's score on every rank: the batch is split over the
    DP axes when its leading dim divides them, each rank scores its rows,
    and the scores are all-gathered. The GCN scores the whole batch on
    every rank: its star subgraphs carry absolute node ids, so a split
    would cut edges. ``feature_sharding(features)`` is the matching input
    placement: every leaf over the DP axes when its leading dim divides
    them, else replicated (the GCN's always replicated).

    ``mesh=None`` builds the (1, 1) host mesh on ``device`` (``cuda``
    unless named), creating the world of one if no process group exists
    (``launch.mesh.make_host_mesh``). ``params`` is a parameter tree of
    the port's own (the same tensors on every rank; for instance
    ``make_evaluator(...)[0].params``): it is sharded as it stands,
    without a copy, so a replicated and a sharded evaluator can share
    one set of tables. The MoE archs' experts are placed by the EP rule
    (``w_gate``/``w_up``/``w_down`` over ``model``) and the forward runs
    with the mesh ambient, so that their ``dispatch="ep_shard_map"``
    takes ``models.moe.moe_apply_ep``: each rank's experts see its own
    rows at the capacity of its own rows."""
    from repro_torch.distribution.placement import (
        NamedSharding, PartitionSpec as P, all_gather, batch_split,
        flat_coord, full_tensor, mesh_axes, split)
    from repro_torch.distribution.sharding import dp_axes, place_params
    from repro_torch.launch.mesh import make_host_mesh

    from repro_torch.distribution.constraints import use_mesh

    cfg = _config(arch_id, smoke, max_table_rows)
    dev = resolve(device)
    if mesh is None:
        mesh = make_host_mesh((1, 1), device=dev)
    placed = {}

    def place(params, cfg):
        # the DTensor tree is kept; the model sees whole leaves as plain
        # tensors and DTensors only where they are sharded
        placed["tree"] = place_params(params, cfg, mesh)
        return local_tree(placed["tree"])

    def local_tree(tree):
        if isinstance(tree, dict):
            return {k: local_tree(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [local_tree(v) for v in tree]
        local, sh = split(tree)
        return local if sh is None else tree

    inner, make_features = make_evaluator(
        arch_id, smoke=smoke, seed=seed, trust_scale=trust_scale,
        doc_len=doc_len, params=params, device=dev,
        max_table_rows=max_table_rows, place_params=place)
    dp = dp_axes(mesh)
    dp_size = int(np.prod([mesh.size(mesh.mesh_dim_names.index(a))
                           for a in dp])) if dp else 1
    dp_ranks = mesh_axes(mesh, dp)
    split_dp = not isinstance(cfg, GNNConfig)
    whole = _WHOLE.get(getattr(cfg, "model", None), ())

    def evaluate(chunk: Dict[str, torch.Tensor]) -> torch.Tensor:
        chunk = {k: full_tensor(v) for k, v in chunk.items()}
        n = next(iter(chunk.values())).shape[0]
        with use_mesh(mesh):
            if not (split_dp and dp_ranks and n % dp_size == 0):
                return inner(chunk)
            i, ways = flat_coord(dp_ranks)
            lo, hi = i * n // ways, (i + 1) * n // ways
            mine = {k: v if k in whole else v[lo:hi]
                    for k, v in chunk.items()}
            with batch_split(dp_ranks):
                return all_gather(inner(mine), dp_ranks, dim=0)

    evaluate.params = placed["tree"]

    def feature_sharding(features):
        def one(a):
            shape = np.shape(a)
            ax = dp if (split_dp and dp and len(shape) >= 1
                        and shape[0] % dp_size == 0) else None
            return NamedSharding(
                mesh, P(ax, *([None] * max(len(shape) - 1, 0))))
        return {k: one(v) for k, v in features.items()}

    return ShardedEvaluator(evaluate, make_features, feature_sharding, mesh)
