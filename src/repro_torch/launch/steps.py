"""Per-(arch × shape) step builders: the mesh cells of the dry-run.

Counterpart of ``repro.launch.steps``. ``build_cell(arch_id, shape_name,
mesh)`` returns a ``Cell`` carrying:
  * ``step_fn``        — the step one rank runs on its local pieces,
  * ``abstract_args``  — meta tensors of every input's global shape and
                         dtype (``input_specs()`` — no allocation),
  * ``in_shardings`` / ``out_shardings`` — PartitionSpec trees
                         (``distribution.placement``),
  * ``donate_argnums`` — the inputs the step updates in place (state, KV
                         cache),
  * ``loop_multiplier``— the layer count (the reference's scan trip count),
  * ``meta``           — model/active params, token counts, the useful
                         forward FLOPs.

Shape kinds map to steps as the reference's: ``train`` -> a train step
(fwd+bwd+AdamW), ``prefill`` -> prefill scoring, ``decode`` -> one token
against a KV cache, recsys ``serve``/``retrieval`` -> forward scoring,
graph kinds -> their train steps. ``mesh`` is a ``DeviceMesh``, or any
object with the reference's ``axis_names`` and ``shape`` (enough to build
a cell; running its step takes a ``DeviceMesh``).

How a step runs. Where the reference hands XLA one global program, here
every rank runs ``step_fn`` on its own pieces (:func:`local_pieces` cuts
them from global values by ``in_shardings``), with the mesh ambient
(``constraints.use_mesh``) and the batch rows split over the DP axes
(``placement.batch_split``); parameters sharded over an axis of more
than one rank reach the model as DTensors (:func:`sharded_view`), whose
pieces the model code computes on with explicit collectives. Train steps
backpropagate their loss divided by the mesh's ranks, sum the gradient
of each leaf over the axes it is replicated on (the collectives'
backward keeps a replicated tensor's cotangent as per-rank partial sums,
``distribution.placement``), clip by the norm of the whole tree and run
AdamW on the local pieces. The LM loss divides by the mask weight of the
whole batch, the MoE router's means are the whole batch's
(``models.moe``), and the in-batch softmax of two-tower and MIND scores
each row against every rank's items. Prefill keeps, and decode attends
over, this rank's piece of the cache's sequence (the SP layout of
``lm_batch_specs``), the ranks' partial outputs merged by their
log-sum-exps (``models.transformer``). Graph steps gather the node
features and edges over the DP axes (the edges carry absolute node ids)
and each rank's loss covers its own labelled rows. On a mesh of one rank
every step runs exactly the replicated step's operations.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs import get_bundle
from repro_torch.configs.base import (GNNConfig, RecsysConfig, ShapeSpec,
                                      TransformerConfig, reduced)
from repro_torch.distribution import sharding as SH
from repro_torch.distribution.constraints import use_mesh
from repro_torch.distribution.placement import (PartitionSpec as P,
                                                all_gather, all_reduce,
                                                batch_axes, batch_split,
                                                flat_coord, is_dtensor,
                                                mesh_axes, placements_of,
                                                spec_axes)
from repro_torch.models import layers as L
from repro_torch.training import optimizer as O
from repro_torch.training import train_loop as TL
from repro_torch.training.tree import leaves

OPT_CFG = O.AdamWConfig(lr=3e-4, warmup_steps=100, total_steps=10_000)

# per-shape GNN dataset parameters (classes follow the public datasets)
GNN_CLASSES = {"full_graph_sm": 7, "minibatch_lg": 41,
               "ogb_products": 47, "molecule": 2}


@dataclass
class Cell:
    arch_id: str
    shape: ShapeSpec
    step_fn: Callable
    abstract_args: Tuple
    in_shardings: Any
    out_shardings: Any
    donate_argnums: Tuple[int, ...]
    loop_multiplier: int
    meta: Dict[str, Any]


def _sds(shape, dtype) -> torch.Tensor:
    """A shape-and-dtype stand-in (a meta tensor: no memory)."""
    return torch.empty(shape, dtype=dtype, device="meta")


def _abstract_params(init_fn) -> Any:
    return init_fn(None, device="meta")


def _abstract_state(params_shape) -> TL.TrainState:
    return TL.TrainState(params=params_shape, opt=O.adamw_init(params_shape),
                         ef=None)


def _state_specs(cfg, params_shape, mesh) -> TL.TrainState:
    pspec = SH.param_specs(cfg, params_shape, mesh)
    return TL.TrainState(params=pspec,
                         opt=O.AdamWState(step=P(), m=pspec, v=pspec),
                         ef=None)


# ---------------------------------------------------------------------------
# Local pieces and the sharded step
# ---------------------------------------------------------------------------

def _map_specs(fn: Callable, tree, specs):
    """``fn(leaf, spec)`` over ``tree`` and its spec tree (a spec, or
    None, covers the whole subtree below it)."""
    if specs is None or isinstance(specs, P):
        if isinstance(tree, dict):
            return {k: _map_specs(fn, v, specs) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            out = [_map_specs(fn, v, specs) for v in tree]
            return type(tree)(*out) if hasattr(tree, "_fields") \
                else type(tree)(out)
        return tree if tree is None else fn(tree, specs)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v, specs[k]) for k, v in tree.items()}
    out = [_map_specs(fn, v, s) for v, s in zip(tree, specs)]
    return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)


def _entry_axes(mesh, s):
    """The mesh axes of more than one rank of one spec entry."""
    return mesh_axes(mesh, spec_axes(s))


def local_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """This rank's piece's shape of a global ``shape`` under ``spec``."""
    out = list(shape)
    for d, s in enumerate(spec or ()):
        ways = math.prod(SH.axis_size(mesh, a) for a in spec_axes(s)
                         if a in SH.axis_names(mesh))
        if out[d] % ways:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide "
                             f"over {s!r} ({ways} ranks)")
        out[d] //= ways
    return tuple(out)


def local_pieces(tree, specs, mesh):
    """This rank's pieces (views) of the global values ``tree`` by their
    ``specs``; a dim over axes of one rank stays whole."""
    def piece(t, spec):
        for d, s in enumerate(spec or ()):
            axes = _entry_axes(mesh, s)
            if axes:
                i, ways = flat_coord(axes)
                n = t.shape[d] // ways
                t = t.narrow(d, i * n, n)
        return t
    return _map_specs(piece, tree, specs)


def global_values(tree, specs, mesh):
    """The global values of this rank's pieces ``tree`` (the inverse of
    :func:`local_pieces`): every sharded dim gathered over its axes."""
    def whole(t, spec):
        for d, s in enumerate(spec or ()):
            t = all_gather(t, _entry_axes(mesh, s), dim=d)
        return t
    return _map_specs(whole, tree, specs)


def local_abstract(cell: Cell, mesh, device) -> Tuple:
    """Empty tensors of this rank's pieces of ``cell.abstract_args`` on
    ``device`` (under ``FakeTensorMode``, fake ones: no memory)."""
    def one(t, spec):
        return torch.empty(local_shape(t.shape, spec, mesh), dtype=t.dtype,
                           device=device)
    return tuple(_map_specs(one, a, s)
                 for a, s in zip(cell.abstract_args, cell.in_shardings))


def sharded_view(params, specs, mesh):
    """``params`` (this rank's pieces) as the model sees them: a piece
    sharded over an axis of more than one rank as a DTensor of its spec
    (differentiable: its gradient reaches the piece), the rest as they
    are."""
    from torch.distributed.tensor import DTensor

    def one(t, spec):
        if is_dtensor(t) or not any(_entry_axes(mesh, s) for s in spec):
            return t
        return DTensor.from_local(t, mesh, placements_of(spec, mesh),
                                  run_check=False)
    return _map_specs(one, params, specs)


def _real_axes(mesh, names) -> list:
    if not hasattr(mesh, "mesh_dim_names"):
        raise TypeError("running a cell's step takes a DeviceMesh")
    return mesh_axes(mesh, names)


@contextlib.contextmanager
def _on_mesh(mesh, split_rows: bool = True):
    """The mesh ambient, and the batch rows split over its DP axes."""
    dp = _real_axes(mesh, SH.dp_axes(mesh)) if split_rows else []
    with use_mesh(mesh), batch_split(dp):
        yield dp


def _grad_sync(pspec, params_shape, mesh) -> Any:
    """The ``TL.GradSync`` of a train step on ``mesh`` (None on a mesh of
    one rank: the replicated step)."""
    every = _real_axes(mesh, SH.axis_names(mesh))
    if not every:
        return None
    dp = _real_axes(mesh, SH.dp_axes(mesh))
    n_dp = math.prod(a.size for a in dp)
    specs = leaves(pspec, is_leaf=lambda s: isinstance(s, P))
    sharded = [{a.name for s in spec for a in _entry_axes(mesh, s)}
               for spec in specs]
    replicated = [[a for a in every if a.name not in names]
                  for names in sharded]

    def grads(acc):
        return [all_reduce(g, ax) if ax else g
                for g, ax in zip(acc, replicated)]

    def loss(x):
        return all_reduce(x.clone(), dp) / n_dp if dp else x

    norm_axes = [[a for a in every if a.name in names] for names in sharded]
    return TL.GradSync(scale=1.0 / math.prod(a.size for a in every),
                       grads=grads, loss=loss, norm_axes=norm_axes)


def _train_step(loss_fn: Callable, cfg, params_shape, mesh,
                split_rows: bool = True) -> Callable:
    """``step(state, batch)`` of one rank: ``loss_fn(view, batch)`` on the
    sharded view of its parameters (see the module note)."""
    pspec = SH.param_specs(cfg, params_shape, mesh)

    def step(state, batch):
        sync = _grad_sync(pspec, params_shape, mesh)

        def local_loss(params, b):
            with _on_mesh(mesh, split_rows):
                return loss_fn(sharded_view(params, pspec, mesh), b)

        return TL.make_train_step(local_loss, OPT_CFG, sync=sync)(state,
                                                                  batch)
    return step


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def _lm_cell(cfg: TransformerConfig, shape: ShapeSpec, mesh,
             arch_id: str) -> Cell:
    from repro_torch.models import transformer as T
    dp = SH.dp_axes(mesh)
    params_shape = _abstract_params(partial(T.init_params, cfg))
    pspec = SH.param_specs(cfg, params_shape, mesh)
    tokens_per_step = shape.global_batch * max(shape.seq_len, 1)
    if shape.kind == "decode":
        tokens_per_step = shape.global_batch      # one new token per row
    meta = {"family": "lm", "n_params": cfg.n_params(),
            "n_active_params": cfg.n_active_params(),
            "tokens": tokens_per_step, "cfg": cfg,
            # 2·N_active·D (fwd); train cells x3 in the roofline
            "useful_flops_fwd": 2.0 * cfg.n_active_params()
            * tokens_per_step}

    if shape.kind == "train":
        B, S = shape.global_batch, shape.seq_len

        def loss_fn(p, batch):
            # the mask weight of the whole batch: every DP rank's mean
            # then averages to the reference's loss
            dp_ranks = _real_axes(mesh, dp)
            weight = None
            if dp_ranks:
                weight = all_reduce(batch["mask"].to(torch.float32).sum(),
                                    dp_ranks) / math.prod(
                    a.size for a in dp_ranks)
            return T.lm_loss(p, cfg, batch["tokens"], batch["labels"],
                             batch["mask"], q_chunk=1024, loss_chunk=512,
                             weight=weight)

        step = _train_step(loss_fn, cfg, params_shape, mesh)
        state_shape = _abstract_state(params_shape)
        batch_shape = {"tokens": _sds((B, S), torch.int32),
                       "labels": _sds((B, S), torch.int32),
                       "mask": _sds((B, S), torch.float32)}
        state_spec = _state_specs(cfg, params_shape, mesh)
        batch_spec = SH.lm_batch_specs(shape, mesh)
        return Cell(arch_id, shape, step, (state_shape, batch_shape),
                    (state_spec, batch_spec), (state_spec, None),
                    donate_argnums=(0,),
                    loop_multiplier=cfg.n_layers, meta=meta)

    if shape.kind == "prefill":
        B, S = shape.global_batch, shape.seq_len

        def prefill_step(p, tokens):
            with _on_mesh(mesh):
                return T.prefill(sharded_view(p, pspec, mesh), cfg, tokens,
                                 q_chunk=2048,
                                 seq_axes=_real_axes(mesh, ("model",)))

        batch_spec = SH.lm_batch_specs(shape, mesh)
        cache_spec = {"k": P(None, dp, "model", None, None),
                      "v": P(None, dp, "model", None, None),
                      "lengths": P(dp)}
        return Cell(arch_id, shape, prefill_step,
                    (params_shape, _sds((B, S), torch.int32)),
                    (pspec, batch_spec["tokens"]),
                    (P(dp), cache_spec),
                    donate_argnums=(),
                    loop_multiplier=cfg.n_layers, meta=meta)

    if shape.kind == "decode":
        B, L = shape.global_batch, shape.seq_len
        cdt = _dtype(cfg.dtype)
        cache_shape = {
            "k": _sds((cfg.n_layers, B, L, cfg.n_kv_heads, cfg.d_head), cdt),
            "v": _sds((cfg.n_layers, B, L, cfg.n_kv_heads, cfg.d_head), cdt),
            "lengths": _sds((B,), torch.int32),
        }
        specs = SH.lm_batch_specs(shape, mesh)
        seq_names = spec_axes(specs["cache"]["k"][2])

        def decode(p, token, cache):
            with _on_mesh(mesh, split_rows=B > 1):
                return T.decode_step(sharded_view(p, pspec, mesh), cfg,
                                     token, cache,
                                     seq_axes=_real_axes(mesh, seq_names))

        # logits (B, V): batch over dp (if batched), vocab over model
        logits_spec = (P(dp, "model") if shape.global_batch > 1
                       else P(None, "model"))
        return Cell(arch_id, shape, decode,
                    (params_shape, _sds((B,), torch.int32), cache_shape),
                    (pspec, specs["token"], specs["cache"]),
                    (logits_spec, specs["cache"]),
                    donate_argnums=(2,),
                    loop_multiplier=cfg.n_layers, meta=meta)

    raise ValueError(shape.kind)


# ---------------------------------------------------------------------------
# RecSys cells
# ---------------------------------------------------------------------------

def _recsys_loss(cfg: RecsysConfig):
    if cfg.model == "dlrm":
        from repro_torch.models.recsys import dlrm as M
    elif cfg.model == "bst":
        from repro_torch.models.recsys import bst as M
    elif cfg.model == "two_tower":
        from repro_torch.models.recsys import two_tower as M
    elif cfg.model == "mind":
        from repro_torch.models.recsys import mind as M
    else:
        raise ValueError(cfg.model)
    return M


def _recsys_batch_shapes(cfg: RecsysConfig, n: int, train: bool) -> Dict:
    i32, f32 = torch.int32, torch.float32
    if cfg.model == "dlrm":
        b = {"dense": _sds((n, cfg.n_dense), f32),
             "sparse": _sds((n, len(cfg.tables)), i32)}
        if train:
            b["labels"] = _sds((n,), f32)
    elif cfg.model == "bst":
        b = {"hist": _sds((n, cfg.seq_len), i32),
             "target": _sds((n,), i32),
             "other": _sds((n, len(cfg.tables) - 1), i32)}
        if train:
            b["labels"] = _sds((n,), f32)
    elif cfg.model == "two_tower":
        b = {"user_id": _sds((n,), i32), "user_feats": _sds((n, 8), i32),
             "item_id": _sds((n,), i32), "item_feats": _sds((n, 8), i32)}
        if train:
            b["logq"] = _sds((n,), f32)
    elif cfg.model == "mind":
        b = {"hist": _sds((n, cfg.hist_len), i32),
             "hist_mask": _sds((n, cfg.hist_len), f32),
             "target": _sds((n,), i32)}
    else:
        raise ValueError(cfg.model)
    return b


def _in_batch_ce(u: torch.Tensor, items: torch.Tensor, dp,
                 temperature: float = 1.0, logq=None):
    """The in-batch softmax CE of this rank's rows ``u`` (B, d) against
    the items of every DP rank's rows (gathered, differentiable); row i's
    positive is its own item."""
    every = all_gather(items.to(torch.float32), dp, dim=0)
    logits = u.to(torch.float32) @ every.T
    if temperature != 1.0:
        logits = logits / temperature
    if logq is not None:
        logits = logits - all_gather(logq.to(torch.float32), dp, dim=0)[None]
    i, _ = flat_coord(dp)
    rows = torch.arange(u.shape[0], device=u.device) + i * u.shape[0]
    return L.cross_entropy(logits, rows)


def _sharded_recsys_loss(M, cfg: RecsysConfig):
    """``M.loss_fn``, with the in-batch softmax of two-tower and MIND over
    the whole batch where the rows are split over DP ranks."""
    from repro_torch.models.recsys import embedding as E

    def loss(p, b):
        dp = list(batch_axes())
        if not dp or cfg.model not in ("two_tower", "mind"):
            return M.loss_fn(p, cfg, b)
        if cfg.model == "two_tower":
            u = M.user_embed(p, cfg, b["user_id"], b["user_feats"])
            i = M.item_embed(p, cfg, b["item_id"], b["item_feats"])
            return _in_batch_ce(u, i, dp, 0.05, b["logq"])
        v = M.user_interests(p, cfg, b["hist"], b["hist_mask"])
        t = E.lookup(p["tables"]["item"], b["target"], v.dtype)
        att = (v @ t[:, :, None])[..., 0].to(torch.float32)
        w = torch.softmax(2.0 * att, dim=-1)
        u = (w.to(v.dtype)[:, None, :] @ v)[:, 0]
        return _in_batch_ce(u, t, dp)
    return loss


def _recsys_cell(cfg: RecsysConfig, shape: ShapeSpec, mesh,
                 arch_id: str) -> Cell:
    M = _recsys_loss(cfg)
    dp = SH.dp_axes(mesh)
    params_shape = _abstract_params(partial(M.init_params, cfg))
    pspec = SH.param_specs(cfg, params_shape, mesh)
    items = shape.batch or shape.n_candidates
    # dense (non-table) params drive per-item compute; each item also
    # reads ~n_fields embedding rows
    table_params = sum(t.vocab * t.dim * t.count for t in cfg.tables)
    dense_params = cfg.n_params() - table_params
    emb_reads = sum(t.dim for t in cfg.tables)
    meta = {"family": "recsys", "n_params": cfg.n_params(),
            "n_active_params": dense_params + emb_reads, "cfg": cfg,
            "tokens": items,
            "useful_flops_fwd": 2.0 * (dense_params + emb_reads) * items}

    if shape.kind == "train":
        step = _train_step(_sharded_recsys_loss(M, cfg), cfg, params_shape,
                           mesh)
        state_shape = _abstract_state(params_shape)
        state_spec = _state_specs(cfg, params_shape, mesh)
        batch_shape = _recsys_batch_shapes(cfg, shape.batch, train=True)
        batch_spec = SH.recsys_batch_specs(cfg, shape, mesh)
        return Cell(arch_id, shape, step, (state_shape, batch_shape),
                    (state_spec, batch_spec), (state_spec, None),
                    donate_argnums=(0,), loop_multiplier=1, meta=meta)

    if shape.kind == "serve":
        n = shape.batch
        batch_shape = _recsys_batch_shapes(cfg, n, train=False)
        batch_spec = SH.recsys_batch_specs(cfg, shape, mesh)

        if cfg.model == "dlrm":
            def score(p, b):
                return M.relevance_scores(p, cfg, b["dense"], b["sparse"])
        elif cfg.model == "bst":
            def score(p, b):
                return M.relevance_scores(p, cfg, b["hist"], b["target"],
                                          b["other"])
        elif cfg.model == "two_tower":
            def score(p, b):
                u = M.user_embed(p, cfg, b["user_id"], b["user_feats"])
                i = M.item_embed(p, cfg, b["item_id"], b["item_feats"])
                return torch.sum(u * i, dim=-1)
        else:  # mind
            def score(p, b):
                return M.relevance_scores(p, cfg, b["hist"],
                                          b["hist_mask"], b["target"])

        @torch.no_grad()
        def serve(p, b):
            with _on_mesh(mesh):
                return score(sharded_view(p, pspec, mesh), b)

        return Cell(arch_id, shape, serve, (params_shape, batch_shape),
                    (pspec, batch_spec), P(dp),
                    donate_argnums=(), loop_multiplier=1, meta=meta)

    if shape.kind == "retrieval":
        N = shape.n_candidates
        i32, f32 = torch.int32, torch.float32
        if cfg.model == "two_tower":
            args_shape = {
                "query": {"user_id": _sds((1,), i32),
                          "user_feats": _sds((1, 8), i32)},
                "cand_item_id": _sds((N,), i32),
                "cand_item_feats": _sds((N, 8), i32)}

            def retr(p, a):
                return M.retrieval_scores(p, cfg, a["query"],
                                          a["cand_item_id"],
                                          a["cand_item_feats"])[0]
        elif cfg.model == "mind":
            args_shape = {
                "query": {"hist": _sds((1, cfg.hist_len), i32),
                          "hist_mask": _sds((1, cfg.hist_len), f32)},
                "cand_item_id": _sds((N,), i32)}

            def retr(p, a):
                from repro_torch.models.recsys import embedding as E
                v = M.user_interests(p, cfg, a["query"]["hist"],
                                     a["query"]["hist_mask"])   # (1,K,d)
                t = E.lookup(p["tables"]["item"], a["cand_item_id"],
                             v.dtype)                            # (N,d)
                s = torch.einsum("kd,nd->nk", v[0], t)
                return s.to(torch.float32).amax(dim=-1)
        elif cfg.model == "dlrm":
            args_shape = {
                "query": {"dense": _sds((1, cfg.n_dense), f32),
                          "user_sparse": _sds((1, 13), i32)},
                "cand_sparse": _sds((N, 13), i32)}

            def retr(p, a):
                n = a["cand_sparse"].shape[0]
                dense = a["query"]["dense"].expand(n, cfg.n_dense)
                user = a["query"]["user_sparse"].expand(n, 13)
                sparse = torch.cat([user, a["cand_sparse"]], dim=1)
                return M.forward(p, cfg, dense, sparse)
        else:  # bst
            args_shape = {
                "query": {"hist": _sds((1, cfg.seq_len), i32),
                          "other": _sds((1, len(cfg.tables) - 1), i32)},
                "cand_item_id": _sds((N,), i32)}

            def retr(p, a):
                n = a["cand_item_id"].shape[0]
                hist = a["query"]["hist"].expand(n, cfg.seq_len)
                other = a["query"]["other"].expand(n, len(cfg.tables) - 1)
                return M.forward(p, cfg, hist, a["cand_item_id"], other)

        def spec_like(tree):
            if isinstance(tree, dict):
                return {k: spec_like(v) for k, v in tree.items()}
            return P() if tree.shape[0] == 1 else \
                (P(dp) if tree.ndim == 1 else P(dp, None))

        @torch.no_grad()
        def retrieve(p, a):
            with _on_mesh(mesh):
                return retr(sharded_view(p, pspec, mesh), a)

        args_spec = spec_like(args_shape)
        return Cell(arch_id, shape, retrieve, (params_shape, args_shape),
                    (pspec, args_spec), P(dp),
                    donate_argnums=(), loop_multiplier=1, meta=meta)

    raise ValueError(shape.kind)


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

# Per batch leaf, the dim its DP pieces are gathered along.
_GATHER_DIM = {"x": 0, "edge_index": 1, "edge_mask": 0, "graph_ids": 0}


def _graph_step(loss_fn: Callable, cfg, params_shape, mesh, bspec):
    """A graph train step: the node features and edges gathered over the
    DP axes where the batch spec splits them, and ``loss_fn(p, b, rows)``
    over this rank's rows (``rows``: a slice of the whole graph's node or
    graph rows, None when the batch is whole), scaled so that the DP
    ranks' mean is the whole batch's loss."""
    def gathered_loss(p, b):
        dp = list(batch_axes())
        split = {k: bool(any(spec_axes(s) for s in bspec[k]))
                 for k in b}
        whole = {k: all_gather(v, dp, _GATHER_DIM[k])
                 if k in _GATHER_DIM and split[k] else v
                 for k, v in b.items()}
        if not (dp and split["labels"]):
            return loss_fn(p, whole, None)
        i, _ = flat_coord(dp)
        n = b["labels"].shape[0]
        return loss_fn(p, whole, slice(i * n, (i + 1) * n))

    return _train_step(gathered_loss, cfg, params_shape, mesh)


def _gnn_cell(cfg0: GNNConfig, shape: ShapeSpec, mesh,
              arch_id: str) -> Cell:
    from repro_torch.models import gnn as G
    dp = SH.dp_axes(mesh)
    cfg = reduced(cfg0, d_feat=shape.d_feat or cfg0.d_feat,
                  n_classes=GNN_CLASSES.get(shape.name, cfg0.n_classes),
                  dropout=0.0)
    params_shape = _abstract_params(partial(G.init_params, cfg))
    # GCN fwd flops: per layer 2·N·d_in·d_out (matmul) + ~3·E·d_in
    # (message scale + scatter-add)
    n_nodes = shape.n_nodes * (shape.batch or 1) \
        if shape.kind == "graph_batched" else shape.n_nodes
    n_edges = shape.n_edges * (shape.batch or 1) \
        if shape.kind == "graph_batched" else shape.n_edges
    dims = [cfg.d_feat] + [cfg.d_hidden] * (cfg.n_layers - 1) \
        + [GNN_CLASSES.get(shape.name, cfg.n_classes)]
    gnn_fwd = sum(2.0 * n_nodes * dims[i] * dims[i + 1]
                  + 3.0 * n_edges * dims[i]
                  for i in range(len(dims) - 1))
    meta = {"family": "gnn", "n_params": cfg.n_params(),
            "n_active_params": cfg.n_params(), "cfg": cfg,
            "tokens": n_nodes, "useful_flops_fwd": gnn_fwd}
    i32, f32 = torch.int32, torch.float32
    state_shape = _abstract_state(params_shape)
    state_spec = _state_specs(cfg, params_shape, mesh)
    batch_spec = SH.gnn_batch_specs(shape, mesh)

    def node_loss(p, b, rows):
        logits = G.forward(p, cfg, b["x"], b["edge_index"],
                           b.get("edge_mask"))
        labels, mask = b["labels"], b["label_mask"]
        if rows is None:
            return L.cross_entropy(logits, labels, mask)
        # this rank's labelled rows over the whole batch's label weight,
        # times the DP ranks
        dp = list(batch_axes())
        mine = mask.to(torch.float32).sum()
        total = all_reduce(mine.clone(), dp)
        ce = L.cross_entropy(logits[rows], labels, mask)
        return ce * mine.clamp(min=1.0) / total.clamp(min=1.0) \
            * math.prod(a.size for a in dp)

    if shape.kind == "graph_full":
        # pad N/E so (pod, data) sharding divides evenly; padded edges are
        # masked, padded nodes carry zero label weight
        def pad512(n):
            return ((n + 511) // 512) * 512
        N = shape.n_nodes if shape.name == "full_graph_sm" \
            else pad512(shape.n_nodes)
        E = shape.n_edges if shape.name == "full_graph_sm" \
            else pad512(shape.n_edges)
        bspec = dict(batch_spec)
        batch_shape = {"x": _sds((N, cfg.d_feat), f32),
                       "edge_index": _sds((2, E), i32),
                       "labels": _sds((N,), i32),
                       "label_mask": _sds((N,), f32)}
        if shape.name != "full_graph_sm":
            batch_shape["edge_mask"] = _sds((E,), f32)
            bspec["edge_mask"] = P(dp)
        step = _graph_step(node_loss, cfg, params_shape, mesh, bspec)
        return Cell(arch_id, shape, step, (state_shape, batch_shape),
                    (state_spec, bspec), (state_spec, None),
                    donate_argnums=(0,), loop_multiplier=1, meta=meta)

    if shape.kind == "graph_minibatch":
        sizes = [shape.batch_nodes]
        for f in shape.fanout:
            sizes.append(sizes[-1] * f)
        n_sub = sum(sizes)
        n_edges = sum(sizes[1:])
        meta = dict(meta, tokens=n_sub)
        batch_shape = {"x": _sds((n_sub, cfg.d_feat), f32),
                       "edge_index": _sds((2, n_edges), i32),
                       "edge_mask": _sds((n_edges,), f32),
                       "labels": _sds((n_sub,), i32),
                       "label_mask": _sds((n_sub,), f32)}
        step = _graph_step(node_loss, cfg, params_shape, mesh, batch_spec)
        return Cell(arch_id, shape, step, (state_shape, batch_shape),
                    (state_spec, batch_spec), (state_spec, None),
                    donate_argnums=(0,), loop_multiplier=1, meta=meta)

    if shape.kind == "graph_batched":
        NG = shape.batch
        N = NG * shape.nodes_per_graph
        E = NG * shape.edges_per_graph
        meta = dict(meta, tokens=N)

        def readout_loss(p, b, rows):
            if rows is None:
                return G.graph_readout_loss(p, cfg, b["x"], b["edge_index"],
                                            b["graph_ids"], NG, b["labels"])
            # this rank's graphs: the mean over them (equal counts a rank)
            logits = G.forward(p, cfg, b["x"], b["edge_index"])
            pooled = L.segment_sum(logits, b["graph_ids"], NG)
            counts = L.segment_sum(torch.ones((b["x"].shape[0],),
                                              dtype=logits.dtype,
                                              device=logits.device),
                                   b["graph_ids"], NG)
            pooled = pooled / counts.clamp(min=1.0)[:, None]
            return L.cross_entropy(pooled[rows], b["labels"])

        batch_shape = {"x": _sds((N, cfg.d_feat), f32),
                       "edge_index": _sds((2, E), i32),
                       "graph_ids": _sds((N,), i32),
                       "labels": _sds((NG,), i32)}
        bspec = dict(batch_spec)
        bspec["labels"] = P(dp)
        step = _graph_step(readout_loss, cfg, params_shape, mesh, bspec)
        return Cell(arch_id, shape, step, (state_shape, batch_shape),
                    (state_spec, bspec), (state_spec, None),
                    donate_argnums=(0,), loop_multiplier=1, meta=meta)

    raise ValueError(shape.kind)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

# Config variants applied on top of the registry config; the dry-run
# records them under ``<arch>__<shape>@<variant>.json``.
VARIANTS = {
    "ep_moe": lambda cfg: dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, dispatch="ep_shard_map")),
    # the global sort/scatter MoE (expert pieces gathered whole)
    "base_moe": lambda cfg: dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, dispatch="dense_scatter")),
}


def build_cell(arch_id: str, shape_name: str, mesh,
               variant: str = "") -> Cell:
    bundle = get_bundle(arch_id)
    shape = next(s for s in bundle.shapes if s.name == shape_name)
    cfg = bundle.config
    if variant:
        cfg = VARIANTS[variant](cfg)
    return cell_of(cfg, shape, mesh, arch_id)


def cell_of(cfg, shape: ShapeSpec, mesh, arch_id: str) -> Cell:
    """The cell of any config and shape (``build_cell`` takes the
    registry's; tests build smoke-width cells with it)."""
    if isinstance(cfg, TransformerConfig):
        return _lm_cell(cfg, shape, mesh, arch_id)
    if isinstance(cfg, RecsysConfig):
        return _recsys_cell(cfg, shape, mesh, arch_id)
    if isinstance(cfg, GNNConfig):
        return _gnn_cell(cfg, shape, mesh, arch_id)
    raise TypeError(type(cfg))


def input_specs(arch_id: str, shape_name: str, mesh) -> Tuple:
    """Shape-and-dtype stand-ins for every model input of a cell."""
    return build_cell(arch_id, shape_name, mesh).abstract_args


def all_cells() -> list:
    """The full 40-cell (arch × shape) matrix."""
    from repro_torch.configs import arch_ids
    out = []
    for a in arch_ids():
        for s in get_bundle(a).shapes:
            out.append((a, s.name))
    return out
