"""Sharding rules: parameter and optimizer PartitionSpecs per arch family
on the ``(pod, data, model)`` production mesh.

Counterpart of ``repro.distribution.sharding``: the parameter specs and
the batch specs of each shape kind. Conventions, as the reference's:
  * DP axes  = ("pod", "data") — batch/tokens/nodes/bags.
  * TP axis  = "model" — attention heads, FFN hidden, vocab rows/cols.
  * EP       = MoE expert dim over "model".
  * SP       = KV-cache sequence dim over "model" (long-context decode
    shards over ("data", "model") so a batch-1 cache spreads 256-wide).
  * RecSys embedding tables row-shard over ("data", "model") while
    activations stay on ("pod", "data").

The rules are the reference's regexes on the reference's ``keystr``
paths (``['blocks'][0]['attn']['wq']['w']``); :func:`keystr` builds the
same strings from the port's nested dicts and lists, whose keys mirror
the reference's trees. Specs are :class:`~repro_torch.distribution.
placement.PartitionSpec`; :func:`shardings_of` makes them
:class:`NamedSharding` s whose ``placements`` are DTensor placements, and
:func:`place_params` puts a parameter tree on the mesh as DTensors.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Optional, Tuple

from repro_torch.configs.base import (GNNConfig, RecsysConfig, ShapeSpec,
                                      TransformerConfig)
from repro_torch.distribution.placement import (NamedSharding,
                                                PartitionSpec as P,
                                                device_put)


def axis_names(mesh) -> Tuple[str, ...]:
    """The axis names of a ``DeviceMesh``, or of any mesh-like object
    with the reference's ``axis_names`` (a shape-only stand-in)."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_size(mesh, name: str) -> int:
    """Ranks along the axis ``name`` (1 when the mesh lacks it)."""
    names = axis_names(mesh)
    if name not in names:
        return 1
    if hasattr(mesh, "mesh_dim_names"):
        return mesh.size(names.index(name))
    return int(mesh.shape[name])


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))


def table_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in axis_names(mesh) if a in ("data", "model"))


def all_axes(mesh) -> Tuple[str, ...]:
    return axis_names(mesh)


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

def _tf_rule(path: str, ndim: int, mesh,
             tied_embeddings: bool = False) -> P:
    """Transformer param rule. ``ndim`` includes the stacked-layer dim for
    scanned blocks; specs are right-aligned so the rule works for both."""
    def right(*spec):
        return P(*([None] * (ndim - len(spec)) + list(spec)))

    if "moe" in path:
        if "router" in path:
            return P(*([None] * ndim))
        if "shared" in path:
            if re.search(r"\['(gate|up)'\]\['w'\]", path):
                return right(None, "model")
            if "down" in path:
                return right("model", None)
            return P(*([None] * ndim))
        # expert-stacked weights (…, E, D, F) / (…, E, F, D): EP on E
        if re.search(r"w_(gate|up|down)", path):
            return right("model", None, None)
        return P(*([None] * ndim))
    if re.search(r"\['(wq|wk|wv)'\]\['w'\]", path):
        return right(None, "model")
    if re.search(r"\['(wq|wk|wv)'\]\['b'\]", path):
        return right("model")
    if re.search(r"\['wo'\]\['w'\]", path):
        return right("model", None)
    if re.search(r"\['(gate|up)'\]\['w'\]", path):
        return right(None, "model")
    if re.search(r"\['down'\]\['w'\]", path):
        return right("model", None)
    if "embed" in path and "table" in path:
        # Untied: column (d_model) sharding keeps the token gather local.
        # Tied: the table doubles as the unembed, so rows (vocab) win.
        return right("model", None) if tied_embeddings \
            else right(None, "model")
    if "unembed" in path and path.endswith("['w']"):
        return right(None, "model")          # vocab cols
    return P(*([None] * ndim))               # norms, biases, scalars


def _recsys_rule(path: str, ndim: int, mesh) -> P:
    if "tables" in path and "table" in path and ndim == 2:
        return P(table_axes(mesh), None)     # row-sharded
    return P(*([None] * ndim))               # MLPs replicated (tiny)


def _gnn_rule(path: str, ndim: int, mesh) -> P:
    return P(*([None] * ndim))               # 2-layer GCN params are tiny


def keystr(path: Tuple) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys and list
    indices."""
    return "".join(f"[{k!r}]" for k in path)


def tree_map_with_path(fn: Callable, tree, path: Tuple = ()):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples (a
    NamedTuple keeps its type; a PartitionSpec is a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        out = [tree_map_with_path(fn, v, path + (i,))
               for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*out)
        return type(tree)(out)
    return fn(path, tree)


def param_specs(cfg: Any, params: Any, mesh) -> Any:
    """Tree of PartitionSpec mirroring ``params`` (tensors, or anything
    with an ``ndim``)."""
    if isinstance(cfg, TransformerConfig):
        def rule(path, ndim, mesh, _tied=cfg.tie_embeddings):
            return _tf_rule(path, ndim, mesh, tied_embeddings=_tied)
    elif isinstance(cfg, RecsysConfig):
        rule = _recsys_rule
    elif isinstance(cfg, GNNConfig):
        rule = _gnn_rule
    else:
        raise TypeError(type(cfg))
    return tree_map_with_path(
        lambda path, leaf: rule(keystr(path), leaf.ndim, mesh), params)


def shardings_of(specs: Any, mesh) -> Any:
    """Each spec as a :class:`NamedSharding` over ``mesh`` (its
    ``placements`` are the DTensor placements ``distribute_tensor``
    takes); a ``None`` stays ``None``."""
    return tree_map_with_path(
        lambda _, s: None if s is None else NamedSharding(mesh, s), specs)


def opt_state_specs(param_spec_tree: Any, opt_state_shape: Any = None):
    """AdamWState(step, m, v): m/v mirror params, step replicated."""
    from repro_torch.training.optimizer import AdamWState
    return AdamWState(step=P(), m=param_spec_tree, v=param_spec_tree)


def place_params(params: Any, cfg: Any, mesh) -> Any:
    """``params`` (the same global tensors on every rank) as DTensors by
    the arch family's rules: each rank keeps views of its own pieces,
    nothing is copied or sent (on a mesh of one device every DTensor
    wraps the tensor itself)."""
    shardings = shardings_of(param_specs(cfg, params, mesh), mesh)

    def put(path, leaf):
        sh = shardings
        for k in path:
            sh = sh[k]
        return device_put(leaf, sh)

    return tree_map_with_path(put, params)


# ---------------------------------------------------------------------------
# Batch / activation specs per shape kind
# ---------------------------------------------------------------------------

def lm_batch_specs(shape: ShapeSpec, mesh) -> Any:
    dp = dp_axes(mesh)
    if shape.kind == "train":
        return {"tokens": P(dp, None), "labels": P(dp, None),
                "mask": P(dp, None)}
    if shape.kind == "prefill":
        return {"tokens": P(dp, None)}
    if shape.kind == "decode":
        if shape.global_batch == 1:
            # SP: batch-1 long-context cache spreads over (data, model)
            cache_seq = table_axes(mesh)
            batch_ax: Optional[Tuple[str, ...]] = None
        else:
            cache_seq = ("model",)
            batch_ax = dp
        return {
            "token": P(batch_ax),
            "cache": {
                "k": P(None, batch_ax, cache_seq, None, None),
                "v": P(None, batch_ax, cache_seq, None, None),
                "lengths": P(batch_ax),
            },
        }
    raise ValueError(shape.kind)


def recsys_batch_specs(cfg: RecsysConfig, shape: ShapeSpec, mesh) -> Any:
    dp = dp_axes(mesh)
    if cfg.model == "dlrm":
        base = {"dense": P(dp, None), "sparse": P(dp, None)}
    elif cfg.model == "bst":
        base = {"hist": P(dp, None), "target": P(dp),
                "other": P(dp, None)}
    elif cfg.model == "two_tower":
        base = {"user_id": P(dp), "user_feats": P(dp, None),
                "item_id": P(dp), "item_feats": P(dp, None)}
    elif cfg.model == "mind":
        base = {"hist": P(dp, None), "hist_mask": P(dp, None),
                "target": P(dp)}
    else:
        raise ValueError(cfg.model)
    if shape.kind == "train":
        if cfg.model in ("dlrm", "bst"):
            base["labels"] = P(dp)
        if cfg.model == "two_tower":
            base["logq"] = P(dp)
    if shape.kind == "retrieval":
        # 1 query replicated; candidates sharded over everything usable
        return {"query": {k: P() for k in base},
                "cand_item_id": P(dp),
                "cand_item_feats": P(dp, None)}
    return base


def gnn_batch_specs(shape: ShapeSpec, mesh) -> Any:
    dp = dp_axes(mesh)
    if shape.name == "full_graph_sm":
        # cora is tiny: replicate
        return {"x": P(), "edge_index": P(), "labels": P(),
                "label_mask": P()}
    if shape.kind == "graph_full":
        return {"x": P(dp, None), "edge_index": P(None, dp),
                "labels": P(dp), "label_mask": P(dp)}
    if shape.kind == "graph_minibatch":
        return {"x": P(dp, None), "edge_index": P(None, dp),
                "edge_mask": P(dp), "labels": P(dp),
                "label_mask": P(dp)}
    if shape.kind == "graph_batched":
        return {"x": P(dp, None), "edge_index": P(None, dp),
                "graph_ids": P(dp), "labels": P(dp)}
    raise ValueError(shape.kind)
