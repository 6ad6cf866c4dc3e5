"""Parameter trees: nested dicts, lists, tuples and NamedTuples of
tensors (``None`` holds no leaf). Leaves are visited in JAX's order
(dict keys sorted), so a checkpoint lists them as the reference's does.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _children(tree: Any) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    raise TypeError(type(tree))


def _is_node(tree: Any) -> bool:
    return isinstance(tree, (dict, list, tuple))


def leaves_with_paths(tree: Any, prefix: str = "", is_leaf=None
                      ) -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in order; paths read like ``jax.tree_util``'s
    ``keystr``. ``is_leaf(node)`` may stop the descent at a node (a
    ``NamedSharding``, say)."""
    if tree is None:
        return []
    if not _is_node(tree) or (is_leaf is not None and is_leaf(tree)):
        return [(prefix, tree)]
    out = []
    for key, child in _children(tree):
        out.extend(leaves_with_paths(child, prefix + key, is_leaf))
    return out


def leaves(tree: Any, is_leaf=None) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree, is_leaf=is_leaf)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf over trees of one structure."""
    if tree is None:
        return None
    if not _is_node(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    items = [tree_map(fn, c, *(r[i] for r in rest))
             for i, c in enumerate(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*items)
    return type(tree)(items)


def unflatten(like: Any, new_leaves: List[Any]) -> Any:
    """A tree of ``like``'s structure holding ``new_leaves`` in order."""
    it = iter(new_leaves)

    def take(tree):
        if tree is None:
            return None
        if not _is_node(tree):
            return next(it)
        if isinstance(tree, dict):
            return {k: take(tree[k]) for k in sorted(tree)}
        items = [take(c) for c in tree]
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*items)
        return type(tree)(items)

    out = take(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out
