"""Pytree flattening in the reference's order.

``jax.tree_util`` flattens a dict in SORTED-key order and treats ``None``
as a node with no children; ``torch.utils._pytree`` keeps insertion order.
Bucket contents, bucket sizes and therefore every collective plan depend on
the leaf order, so the port flattens exactly as JAX does: dicts by sorted
key, lists and tuples in order, ``None`` with no leaves, anything else a
leaf.
"""
from __future__ import annotations

from typing import Any, Callable

__all__ = ["tree_flatten", "tree_unflatten", "tree_leaves", "tree_map", "tree_map_with_path",
           "tree_paths"]

_LEAF = "leaf"


# module-level recursion, not nested closures: a closure that calls itself
# is a reference cycle, and a cycle through the leaf list would keep every
# leaf (gigabytes of device memory) alive until the garbage collector runs


def _walk(node, leaves: list, is_leaf=None):
    if node is None:
        return None
    if is_leaf is not None and is_leaf(node):
        leaves.append(node)
        return _LEAF
    if isinstance(node, dict):
        keys = sorted(node)
        return ("dict", tuple(keys), tuple(_walk(node[k], leaves, is_leaf) for k in keys))
    if isinstance(node, (list, tuple)):
        return (type(node).__name__, None, tuple(_walk(c, leaves, is_leaf) for c in node))
    leaves.append(node)
    return _LEAF


def _paths(node, prefix: tuple, out: list):
    """Each leaf's path as a tuple of keys: dict keys as ``str``, sequence
    indices as ``int``."""
    if node is None:
        return
    if isinstance(node, dict):
        for k in sorted(node):
            _paths(node[k], prefix + (str(k),), out)
    elif isinstance(node, (list, tuple)):
        for i, c in enumerate(node):
            _paths(c, prefix + (i,), out)
    else:
        out.append(prefix)


def _build(d, it):
    if d is None:
        return None
    if d == _LEAF:
        return next(it)
    kind, keys, children = d
    vals = [_build(c, it) for c in children]
    if kind == "dict":
        return dict(zip(keys, vals))
    return tuple(vals) if kind == "tuple" else vals


def tree_flatten(tree: Any, is_leaf: Callable | None = None) -> tuple[list, Any]:
    """``(leaves, treedef)``; ``treedef`` is a nested description that
    :func:`tree_unflatten` consumes. ``is_leaf`` stops the walk at a node
    (a sharding spec, which is a tuple), as jax's does."""
    leaves: list = []
    return leaves, _walk(tree, leaves, is_leaf)


def tree_unflatten(treedef: Any, leaves) -> Any:
    it = iter(leaves)
    out = _build(treedef, it)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("more leaves than the treedef holds")
    return out


def tree_leaves(tree: Any, is_leaf: Callable | None = None) -> list:
    return tree_flatten(tree, is_leaf)[0]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


def tree_map_with_path(fn: Callable, tree: Any) -> Any:
    """``fn(path, leaf)`` over the leaves, ``path`` a tuple of dict keys
    (``str``) and sequence indices (``int``) from the root."""
    leaves, treedef = tree_flatten(tree)
    paths: list = []
    _paths(tree, (), paths)
    return tree_unflatten(treedef, [fn(p, x) for p, x in zip(paths, leaves)])


def tree_paths(tree: Any) -> list[str]:
    """Each leaf's path in flatten order, joined with '/': dict keys and
    sequence indices, as the reference's checkpoint keys
    (``jax.tree_util.tree_flatten_with_path``)."""
    out: list = []
    _paths(tree, (), out)
    return ["/".join(map(str, p)) for p in out]
