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

__all__ = ["tree_flatten", "tree_unflatten", "tree_leaves", "tree_map"]

_LEAF = "leaf"


# module-level recursion, not nested closures: a closure that calls itself
# is a reference cycle, and a cycle through the leaf list would keep every
# leaf (gigabytes of device memory) alive until the garbage collector runs


def _walk(node, leaves: list):
    if node is None:
        return None
    if isinstance(node, dict):
        keys = sorted(node)
        return ("dict", tuple(keys), tuple(_walk(node[k], leaves) for k in keys))
    if isinstance(node, (list, tuple)):
        return (type(node).__name__, None, tuple(_walk(c, leaves) for c in node))
    leaves.append(node)
    return _LEAF


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


def tree_flatten(tree: Any) -> tuple[list, Any]:
    """``(leaves, treedef)``; ``treedef`` is a nested description that
    :func:`tree_unflatten` consumes."""
    leaves: list = []
    return leaves, _walk(tree, leaves)


def tree_unflatten(treedef: Any, leaves) -> Any:
    it = iter(leaves)
    out = _build(treedef, it)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("more leaves than the treedef holds")
    return out


def tree_leaves(tree: Any) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
