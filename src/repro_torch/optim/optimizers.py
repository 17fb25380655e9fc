"""Optimizers over parameter trees: AdamW, SGD-momentum, Lion.

The reference's optimizers are pure functions; here ``update`` writes the
new parameters and moments IN PLACE (under ``torch.no_grad``), because at
full width a second copy of the parameters and of the f32 moments would not
fit beside the gradients. The arithmetic is the reference's, in float32,
leaf by leaf. State: f32 moments shaped like the parameters plus ``step``,
a 0-d int32 tensor on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..core.tree import tree_leaves, tree_map

__all__ = ["Optimizer", "adamw", "sgdm", "lion", "get_optimizer", "global_norm",
           "clip_by_global_norm"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """init(params) -> state; update(grads, state, params, lr) ->
    (params, state), both updated in place. ``lr`` is a 0-d float32 tensor
    or a float."""

    name: str
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, Any], tuple]


def _zeros_like_f32(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def _step0() -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32)


def global_norm(tree, rows: list | None = None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (a 0-d tensor
    on the leaves' device). ``rows`` (one list a leaf, in flatten order)
    counts only those rows of each rank-stacked leaf: in a blocked tree
    the ranks that own each distinct block
    (:func:`repro_torch.dist.sharding.owner_ranks`), so every element of
    the full tree counts once, a replicated block not once per copy."""
    leaves = tree_leaves(tree)
    if rows is None:
        sq = [torch.linalg.vector_norm(leaf, dtype=torch.float32) ** 2 for leaf in leaves]
    else:
        sq = [torch.linalg.vector_norm(leaf[r], dtype=torch.float32) ** 2
              for leaf, rs in zip(leaves, rows) for r in rs]
    return torch.sqrt(torch.stack(sq).sum())


def clip_by_global_norm(grads, max_norm: float, rows: list | None = None):
    """Scale ``grads`` by ``min(1, max_norm / (norm + 1e-9))`` in float32,
    cast back to each leaf's dtype. Returns ``(grads, norm)``; the leaves
    are new tensors (the scale is applied in f32, as the reference does).
    ``rows`` as :func:`global_norm`'s."""
    norm = global_norm(grads, rows)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float32 else x.float()


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        return {"m": _zeros_like_f32(params), "v": _zeros_like_f32(params), "step": _step0()}

    @torch.no_grad()
    def update(grads, state, params, lr):
        step = state["step"] + 1
        t = step.float()
        c1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** t)
        c2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** t)
        lr = float(lr)
        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state["m"]),
                              tree_leaves(state["v"]), tree_leaves(params)):
            gf = _f32(g)
            m.mul_(b1).add_(gf * (1 - b1))
            v.mul_(b2).add_((gf * (1 - b2)).mul_(gf))
            delta = (m / c1).div_((v / c2).sqrt_().add_(eps))
            pf = _f32(p)  # p itself when p is f32: updated in place below
            delta.add_(pf * weight_decay)
            p.copy_(pf.sub_(delta.mul_(lr)))
        state["step"] = step
        return params, state

    return Optimizer("adamw", init, update)


def sgdm(momentum: float = 0.9, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"m": _zeros_like_f32(params), "step": _step0()}

    @torch.no_grad()
    def update(grads, state, params, lr):
        lr = float(lr)
        for g, m, p in zip(tree_leaves(grads), tree_leaves(state["m"]), tree_leaves(params)):
            pf = _f32(p)
            m.mul_(momentum).add_(_f32(g) + weight_decay * pf)
            p.copy_(pf - lr * m)
        state["step"] = state["step"] + 1
        return params, state

    return Optimizer("sgdm", init, update)


def lion(b1: float = 0.9, b2: float = 0.99, weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        return {"m": _zeros_like_f32(params), "step": _step0()}

    @torch.no_grad()
    def update(grads, state, params, lr):
        lr = float(lr)
        for g, m, p in zip(tree_leaves(grads), tree_leaves(state["m"]), tree_leaves(params)):
            gf = _f32(g)
            pf = _f32(p)
            u = torch.sign(b1 * m + (1 - b1) * gf).add_(weight_decay * pf)
            m.mul_(b2).add_((1 - b2) * gf)
            p.copy_(pf - lr * u)
        state["step"] = state["step"] + 1
        return params, state

    return Optimizer("lion", init, update)


def get_optimizer(name: str, weight_decay: float = 0.1) -> Optimizer:
    if name == "adamw":
        return adamw(weight_decay=weight_decay)
    if name == "sgdm":
        return sgdm(weight_decay=weight_decay)
    if name == "lion":
        return lion(weight_decay=weight_decay)
    raise KeyError(name)
