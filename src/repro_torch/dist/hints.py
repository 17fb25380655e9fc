"""Activation sharding hints.

The model marks activation cut-points with ``hint(x, kind)``, at the
reference's three points (``models/transformer.py``): the residual stream
entering the decoder (``"btd"``), each superblock slot's residual
(``"btd_res"``) and the logits (``"btv"``). Under
``activation_hints(mesh, ...)`` each point has a spec, derived from the
same mesh metadata and the same divisibility policy as ``dist.sharding``
(:meth:`_HintCtx.spec_for`):

  * ``"btd"``     — (B, T, D): batch over data axes.
  * ``"btd_res"`` — the same, plus sequence over ``model`` when
    ``seq_shard=True`` (sequence-parallel residuals).
  * ``"btv"``     — (B, T, V) logits: batch over data axes, vocab over
    ``model``.

The reference turns a spec into a ``with_sharding_constraint`` for GSPMD.
The port has no GSPMD: its layouts are explicit (an emulated mesh holds
each rank's block as a row, and the tensor-parallel forward of
``models.tensor_parallel`` computes each rank's share itself), so ``hint``
returns its input. Under a context it still resolves the spec, so an
unknown kind raises as it does in the reference.
"""
from __future__ import annotations

import contextlib
from typing import Optional

from .sharding import P, _Axes

__all__ = ["hint", "activation_hints"]

_STACK: list = []


class _HintCtx:
    """Axis assignment delegates to ``sharding._Axes`` so the divisibility
    fallback (joint data axes -> innermost data axis -> replicate) is the
    same policy the tensor layouts use."""

    def __init__(self, mesh, dp: Optional[tuple], tp: Optional[str], seq_shard: bool):
        self.mesh = mesh
        self.ax = _Axes(mesh, dp=dp, tp=tp)
        self.seq_shard = seq_shard

    def spec_for(self, kind: str, shape) -> Optional[P]:
        if len(shape) != 3:
            return None
        ax = self.ax
        B, T, V = shape
        b_ax = ax.dp_if_divisible(B)
        if kind in ("btd", "btd_res"):
            t_ax = None
            if kind == "btd_res" and self.seq_shard:
                t_ax = ax.tp_if_divisible(T)
            return P(b_ax, t_ax, None)
        if kind == "btv":
            return P(b_ax, None, ax.tp_if_divisible(V))
        raise ValueError(f"unknown hint kind {kind!r}")


@contextlib.contextmanager
def activation_hints(mesh, *, dp=None, tp=None, seq_shard=False):
    """Activate activation hints under ``mesh``. ``dp``/``tp`` default to
    the topology role constants (DP_AXES / TP_AXIS) via ``_Axes``; pass
    explicit names only to override them."""
    _STACK.append(_HintCtx(mesh, dp if dp is None else tuple(dp), tp, seq_shard))
    try:
        yield
    finally:
        _STACK.pop()


def hint(x, kind: str):
    """``x`` at a named cut-point: returned as it is (see the module
    docstring), after its spec is resolved when a context is active."""
    if _STACK:
        _STACK[-1].spec_for(kind, x.shape)
    return x
