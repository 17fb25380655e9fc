"""Broadcast facade, as the reference's ``core/bcast.py``: ``pbcast`` and
``pbcast_tree`` route through the tuned plan layer (:mod:`repro_torch.comm`),
``preduce_sum`` is the mirror-image reduce-to-root over the reversed
binomial tree that the paper's CA-CNTK step runs before its broadcast,
``hierarchical_bcast`` composes per-axis broadcasts (MVAPICH2's
hierarchical designs) and ``bcast_stacked`` broadcasts a rank-stacked
value over a mesh."""
from __future__ import annotations

from typing import Sequence

import torch

from ..comm import api as _api
from .tuner import Tuner

__all__ = ["pbcast", "pbcast_tree", "preduce_sum", "hierarchical_bcast", "bcast_stacked"]

pbcast = _api.pbcast
pbcast_tree = _api.pbcast_tree


def preduce_sum(x: torch.Tensor, *, root: int = 0) -> torch.Tensor:
    """Reduce-to-root (sum) of the rank-stacked ``x`` via the reversed
    binomial tree. Only row ``root`` of the result is meaningful (MPI_Reduce
    semantics)."""
    return _api.preduce(x, root=root, algo="binomial_reduce")


def hierarchical_bcast(
    x: torch.Tensor,
    axes: Sequence | None = None,
    *,
    mesh=None,
    root: int = 0,
    algo: str = "auto",
    tuner: Tuner | None = None,
    inter_pod_axes: Sequence | None = None,
) -> torch.Tensor:
    """Broadcast the rank-stacked ``x`` over the mesh axes one level at a
    time, the inter-pod level first; an axis named in ``inter_pod_axes``
    (default ``topology.INTER_POD_AXES``) is priced with the inter-pod
    constants. ``axes`` come from ``topology.bcast_axes(mesh)`` when not
    given. The emulated mesh has one data axis, so ``axes`` names at most
    one (as ``pallreduce_tree``'s)."""
    from ..dist import topology

    if axes is None:
        if mesh is None:
            raise ValueError("hierarchical_bcast needs `axes` or a `mesh` to derive them")
        axes = topology.bcast_axes(mesh)
    if inter_pod_axes is None:
        inter_pod_axes = topology.INTER_POD_AXES
    for ax in _api._check_one_axis(axes):
        x = _api.pbcast(x, root=root, algo=algo, tuner=tuner,
                        inter_pod=ax in tuple(inter_pod_axes))
    return x


def bcast_stacked(
    xs: torch.Tensor,
    mesh,
    axis_name: str,
    *,
    root: int = 0,
    algo: str = "auto",
    tuner: Tuner | None = None,
) -> torch.Tensor:
    """``xs`` has a leading dimension of ``mesh``'s ``axis_name`` size (one
    slice a rank); returns the same stacked value with every slice the
    root's."""
    from ..dist import topology

    size = topology.axis_sizes(mesh).get(axis_name)
    if size is None:
        raise ValueError(f"mesh has no axis {axis_name!r}: {tuple(mesh.axis_names)}")
    if xs.shape[0] != size:
        raise ValueError(f"xs has {xs.shape[0]} slices, axis {axis_name!r} has {size} ranks")
    return _api.pbcast(xs, root=root, algo=algo, tuner=tuner)
