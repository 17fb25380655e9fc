"""Broadcast facade, as the reference's ``core/bcast.py``: ``pbcast`` and
``pbcast_tree`` route through the tuned plan layer (:mod:`repro_torch.comm`),
``preduce_sum`` is the mirror-image reduce-to-root over the reversed
binomial tree that the paper's CA-CNTK step runs before its broadcast,
``hierarchical_bcast`` composes per-axis broadcasts (MVAPICH2's
hierarchical designs) and ``bcast_stacked`` broadcasts a rank-stacked
value over a mesh."""
from __future__ import annotations

import functools
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
    compiled: bool | None = None,
    inkernel: bool | None = None,
) -> torch.Tensor:
    """Broadcast the rank-stacked ``x`` over the mesh axes one level at a
    time, the inter-pod level first (pod leaders exchange, then each pod
    fans out); an axis named in ``inter_pod_axes`` (default
    ``topology.INTER_POD_AXES``) is priced with the inter-pod constants.
    ``axes`` come from ``topology.bcast_axes(mesh)`` when not given. Each
    level broadcasts from coordinate ``root`` of its axis on every group of
    ranks along it (``comm.api.level_replay``), so every rank ends with the
    row at coordinate ``root`` of every level's axis, per coordinate of the
    axes not broadcast over (a model axis). Over more than one axis ``x``
    is stacked over ``mesh``'s ranks and ``mesh`` is required.
    ``compiled`` and ``inkernel`` route every level's replay as
    ``comm.apply_plan``'s do."""
    from ..dist import topology

    if axes is None:
        if mesh is None:
            raise ValueError("hierarchical_bcast needs `axes` or a `mesh` to derive them")
        axes = topology.bcast_axes(mesh)
    if inter_pod_axes is None:
        inter_pod_axes = topology.INTER_POD_AXES
    for ax in _api._levels(axes, mesh, None if mesh is None else x):
        x = _api.level_replay(
            x, ax, functools.partial(_api.pbcast, root=root, algo=algo, tuner=tuner,
                                     inter_pod=ax in tuple(inter_pod_axes),
                                     compiled=compiled, inkernel=inkernel),
            mesh=mesh)
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
