"""Mesh metadata: the single source of truth for axis roles.

Every layer that needs to know "which axes are data-parallel", "which axis
is tensor-parallel", or "which axes cross the slow inter-pod fabric" reads
it from here, keyed off the mesh itself — mirroring how MVAPICH2-GDR's
hierarchical designs key their intra/inter-node split off the node
topology.  Consumers: ``repro.dist.sharding`` (placement rules),
``core.bcast.hierarchical_bcast`` (per-level broadcast axes and inter-pod
pricing), ``serve.engine.distribute_weights`` and the trainer.

Helpers take any mesh-like object exposing ``axis_names`` and
``devices.shape`` (a real ``jax.sharding.Mesh`` or a test stand-in); none
of them touch jax device state.
"""
from __future__ import annotations

import math

__all__ = [
    "DP_AXES",
    "TP_AXIS",
    "INTER_POD_AXES",
    "axis_sizes",
    "dp_axes",
    "dp_size",
    "tp_axis",
    "tp_size",
    "inter_pod_axes",
    "is_inter_pod",
    "bcast_axes",
]

# Conventional axis roles; meshes use a subset of these names.
DP_AXES = ("pod", "data")     # batch / FSDP axes (outer-to-inner order)
TP_AXIS = "model"             # tensor-parallel axis
INTER_POD_AXES = ("pod",)     # axes priced with inter-pod constants


def axis_sizes(mesh) -> dict:
    """``{axis_name: size}`` for any mesh-like object."""
    return dict(zip(tuple(mesh.axis_names), tuple(mesh.devices.shape)))


def dp_axes(mesh) -> tuple:
    """Data-parallel axes present on ``mesh``: ('pod','data') on a 3-axis
    mesh, ('data',) on a 2-axis one."""
    return tuple(a for a in mesh.axis_names if a in DP_AXES)


def dp_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in dp_axes(mesh)) if dp_axes(mesh) else 1


def tp_axis(mesh):
    """The tensor-parallel axis name, or None if the mesh has none."""
    return TP_AXIS if TP_AXIS in tuple(mesh.axis_names) else None


def tp_size(mesh) -> int:
    ax = tp_axis(mesh)
    return axis_sizes(mesh)[ax] if ax else 1


def inter_pod_axes(mesh) -> tuple:
    """Axes of ``mesh`` that cross the slow inter-pod fabric (the tuner's
    ``inter_pod`` path class prices broadcasts over these)."""
    return tuple(a for a in mesh.axis_names if a in INTER_POD_AXES)


def is_inter_pod(axis) -> bool:
    return axis in INTER_POD_AXES


def bcast_axes(mesh) -> tuple:
    """Per-level axis order for hierarchical broadcast: the inter-pod level
    first (pod leaders exchange), then the intra-pod data axes fan out."""
    dp = dp_axes(mesh)
    return tuple(a for a in dp if a in INTER_POD_AXES) + tuple(
        a for a in dp if a not in INTER_POD_AXES
    )
