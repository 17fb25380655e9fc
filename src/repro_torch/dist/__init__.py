"""repro_torch.dist — the layout subsystem: mesh topology roles, layout
rules and activation hints. One source of truth for how tensors land on
the mesh."""
from . import topology
from .hints import activation_hints, hint
from .sharding import batch_specs, cache_specs, param_specs
from .topology import (
    axis_sizes,
    bcast_axes,
    dp_axes,
    dp_size,
    inter_pod_axes,
    is_inter_pod,
    tp_axis,
    tp_size,
)

__all__ = [
    "topology",
    "param_specs",
    "batch_specs",
    "cache_specs",
    "hint",
    "activation_hints",
    "axis_sizes",
    "dp_axes",
    "dp_size",
    "tp_axis",
    "tp_size",
    "inter_pod_axes",
    "is_inter_pod",
    "bcast_axes",
]
