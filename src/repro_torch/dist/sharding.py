"""Rule-based layout: partition specs for params, batches and KV caches.

One source of truth for how every tensor lands on a ``(data, model)`` or
``(pod, data, model)`` mesh, with the reference's rules
(``repro/dist/sharding.py``):

parameters (``param_specs``)
  * attention: the heads dim shards on ``model`` (q-heads for wq/wo,
    kv-heads for wk/wv). Non-divisible head counts (hymba's 25, MQA's 1)
    fall back per ``attn_fallback``: ``"replicate"`` or ``"head_dim"``.
  * MoE: the expert dim shards on ``model`` when divisible, else the
    expert FFN width does; shared experts follow the dense-MLP rule.
  * dense matmuls: the FFN-width / output-feature dim shards on ``model``.
  * FSDP (``fsdp=True``) additionally shards the d_model-side dim over the
    data axes: ('pod', 'data') jointly when divisible, else 'data' alone,
    else replicated. ``fsdp=False`` (serving) never places a data axis.
  * norm scales, 1-D biases and scalars replicate.

batches (``batch_specs``): dim 0 over the joint data axes, falling back to
'data' alone, then replication.

KV caches (``cache_specs``): k/v ``(B, S, KV, hd)`` batch over the data
axes, kv-heads on ``model`` when divisible, else the sequence dim takes
``model``; when the batch cannot shard, the sequence also takes 'data'.
Recurrent state: batch over the data axes, the widest divisible trailing
dim on ``model``. Position rings replicate.

A spec is a :class:`PartitionSpec`, full rank (``len(spec) == leaf.ndim``);
leaves under a ``'blocks'`` key (the superblock-stacked ones) get a
leading ``None``. The functions read only ``mesh.axis_names`` and
``mesh.devices.shape``, so they run on an emulated mesh, on the production
meshes and on any stand-in; leaves need only ``shape`` (meta tensors from
``Model.param_shapes()`` allocate nothing).

The port has no GSPMD to place a value by its spec: :func:`shard_slices`
names the block of a leaf that one rank holds, and
:func:`shard_stacked` (and :func:`cut_leaves`) cut a tree into the
rank-stacked layout the emulated mesh keeps (row ``r`` rank ``r``'s block).
:func:`assemble_leaves` puts the full leaves back together from that
layout, what ``jax.device_get`` reads back from a
global array; :func:`owner_ranks` names the ranks that hold each distinct
block once, so a sum over the layout counts every element of the full
tree once.
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from ..core.tree import tree_flatten, tree_map_with_path, tree_unflatten
from .topology import DP_AXES, TP_AXIS, axis_sizes

__all__ = ["PartitionSpec", "param_specs", "batch_specs", "cache_specs", "cut_leaves",
           "is_spec", "shard_slices", "shard_stacked", "assemble_leaves", "drop_axis",
           "owner_ranks", "spec_axes"]

_ATTN_PROJ = {"wq", "wk", "wv", "wo", "bq", "bk", "bv"}


class PartitionSpec(tuple):
    """A spec: one entry a dim, each ``None``, an axis name or a tuple of
    names. A one-name tuple is that name, as jax's ``PartitionSpec`` keeps
    it, so specs of the two packages compare equal as tuples."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            (e[0] if len(e) == 1 else tuple(e)) if isinstance(e, (tuple, list)) else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def is_spec(x) -> bool:
    """The ``is_leaf`` of a spec tree (a spec is a tuple, which a tree walk
    would descend into)."""
    return isinstance(x, PartitionSpec)


def _key_names(path) -> list:
    return [f"[{k}]" if isinstance(k, int) else str(k) for k in path]


class _Axes:
    """Divisibility-checked axis assignment for one mesh. Also reused by
    ``dist.hints`` so the activation fallback policy cannot drift from the
    tensor-layout one (``dp``/``tp`` override the topology defaults)."""

    def __init__(self, mesh, *, dp=None, tp=None):
        self.sizes = axis_sizes(mesh)
        tp = TP_AXIS if tp is None else tp
        self.tp = tp if tp in self.sizes else None
        self.dp = tuple(a for a in (DP_AXES if dp is None else dp) if a in self.sizes)

    def fits(self, dim: int, axes) -> bool:
        if not axes:
            return False
        axes = axes if isinstance(axes, tuple) else (axes,)
        return dim % math.prod(self.sizes[a] for a in axes) == 0

    def tp_if_divisible(self, dim: int):
        return self.tp if (self.tp and self.fits(dim, self.tp)) else None

    def dp_if_divisible(self, dim: int):
        """Joint data axes when divisible, else the innermost data axis
        alone, else None."""
        if self.dp and self.fits(dim, self.dp):
            return self.dp
        if len(self.dp) > 1 and self.fits(dim, self.dp[-1]):
            return self.dp[-1:]
        return None


def _stacked(names) -> int:
    """Leaves under a 'blocks' key carry a leading scan-stacked dim."""
    return 1 if "blocks" in names else 0


def param_specs(shapes: Any, mesh, *, fsdp: bool = True,
                attn_fallback: str = "replicate") -> Any:
    """PartitionSpec tree for a parameter tree (see the module's rules).

    ``shapes``: a tree of tensors or anything with ``shape``
    (``Model.param_shapes()``). ``fsdp``: also shard the d_model-side dim
    over the data axes. ``attn_fallback``: 'replicate' | 'head_dim', what
    attention projections whose head count does not divide the ``model``
    axis do."""
    if attn_fallback not in ("replicate", "head_dim"):
        raise ValueError(f"attn_fallback must be 'replicate' or 'head_dim', got {attn_fallback!r}")
    ax = _Axes(mesh)

    def one(path, leaf):
        names = _key_names(path)
        stacked = _stacked(names)
        dims = list(leaf.shape[stacked:])
        ent = [None] * len(dims)
        leaf_key = names[-1] if names else ""
        in_attn = ("attn" in names or "cross" in names) and leaf_key in _ATTN_PROJ
        in_moe = "moe" in names and "shared" not in names

        def fsdp_put(i):
            if fsdp and ent[i] is None:
                ent[i] = ax.dp_if_divisible(dims[i])

        def head_rule(i_heads, i_hd):
            got = ax.tp_if_divisible(dims[i_heads])
            if got is not None:
                ent[i_heads] = got
            elif attn_fallback == "head_dim":
                ent[i_hd] = ax.tp_if_divisible(dims[i_hd])

        if len(dims) <= 1:
            pass  # scalars, norm scales, 1-D biases: replicate
        elif in_attn:
            if leaf_key in ("wq", "wk", "wv"):      # (d, H|KV, hd)
                head_rule(-2, -1)
                fsdp_put(-3)
            elif leaf_key == "wo":                  # (H, hd, d)
                head_rule(-3, -2)
                fsdp_put(-1)
            else:                                   # bq/bk/bv (H|KV, hd)
                head_rule(-2, -1)
        elif in_moe and leaf_key == "router":       # (d, E)
            ent[-1] = ax.tp_if_divisible(dims[-1])
            fsdp_put(-2)
        elif in_moe and leaf_key in ("w_gate", "w_up", "w_down"):
            # w_gate/w_up: (E, d, f); w_down: (E, f, d)
            i_ff = -1 if leaf_key != "w_down" else -2
            i_dm = -2 if leaf_key != "w_down" else -1
            got = ax.tp_if_divisible(dims[-3])
            if got is not None:
                ent[-3] = got                        # expert parallelism
            else:
                ent[i_ff] = ax.tp_if_divisible(dims[i_ff])  # expert-FFN shard
            fsdp_put(i_dm)
        elif "embed" in names and leaf_key in ("tokens", "unembed"):  # (V, D)
            ent[-2] = ax.tp_if_divisible(dims[-2])
            fsdp_put(-1)
        elif leaf_key in ("w_up", "w_gate", "w_down"):  # dense / shared MLP
            i_ff = -1 if leaf_key != "w_down" else -2
            i_dm = -2 if leaf_key != "w_down" else -1
            ent[i_ff] = ax.tp_if_divisible(dims[i_ff])
            fsdp_put(i_dm)
        else:
            # generic matmul-ish leaf (SSM projections, gates, recurrent
            # kernels): output-feature dim on `model`, FSDP on the input dim
            ent[-1] = ax.tp_if_divisible(dims[-1])
            if len(dims) >= 2 and ent[0] is None:
                fsdp_put(0)
        return P(*([None] * stacked + ent))

    return tree_map_with_path(one, shapes)


def batch_specs(tree: Any, mesh) -> Any:
    """PartitionSpecs for model inputs: dim 0 (global batch) over the joint
    data axes when divisible, else 'data', else replicated."""
    ax = _Axes(mesh)

    def one(_path, leaf):
        if len(leaf.shape) == 0:
            return P()
        return P(ax.dp_if_divisible(leaf.shape[0]), *([None] * (len(leaf.shape) - 1)))

    return tree_map_with_path(one, tree)


def cache_specs(tree: Any, mesh, cfg) -> Any:
    """PartitionSpecs for a decode/prefill cache tree (see the module's
    rules). ``cfg`` is accepted for the reference's call sites; the rules
    are shape-driven, so they hold for windowed ring buffers, cross caches
    and recurrent state alike."""
    del cfg  # shape-driven
    ax = _Axes(mesh)

    def one(path, leaf):
        names = _key_names(path)
        stacked = _stacked(names)
        dims = list(leaf.shape[stacked:])
        ent = [None] * len(dims)
        leaf_key = names[-1] if names else ""

        if leaf_key in ("k", "v") and len(dims) == 4:   # (B, S, KV, hd)
            B, S, KV, _hd = dims
            b_ax = ax.dp_if_divisible(B)
            ent[0] = b_ax
            seq = []
            if ax.tp_if_divisible(KV) is not None:
                ent[2] = ax.tp                      # kv-head sharding
            elif ax.tp_if_divisible(S) is not None:
                seq.append(ax.tp)                   # flash-decoding: seq on model
            if b_ax is None and "data" in ax.sizes and ax.fits(S, "data"):
                seq.insert(0, "data")               # long context: seq on data
            if seq:
                ent[1] = tuple(seq) if len(seq) > 1 else seq[0]
        elif leaf_key == "pos" or len(dims) <= 1:
            pass                                    # position rings replicate
        else:
            # recurrent state (B, ...): batch over data axes; the widest
            # trailing divisible dim takes `model`.
            ent[0] = ax.dp_if_divisible(dims[0])
            trailing = sorted(range(1, len(dims)), key=lambda i: -dims[i])
            for i in trailing:
                if ax.tp_if_divisible(dims[i]) is not None:
                    ent[i] = ax.tp
                    break
        return P(*([None] * stacked + ent))

    return tree_map_with_path(one, tree)


def shard_slices(spec, shape, mesh, rank: int) -> tuple:
    """The block of a leaf of ``shape`` that rank ``rank`` (row-major over
    ``mesh.axis_names``) holds under ``spec``: one ``slice`` a dim. A dim
    whose entry names several axes splits into their product, indexed
    row-major over them in the entry's order, as a ``NamedSharding`` does."""
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec} does not have the rank of shape {tuple(shape)}")
    sizes = axis_sizes(mesh)
    coords = dict(zip(tuple(mesh.axis_names),
                      np.unravel_index(rank, tuple(mesh.devices.shape))))
    out = []
    for dim, e in zip(shape, spec):
        axes = () if e is None else (e if isinstance(e, tuple) else (e,))
        parts, idx = 1, 0
        for a in axes:
            parts, idx = parts * sizes[a], idx * sizes[a] + int(coords[a])
        if dim % parts:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not divide over {axes}")
        size = dim // parts
        out.append(slice(idx * size, (idx + 1) * size))
    return tuple(out)


def cut_leaves(leaves: list, specs: Any, mesh, *, rows_full: bool = False) -> list:
    """Each leaf of ``leaves`` (in flatten order, beside the spec tree
    ``specs``) in the rank-stacked layout: ``(mesh.size, *block)``, row
    ``r`` rank ``r``'s block (:func:`shard_slices`), a contiguous copy (so
    each row starts 16-byte aligned wherever the block's bytes are a
    multiple of 16). A leaf is the full value, or with ``rows_full`` itself
    rank-stacked ``(mesh.size, *full)`` with row ``r`` rank ``r``'s full
    value (a distribution's result). ``leaves`` is emptied as it is cut,
    so that a full leaf the caller holds nowhere else is freed once its
    blocks are made."""
    spec_leaves = tree_flatten(specs, is_spec)[0]
    if len(spec_leaves) != len(leaves):
        raise ValueError(f"{len(spec_leaves)} specs for {len(leaves)} leaves")
    out = []
    for i, spec in enumerate(spec_leaves):
        leaf, leaves[i] = leaves[i], None
        full = tuple(leaf.shape[1:]) if rows_full else tuple(leaf.shape)
        blocks = [shard_slices(spec, full, mesh, r) for r in range(mesh.size)]
        shape = tuple(s.stop - s.start for s in blocks[0])
        cut = torch.empty((mesh.size,) + shape, dtype=leaf.dtype, device=leaf.device)
        for r, sl in enumerate(blocks):
            cut[r] = (leaf[r] if rows_full else leaf)[sl]
        del leaf
        out.append(cut)
    return out


def shard_stacked(tree: Any, specs: Any, mesh) -> Any:
    """``tree`` (full values) in the rank-stacked layout of ``specs``
    (:func:`cut_leaves`)."""
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, cut_leaves(leaves, specs, mesh))


def _entry_axes(e) -> tuple:
    return () if e is None else (e if isinstance(e, tuple) else (e,))


def spec_axes(spec) -> tuple:
    """The mesh axes ``spec`` names, in the order of its entries."""
    return tuple(a for e in spec for a in _entry_axes(e))


def drop_axis(spec, axis: str):
    """``spec`` with ``axis`` taken out of every entry: the spec of a leaf's
    block within the slice of it that one coordinate on ``axis`` holds."""
    out = []
    for e in spec:
        axes = tuple(a for a in _entry_axes(e) if a != axis)
        out.append(axes if axes else None)
    return P(*out)


def _full_shape(spec, block_shape, mesh) -> tuple:
    """The shape of the full leaf whose blocks under ``spec`` are
    ``block_shape``."""
    sizes = axis_sizes(mesh)
    return tuple(b * math.prod(sizes[a] for a in _entry_axes(e))
                 for b, e in zip(block_shape, spec))


def owner_ranks(spec, mesh) -> list:
    """The ranks at coordinate 0 on every axis ``spec`` does not name: each
    distinct block of a leaf under ``spec`` is held by exactly one of them
    (the others hold copies)."""
    named = set(spec_axes(spec))
    shape = tuple(mesh.devices.shape)
    keep = [slice(None) if a in named else slice(0, 1) for a in tuple(mesh.axis_names)]
    return [int(r) for r in np.arange(math.prod(shape)).reshape(shape)[tuple(keep)].reshape(-1)]


def assemble_leaves(leaves: list, specs: Any, mesh) -> list:
    """The full leaves of rank-stacked ones (``(mesh.size, *block)``, as
    :func:`cut_leaves` makes them, in flatten order beside ``specs``): each
    block written into its place from the rank that owns it
    (:func:`owner_ranks`). ``leaves`` is emptied as it is assembled, so a
    stacked leaf the caller holds nowhere else is freed once its full value
    is made."""
    spec_leaves = tree_flatten(specs, is_spec)[0]
    if len(spec_leaves) != len(leaves):
        raise ValueError(f"{len(spec_leaves)} specs for {len(leaves)} leaves")
    out = []
    for i, spec in enumerate(spec_leaves):
        leaf, leaves[i] = leaves[i], None
        shape = _full_shape(spec, tuple(leaf.shape[1:]), mesh)
        full = torch.empty(shape, dtype=leaf.dtype, device=leaf.device)
        for r in owner_ranks(spec, mesh):
            full[shard_slices(spec, shape, mesh, r)] = leaf[r]
        del leaf
        out.append(full)
    return out

