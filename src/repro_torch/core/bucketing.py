"""Pytree <-> communication-bucket packing.

DL frameworks never broadcast tensors one by one: parameters are flattened
and coalesced into fixed-budget, same-dtype buckets (CNTK "divides the
communication based on the process count", paper Sec. V-D). The bucket mix —
a few huge buffers plus a tail of small ones — is exactly the message-size
spectrum the tuning framework exists for.

Leaves are flattened in the reference's order (:mod:`.tree`). A bucket
spec describes ONE rank's leaves; :func:`pack_buckets` also takes leaves
that carry extra leading dimensions (the emulated mesh's rank axis) and
keeps them in front: a leaf ``(n, *shape)`` packs into a bucket ``(n, size)``.
A bucket that holds one contiguous leaf is a view of it, not a copy.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from .tree import tree_flatten, tree_unflatten

__all__ = ["BucketSpec", "plan_buckets", "pack_buckets", "unpack_buckets"]


@dataclasses.dataclass(frozen=True)
class _LeafMeta:
    index: int          # position in tree_flatten order
    shape: tuple
    dtype: Any
    bucket: int         # which bucket it landed in
    offset: int         # element offset within the bucket


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    treedef: Any
    leaves: tuple  # of _LeafMeta
    bucket_sizes: tuple[int, ...]     # elements per bucket
    bucket_dtypes: tuple[Any, ...]

    @property
    def num_buckets(self) -> int:
        return len(self.bucket_sizes)

    def bucket_bytes(self) -> list[int]:
        return [int(s) * d.itemsize for s, d in zip(self.bucket_sizes, self.bucket_dtypes)]


def plan_buckets(tree: Any, bucket_bytes: int = 4 << 20) -> BucketSpec:
    """Greedy same-dtype bucketing in tree_flatten order (deterministic).
    Reads only ``shape`` and ``dtype`` of each leaf."""
    leaves, treedef = tree_flatten(tree)
    metas: list[_LeafMeta] = []
    sizes: list[int] = []
    dtypes: list[Any] = []
    open_bucket: dict[Any, int] = {}  # dtype -> bucket idx still below budget
    for i, leaf in enumerate(leaves):
        dt = leaf.dtype
        shape = tuple(leaf.shape)
        nelem = math.prod(shape)
        b = open_bucket.get(dt)
        if b is None or (sizes[b] + nelem) * dt.itemsize > bucket_bytes:
            b = len(sizes)
            sizes.append(0)
            dtypes.append(dt)
            open_bucket[dt] = b
        metas.append(_LeafMeta(i, shape, dt, b, sizes[b]))
        sizes[b] += nelem
    return BucketSpec(treedef, tuple(metas), tuple(sizes), tuple(dtypes))


def _lead(leaf: torch.Tensor, meta: _LeafMeta) -> tuple:
    k = leaf.dim() - len(meta.shape)
    if k < 0 or tuple(leaf.shape[k:]) != meta.shape or leaf.dtype != meta.dtype:
        raise ValueError(
            f"leaf {meta.index} is {tuple(leaf.shape)} {leaf.dtype}; the bucket "
            f"spec expects [...,] {meta.shape} {meta.dtype}"
        )
    return tuple(leaf.shape[:k])


def pack_buckets(tree: Any, spec: BucketSpec) -> list[torch.Tensor]:
    """Flatten + concatenate leaves into their buckets along the last dim."""
    leaves = tree_flatten(tree)[0]
    parts: list[list[torch.Tensor]] = [[] for _ in range(spec.num_buckets)]
    lead: tuple = ()
    for meta in spec.leaves:
        leaf = leaves[meta.index]
        lead = _lead(leaf, meta)
        parts[meta.bucket].append(leaf.reshape(lead + (-1,)))
    out = []
    for b, chunks in enumerate(parts):
        if chunks:
            out.append(torch.cat(chunks, dim=-1) if len(chunks) > 1 else chunks[0])
        else:
            device = leaves[0].device if leaves else None
            out.append(torch.zeros(lead + (0,), dtype=spec.bucket_dtypes[b], device=device))
    return out


def unpack_buckets(buckets: list[torch.Tensor], spec: BucketSpec) -> Any:
    """Inverse of :func:`pack_buckets`; every leaf is a view of its bucket."""
    leaves: list[Any] = [None] * len(spec.leaves)
    for meta in spec.leaves:
        b = buckets[meta.bucket]
        nelem = math.prod(meta.shape)
        flat = b[..., meta.offset: meta.offset + nelem]
        leaves[meta.index] = flat.view(tuple(b.shape[:-1]) + meta.shape)
    return tree_unflatten(spec.treedef, leaves)
