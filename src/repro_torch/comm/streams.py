"""Stream entries: collectives as DAG-embedded streams (the execution half
of the reference's ``comm/streams.py``).

A :class:`StreamEntry` is a named stream carrying an ordered list of
per-bucket :class:`~repro_torch.comm.plan.CollectivePlan` objects, its
dispatch order and staging window; a :class:`StreamGraph` is a set of
entries with distinct names. :func:`execute_stream_entry` replays one
entry over a rank-stacked tree, staging each bucket through the
``chunked_copy`` kernel when asked. The link arbiter, its simulator and
the multi-entry interleave (and with them priorities, link classes and DAG
edges) are not ported yet.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Sequence

from ..core import bucketing
from ..core.bucketing import BucketSpec
from ..kernels.chunked_copy import chunked_copy
from .api import apply_plan
from .plan import CollectivePlan

__all__ = [
    "StreamEntry",
    "StreamGraph",
    "graph_key",
    "execute_stream_entry",
]


def graph_key(payload: Any) -> str:
    """Stable fingerprint of a stream-graph SPEC (names, ops, bucket mixes,
    axes, depth requests). Computable BEFORE any
    plan resolves — this is the ``stream=`` component of the
    ``plan_cached`` key, so two different graph shapes can never share a
    cached per-bucket plan even when the (op, M, n) point coincides."""
    blob = json.dumps(payload, sort_keys=True, default=str)
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class StreamEntry:
    """A fully-resolved stream: bucket mix + per-(axis, bucket) plans +
    dispatch order + in-flight window."""

    name: str
    op: str
    spec: BucketSpec
    axes: tuple[str, ...]                         # sync order (hierarchy levels)
    plans: dict[str, tuple[CollectivePlan, ...]]  # per axis, one plan per bucket
    order: tuple[int, ...]                        # bucket dispatch order
    overlap_depth: int

    @property
    def num_buckets(self) -> int:
        return self.spec.num_buckets

    def wire_bytes(self) -> int:
        """Total bytes on the wire — exactly the sum of the per-bucket plan
        accounting."""
        return sum(p.wire_bytes() for ax in self.axes for p in self.plans[ax])


@dataclasses.dataclass(frozen=True)
class StreamGraph:
    """A set of :class:`StreamEntry` objects with distinct names. ``key`` is
    the spec-level fingerprint the entries' plans were cached under."""

    entries: tuple[StreamEntry, ...]
    key: str | None = None

    def __post_init__(self) -> None:
        names = [e.name for e in self.entries]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate stream names: {names}")

    def entry(self, name: str) -> StreamEntry:
        for e in self.entries:
            if e.name == name:
                return e
        raise KeyError(name)

    def wire_bytes(self) -> int:
        return sum(e.wire_bytes() for e in self.entries)


def _run_entry(entry: StreamEntry, tree: Any, dispatch: Sequence[int], *,
               stage: bool, stage_chunk: int, compiled: bool | None) -> Any:
    """Replay ``entry`` over the rank-stacked ``tree`` issuing buckets in
    ``dispatch`` order with the entry's staging window kept ahead."""
    buckets = bucketing.pack_buckets(tree, entry.spec)
    order = [k for k in dispatch if buckets[k].numel()]
    out: list = list(buckets)  # empty buckets pass through untouched

    staged: dict[int, Any] = {}

    def _stage(k: int) -> None:
        b = buckets[k]
        if stage:
            b = chunked_copy(b.reshape(-1), chunk_elems=stage_chunk).view(b.shape)
        staged[k] = b

    depth = max(1, entry.overlap_depth)
    for i, k in enumerate(order):
        for j in order[i : i + depth]:   # keep the window staged ahead
            if j not in staged:
                _stage(j)
        b = staged.pop(k)
        for ax in entry.axes:
            b = apply_plan(entry.plans[ax][k], b, compiled=compiled)
        out[k] = b
    return bucketing.unpack_buckets(out, entry.spec)


def execute_stream_entry(
    entry: StreamEntry,
    tree: Any,
    *,
    stage: bool = False,
    stage_chunk: int = 64 * 1024,
    compiled: bool | None = None,
) -> Any:
    """Replay ONE stream entry over a rank-stacked tree (leaves
    ``(n, *shape)``). Buckets are updated in place; with ``stage`` every
    bucket is first copied through the ``chunked_copy`` kernel and the
    copies are what the collectives update."""
    return _run_entry(entry, tree, entry.order, stage=stage,
                      stage_chunk=stage_chunk, compiled=compiled)
