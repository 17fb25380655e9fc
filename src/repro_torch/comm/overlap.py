"""Overlap engine: tuned *schedules of* collectives (DESIGN.md Sec. 8).

The paper's end-to-end result (7% CNTK speedup at 128 GPUs, Sec. V-D) does
not come from any single collective — it comes from *pipelining*: the
chunked chain overlaps the stages of one broadcast, and the application win
comes from hiding communication behind training compute. Awan et al.
(1810.11112) show the same structure — bucketed collectives streamed
against backprop — is what makes CUDA-Aware MPI competitive for TF
training.

This module is the SINGLE-STREAM case of :mod:`repro_torch.comm.streams`:
an :class:`OverlapPlan` is exactly a 1-entry
:class:`~repro_torch.comm.streams.StreamGraph`, and every function here is
a thin wrapper —

* :func:`plan_overlap` delegates to :func:`streams.plan_streams` with one
  :class:`~repro_torch.comm.streams.StreamSpec` (same depth-resolution
  tiers, same ``plan_cached`` path keyed on the graph fingerprint);
* :func:`simulate_overlap` replays the 1-entry graph through
  :func:`streams.simulate_streams` (for one stream the arbiter reduces
  exactly to ``cost_model.window_finish_times``) and re-shapes the
  accounting into the single-stream keys;
* :func:`execute_overlap` / :func:`overlap_allreduce_tree` replay through
  :func:`streams.execute_stream_entry` over rank-stacked trees.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

from ..core import bucketing, cost_model
from ..core.bucketing import BucketSpec
from ..core.tree import tree_leaves
from ..core.tuner import Tuner
from . import streams
from .api import _levels, _rank_view
from .plan import CollectivePlan

__all__ = [
    "OverlapPlan",
    "plan_overlap",
    "simulate_overlap",
    "execute_overlap",
    "overlap_allreduce_tree",
]

# the canonical entry name a 1-stream graph carries
_ENTRY = "overlap"


@dataclasses.dataclass(frozen=True)
class OverlapPlan:
    """A fully-resolved schedule-of-collectives: bucket mix + per-(axis,
    bucket) plans + dispatch order + in-flight window. Exactly the payload
    of one :class:`~repro_torch.comm.streams.StreamEntry` minus the
    arbitration metadata (a single stream has nothing to contend with)."""

    op: str
    spec: BucketSpec
    axes: tuple[str, ...]                        # sync order (hierarchy levels)
    plans: dict[str, tuple[CollectivePlan, ...]]  # per axis, one plan per bucket
    order: tuple[int, ...]                       # bucket dispatch order
    overlap_depth: int
    compute_s: float                             # hidden-compute budget (s)
    depth_source: str            # 'manual' | 'stream' | 'empirical' | 'analytic'

    def as_entry(self, name: str = _ENTRY, *, priority: int = 0,
                 link: str = "ici", after: tuple[str, ...] = ()) -> streams.StreamEntry:
        """This plan as a stream entry — the bridge every wrapper rides."""
        return streams.StreamEntry(
            name=name, op=self.op, spec=self.spec, axes=self.axes,
            plans=self.plans, order=self.order,
            overlap_depth=self.overlap_depth, compute_s=self.compute_s,
            depth_source=self.depth_source, priority=priority, after=after,
            link=link,
        )

    def as_graph(self) -> streams.StreamGraph:
        """This plan as a 1-entry stream graph (its replay is bit-identical
        to this plan's)."""
        return streams.StreamGraph((self.as_entry(),))

    @property
    def num_buckets(self) -> int:
        return self.spec.num_buckets

    def bucket_comm_s(self) -> list[float]:
        """Per-bucket predicted collective time, summed over hierarchy
        levels, in DISPATCH order."""
        return self.as_entry().bucket_comm_s()

    def bucket_stage_s(self, hw: cost_model.Hardware | None = None) -> list[float]:
        """Per-bucket staging (pack / ``chunked_copy``) time in dispatch
        order: one HBM read + one HBM write of the bucket."""
        return self.as_entry().bucket_stage_s(hw)

    def wire_bytes(self) -> int:
        """Total bytes on the wire — exactly the sum of the per-bucket plan
        accounting (overlap reorders transfers, it never adds any)."""
        return self.as_entry().wire_bytes()

    def barrier_s(self, hw: cost_model.Hardware | None = None) -> float:
        return cost_model.t_bucketed_barrier(
            self.bucket_comm_s(), self.compute_s, self.bucket_stage_s(hw)
        )

    def overlapped_s(self, hw: cost_model.Hardware | None = None) -> float:
        return cost_model.t_overlapped(
            self.bucket_comm_s(),
            self.compute_s,
            depth=self.overlap_depth,
            stage_s=self.bucket_stage_s(hw),
        )

    def efficiency(self, hw: cost_model.Hardware | None = None) -> float:
        """Fraction of the barrier schedule's span the overlap removes."""
        barrier = self.barrier_s(hw)
        if barrier <= 0.0:
            return 0.0
        return max(0.0, 1.0 - self.overlapped_s(hw) / barrier)


def plan_overlap(
    tree: Any,
    axes: Sequence[tuple[str, int]],
    *,
    op: str = "allreduce",
    root: int = 0,
    algo: str = "auto",
    tuner: Tuner | None = None,
    bucket_bytes: int = 4 << 20,
    inter_pod_axes: Sequence = (),
    compute_s: float = 0.0,
    overlap_depth: int | None = None,
    reverse: bool = True,
    spec: BucketSpec | None = None,
) -> OverlapPlan:
    """Resolve a schedule-of-collectives for ONE rank's ``tree`` (only
    shapes and dtypes are read) over the mesh ``axes`` (name, size) pairs,
    hierarchy levels in the given order.

    ``reverse=True`` dispatches buckets in reverse tree-flatten order
    (gradient availability order during backprop); weight distribution
    passes ``reverse=False`` (buckets stream in load order).

    Depth resolution order: explicit ``overlap_depth`` > a
    ``stream:overlap`` tuner entry > a tuned ``overlap_depth`` in the
    tuner's per-op table (largest bucket's entry) > the analytic
    :func:`cost_model.optimal_overlap_depth` sweep.
    """
    graph = streams.plan_streams(
        [
            streams.StreamSpec(
                name=_ENTRY, tree=tree, axes=tuple(tuple(a) for a in axes),
                op=op, root=root, algo=algo, priority=0,
                overlap_depth=overlap_depth, compute_s=compute_s,
                bucket_bytes=bucket_bytes,
                inter_pod_axes=tuple(inter_pod_axes), reverse=reverse,
                spec=spec,
            )
        ],
        tuner=tuner,
    )
    e = graph.entries[0]
    return OverlapPlan(
        e.op, e.spec, e.axes, e.plans, e.order, e.overlap_depth, e.compute_s,
        e.depth_source,
    )


def simulate_overlap(oplan: OverlapPlan, hw: cost_model.Hardware | None = None,
                     faults=None) -> dict:
    """Discrete-round replay of the overlapped timeline vs the barrier one.

    Delegates to :func:`streams.simulate_streams` on the 1-entry graph —
    for one stream the link arbiter IS the greedy window recurrence
    (``cost_model.window_finish_times``) — and re-shapes the multi-stream
    accounting into the single-stream keys. For >= 2 non-empty buckets the
    overlapped schedule has STRICTLY fewer network-idle rounds than the
    barrier one.

    With ``faults`` (a :class:`~repro_torch.comm.faults.FaultSpec`) every
    bucket's clock runs the degraded ``timed_rounds`` and the result gains
    :func:`streams.simulate_streams`' four fault keys; dead ranks raise
    ``DeadRankError``."""
    hw = hw or cost_model.H100_SXM
    sim = streams.simulate_streams(oplan.as_graph(), hw, faults=faults)
    s = sim["streams"][_ENTRY]
    K = s["num_buckets"]
    # barrier: all compute, then all staging, then every transfer
    barrier_idle = s["compute_rounds"] + s["stage_rounds"]
    out = {
        "num_buckets": K,
        "overlap_depth": max(1, min(oplan.overlap_depth, max(K, 1))),
        "comm_rounds": s["comm_rounds"],
        "compute_rounds": s["compute_rounds"],
        "barrier_span_rounds": barrier_idle + s["comm_rounds"],
        "overlap_span_rounds": s["finish_round"],
        "idle_rounds_barrier": barrier_idle,
        "idle_rounds_overlap": s["idle_rounds"],
        "barrier_s": oplan.barrier_s(hw),
        "overlapped_s": oplan.overlapped_s(hw),
        "efficiency": oplan.efficiency(hw),
        "wire_bytes": oplan.wire_bytes(),
    }
    if faults is not None:
        for key in ("comm_s_healthy", "comm_s_faulty", "fault_slowdown", "fault_fingerprint"):
            out[key] = sim[key]
    return out


def execute_overlap(
    oplan: OverlapPlan,
    tree: Any,
    *,
    stage: bool = False,
    stage_chunk: int = 64 * 1024,
    fused: bool = True,
    compiled: bool | None = None,
    mesh=None,
    inkernel: bool | None = None,
) -> Any:
    """Replay an :class:`OverlapPlan` over a rank-stacked tree (leaves
    ``(n, *shape)``), updated in place and returned: buckets issue in
    dispatch order, and the next ``overlap_depth - 1`` buckets are staged
    (``chunked_copy`` when ``stage=True``) before the current bucket's
    collectives. Per-bucket math is the barrier ``*_tree`` path's (same
    plans, same executors, the same levels). Delegates to
    :func:`streams.execute_stream_entry` on the 1-entry graph; ``mesh`` and
    ``inkernel`` as there."""
    return streams.execute_stream_entry(
        oplan.as_entry(), tree, stage=stage, stage_chunk=stage_chunk,
        fused=fused, compiled=compiled, mesh=mesh, inkernel=inkernel,
    )


def overlap_allreduce_tree(
    tree: Any,
    axes: Sequence,
    *,
    algo: str = "auto",
    tuner: Tuner | None = None,
    bucket_bytes: int = 4 << 20,
    inter_pod_axes: Sequence = (),
    overlap_depth: int | None = None,
    compute_s: float = 0.0,
    stage: bool = False,
    stage_chunk: int = 64 * 1024,
    compiled: bool | None = None,
    mesh=None,
    inkernel: bool | None = None,
) -> Any:
    """Bucket-streamed all-reduce of a rank-stacked pytree: the overlap
    engine's counterpart of :func:`~repro_torch.comm.api.pallreduce_tree`
    (same bucketing, same hierarchy levels, same per-bucket plans, so the
    same bits), with buckets dispatched in backward-streaming order inside
    the tuned in-flight window. Over one axis and without ``mesh`` the
    axis size is the leaves' leading (rank) dimension; over more, as for
    ``pallreduce_tree``, the leaves are stacked over ``mesh``'s ranks and
    each axis's size is the mesh's."""
    axes = _levels(axes, mesh)
    leaves = tree_leaves(tree)
    if not axes or not leaves:
        return tree
    if mesh is None:
        sized = [(axes[0], leaves[0].shape[0])]
    else:
        sizes = dict(zip(tuple(mesh.axis_names), tuple(mesh.devices.shape)))
        sized = [(ax, sizes[ax]) for ax in axes]
    view = _rank_view(tree)
    oplan = plan_overlap(
        view,
        sized,
        op="allreduce",
        algo=algo,
        tuner=tuner,
        bucket_bytes=bucket_bytes,
        inter_pod_axes=inter_pod_axes,
        compute_s=compute_s,
        overlap_depth=overlap_depth,
        reverse=True,
        spec=bucketing.plan_buckets(view, bucket_bytes),
    )
    return execute_overlap(
        oplan, tree, stage=stage, stage_chunk=stage_chunk, compiled=compiled, mesh=mesh,
        inkernel=inkernel,
    )
