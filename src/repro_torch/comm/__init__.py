"""repro_torch.comm — the collective-plan layer on the emulated mesh.

Layering, as in the reference:

    core.schedules (IR)  ->  comm.schedules (per-op builders)
                         ->  comm.plan      (CollectivePlan: decide + build)
                         ->  comm.executors (replay on a rank-stacked buffer)
                         ->  comm.api       (apply_plan, pbcast, preduce,
                                             pallreduce, pallgather,
                                             preduce_scatter, pallgatherv,
                                             palltoallv, *_tree)
                         ->  comm.streams   (multi-stream link scheduler;
                                             comm.overlap = 1-stream case)

The fault runtime sits beside them: ``comm.faults`` (the fault model and
the typed errors), ``plan_degraded`` (replanning on the surviving ranks)
and ``comm.resilience`` with ``apply_plan_resilient`` (the fallback chain
and the straggler watchdog).
"""
from ..core.tuner import OPS, Decision, OnlineTuner, Tuner, default_tuner
from .api import (
    apply_plan,
    apply_plan_resilient,
    hierarchical_allreduce_axes,
    level_replay,
    pallgather,
    pallgatherv,
    pallreduce,
    pallreduce_tree,
    palltoallv,
    pbcast,
    pbcast_tree,
    preduce,
    preduce_scatter,
)
from .compress import (
    CompressedWire,
    CompressionState,
    WireFormat,
    normalize_wire_format,
    roundtrip,
    wire_chunk_bytes,
)
from .executors import execute_collective, execute_compiled, execute_inkernel
from .faults import (
    DeadRankError,
    FallbackExhaustedError,
    FaultError,
    FaultSpec,
    MeshHealth,
    TransientDropError,
    WeightSyncError,
)
from .overlap import (
    OverlapPlan,
    execute_overlap,
    overlap_allreduce_tree,
    plan_overlap,
    simulate_overlap,
)
from .plan import (
    CollectivePlan,
    cache_stats,
    decide,
    expected_wire_bytes,
    plan_cache_clear,
    plan_cache_info,
    plan_cached,
    plan_collective,
    plan_degraded,
)
from .resilience import FallbackEvent, FallbackPolicy, StragglerReport, Watchdog
from .streams import (
    StreamEntry,
    StreamGraph,
    StreamGraphError,
    StreamSpec,
    dispatch_schedule,
    execute_stream_entry,
    execute_streams,
    graph_key,
    plan_streams,
    simulate_streams,
)

__all__ = [
    "OPS",
    "Decision",
    "Tuner",
    "OnlineTuner",
    "default_tuner",
    "WireFormat",
    "normalize_wire_format",
    "wire_chunk_bytes",
    "CompressedWire",
    "CompressionState",
    "roundtrip",
    "CollectivePlan",
    "plan_collective",
    "plan_degraded",
    "plan_cached",
    "plan_cache_clear",
    "plan_cache_info",
    "cache_stats",
    "decide",
    "expected_wire_bytes",
    "execute_collective",
    "execute_compiled",
    "execute_inkernel",
    "apply_plan",
    "apply_plan_resilient",
    "pbcast",
    "preduce",
    "pallreduce",
    "pallgather",
    "pallgatherv",
    "palltoallv",
    "preduce_scatter",
    "pbcast_tree",
    "pallreduce_tree",
    "hierarchical_allreduce_axes",
    "level_replay",
    "OverlapPlan",
    "plan_overlap",
    "simulate_overlap",
    "execute_overlap",
    "overlap_allreduce_tree",
    "StreamSpec",
    "StreamEntry",
    "StreamGraph",
    "StreamGraphError",
    "graph_key",
    "plan_streams",
    "simulate_streams",
    "dispatch_schedule",
    "execute_streams",
    "execute_stream_entry",
    "FaultError",
    "DeadRankError",
    "TransientDropError",
    "FallbackExhaustedError",
    "WeightSyncError",
    "FaultSpec",
    "MeshHealth",
    "FallbackPolicy",
    "FallbackEvent",
    "StragglerReport",
    "Watchdog",
]
