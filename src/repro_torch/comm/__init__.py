"""repro_torch.comm — the collective-plan layer on the emulated mesh.

Layering, as in the reference:

    core.schedules (IR)  ->  comm.schedules (per-op builders)
                         ->  comm.plan      (CollectivePlan: decide + build)
                         ->  comm.executors (replay on a rank-stacked buffer)
                         ->  comm.api       (apply_plan, pbcast, preduce,
                                             pallreduce, pallgather,
                                             preduce_scatter, *_tree)
                         ->  comm.streams   (stream entries)
"""
from ..core.tuner import OPS, Decision, Tuner, default_tuner
from .api import (
    apply_plan,
    hierarchical_allreduce_axes,
    pallgather,
    pallreduce,
    pallreduce_tree,
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
from .plan import (
    CollectivePlan,
    cache_stats,
    decide,
    expected_wire_bytes,
    plan_cache_clear,
    plan_cached,
    plan_collective,
)
from .streams import StreamEntry, StreamGraph, execute_stream_entry, graph_key

__all__ = [
    "OPS",
    "Decision",
    "Tuner",
    "default_tuner",
    "WireFormat",
    "normalize_wire_format",
    "wire_chunk_bytes",
    "CompressedWire",
    "CompressionState",
    "roundtrip",
    "CollectivePlan",
    "plan_collective",
    "plan_cached",
    "plan_cache_clear",
    "cache_stats",
    "decide",
    "expected_wire_bytes",
    "execute_collective",
    "execute_compiled",
    "execute_inkernel",
    "apply_plan",
    "pbcast",
    "preduce",
    "pallreduce",
    "pallgather",
    "preduce_scatter",
    "pbcast_tree",
    "pallreduce_tree",
    "hierarchical_allreduce_axes",
    "StreamEntry",
    "StreamGraph",
    "graph_key",
    "execute_stream_entry",
]
