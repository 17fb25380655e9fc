"""Serving on the emulated mesh."""
from .engine import (
    Engine,
    GenerationResult,
    distribute_weights,
    distribution_stream_graph,
    plan_distribution,
    replicate,
)

__all__ = [
    "Engine",
    "GenerationResult",
    "distribute_weights",
    "distribution_stream_graph",
    "plan_distribution",
    "replicate",
]
