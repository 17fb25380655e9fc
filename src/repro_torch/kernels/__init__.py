"""Hand-written CUDA kernels of the port, each beside its plain version:

  chunked_copy    — chunked flat-buffer copy (bucket staging)
  combine_update  — fused row-mode merge of the compiled executor
  inkernel_collective — one-launch replay of a whole lowered schedule
  quantize        — per-256-block quantize / dequantize of the compressed wire

Sources live in ``csrc/`` and are built by :mod:`._build` at first use.
"""
from . import chunked_copy, combine_update, inkernel_collective, quantize

__all__ = ["chunked_copy", "combine_update", "inkernel_collective", "quantize", "launch_counts",
           "reset_launch_counts"]

_WRAPPERS = {
    "chunked_copy": (chunked_copy.chunked_copy,),
    # both combine entry points launch the one merge kernel
    "fused_combine": (combine_update.fused_combine, combine_update.fused_combine_update),
    "quantize_blocks": (quantize.quantize_blocks,),
    "dequantize_blocks": (quantize.dequantize_blocks,),
    "inkernel_replay": (inkernel_collective.inkernel_replay_shared,),
}


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {name: sum(w.launches for w in ws) for name, ws in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for ws in _WRAPPERS.values():
        for w in ws:
            w.launches = 0
