"""Hand-written CUDA kernels of the port, each beside its plain version:

  chunked_copy    — chunked flat-buffer copy (bucket staging)
  combine_update  — fused row-mode merge of the compiled executor

Sources live in ``csrc/`` and are built by :mod:`._build` at first use.
"""
from . import chunked_copy, combine_update

__all__ = ["chunked_copy", "combine_update", "launch_counts", "reset_launch_counts"]

_WRAPPERS = {
    "chunked_copy": (chunked_copy.chunked_copy,),
    # both combine entry points launch the one merge kernel
    "fused_combine": (combine_update.fused_combine, combine_update.fused_combine_update),
}


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {name: sum(w.launches for w in ws) for name, ws in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for ws in _WRAPPERS.values():
        for w in ws:
            w.launches = 0
