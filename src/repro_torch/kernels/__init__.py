"""Hand-written CUDA kernels of the port, each beside its plain version:

  chunked_copy    — chunked flat-buffer copy (bucket staging)
  combine_update  — fused row-mode merge of the compiled executor
  flash_attention — blocked online-softmax attention (long-context prefill): the
                    sm90 kernel (bf16 wgmma + TMA, head widths 128 and 256) and the
                    CUDA-core one (f32, and bf16 at widths 16-64)
  inkernel_collective — one-launch replay of a whole lowered schedule: the
                    device-initiated kernel (rank groups, point-to-point flags) that
                    the executors call, and the shared-buffer one (grid barrier)
  param_update    — fused mix / scaled_add over flat buffers (no path calls them)
  quantize        — per-256-block quantize / dequantize of the compressed wire

Sources live in ``csrc/`` and are built by :mod:`._build` at first use.
"""
from . import (chunked_copy, combine_update, flash_attention, inkernel_collective, param_update,
               quantize)

__all__ = ["chunked_copy", "combine_update", "flash_attention", "inkernel_collective",
           "param_update", "quantize", "launch_counts", "reset_launch_counts"]

_WRAPPERS = {
    "chunked_copy": (chunked_copy.chunked_copy,),
    # both combine entry points launch the one merge kernel
    "fused_combine": (combine_update.fused_combine, combine_update.fused_combine_update),
    "quantize_blocks": (quantize.quantize_blocks,),
    "dequantize_blocks": (quantize.dequantize_blocks,),
    "inkernel_replay": (inkernel_collective.inkernel_replay_shared,),
    "inkernel_rdma": (inkernel_collective.rdma_replay,),
    "flash_attention": (flash_attention.flash_fwd,),
    "flash_attention_sm90": (flash_attention.flash_sm90,),
    "mix": (param_update.mix,),
    "scaled_add": (param_update.scaled_add,),
}


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {name: sum(w.launches for w in ws) for name, ws in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for ws in _WRAPPERS.values():
        for w in ws:
            w.launches = 0
