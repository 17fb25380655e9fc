"""Chunked copy of a flat buffer (CUDA), with its plain PyTorch version.

Replaces the reference's Pallas ``chunked_copy``
(``src/repro/kernels/chunked_copy.py:37``). The kernel and its design note
are in ``csrc/chunked_copy.cu``. A CPU tensor takes the plain version; a
CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["chunked_copy", "chunked_copy_plain"]

_LANE = 128  # minimum chunk, as in the reference


def chunked_copy_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain version: a fresh copy of ``x``."""
    return x.clone()


def _launch(out: torch.Tensor, x: torch.Tensor, chunk_bytes: int) -> None:
    lib = _build.load("chunked_copy")
    fn = lib.repro_chunked_copy
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    nbytes = x.numel() * x.element_size()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(fn(out.data_ptr(), x.data_ptr(), nbytes, chunk_bytes, stream),
                 "chunked_copy")


def chunked_copy(x: torch.Tensor, *, chunk_elems: int = 64 * 1024) -> torch.Tensor:
    """Copy a contiguous 1-D buffer of any dtype in ``chunk_elems`` chunks
    into a new tensor (ragged tail masked, never padded)."""
    if x.dim() != 1:
        raise ValueError(f"chunked_copy operates on flat buffers, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("chunked_copy needs a contiguous buffer")
    if x.device.type == "cpu":
        return chunked_copy_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"chunked_copy runs on cuda or cpu tensors, not {x.device}")
    chunk_elems = max(_LANE, min(chunk_elems, max(x.numel(), _LANE)))
    out = torch.empty_like(x)
    if x.numel():
        _launch(out, x, chunk_elems * x.element_size())
        chunked_copy.launches += 1
    return out


chunked_copy.launches = 0
