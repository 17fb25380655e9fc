"""Chunked copy of a flat buffer (CUDA), with its plain PyTorch version.

Replaces the reference's Pallas ``chunked_copy``
(``src/repro/kernels/chunked_copy.py:37``). The kernel and its design note
are in ``csrc/chunked_copy.cu``: one launch at any alignment, cut by
:func:`copy_plan`. A CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build

__all__ = ["CopyPlan", "TILE_UNITS", "chunked_copy", "chunked_copy_plain", "copy_plan"]

# 16-byte units per tile (kTile in csrc/chunked_copy.cu): 8 vectors of each
# of a block's 256 threads, 32 KiB
TILE_UNITS = 8 * 256


class CopyPlan(NamedTuple):
    """The launch that copies ``nbytes`` bytes: ``head`` bytes up to the
    destination's first 16-byte boundary, ``units`` aligned 16-byte units,
    ``tail`` bytes after them, over ``grid`` blocks, one a tile of
    :data:`TILE_UNITS` units (block 0 also copies the head, the last block
    the tail). The kernel takes these four numbers as they are."""

    grid: int
    head: int
    units: int
    tail: int


def copy_plan(nbytes: int, dst: int) -> CopyPlan:
    """The cut of a copy of ``nbytes`` > 0 bytes to address ``dst``."""
    head = min((16 - dst % 16) % 16, nbytes)
    units = (nbytes - head) // 16
    grid = max(1, -(-units // TILE_UNITS))
    if grid >= 2 ** 31:
        raise ValueError(f"chunked_copy: {nbytes} bytes need {grid} blocks, over CUDA's grid")
    return CopyPlan(grid, head, units, nbytes - head - 16 * units)


def chunked_copy_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain version: a fresh copy of ``x``."""
    return x.clone()


def _launch(out: torch.Tensor, x: torch.Tensor) -> None:
    """One launch copying ``x``'s bytes into ``out`` (both contiguous CUDA
    tensors of as many bytes, at any addresses); counts nothing."""
    dst = out.data_ptr()
    plan = copy_plan(x.numel() * x.element_size(), dst)
    fn = _build.load("chunked_copy").repro_chunked_copy
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(fn(dst, x.data_ptr(), plan.head, plan.units, plan.tail, plan.grid, stream),
                 "chunked_copy")


def chunked_copy(x: torch.Tensor, *, chunk_elems: int = 64 * 1024) -> torch.Tensor:
    """Copy a contiguous 1-D buffer of any dtype into a new tensor (ragged
    tail masked, never padded). ``chunk_elems`` is accepted only to match
    the reference's signature and is ignored: there it cuts the Pallas
    grid (clamped to at least 128 elements and at most the buffer, so no
    value is refused), every chunking copies the same bytes, and here the
    kernel's 32 KiB tiles set the grid (:func:`copy_plan`)."""
    if x.dim() != 1:
        raise ValueError(f"chunked_copy operates on flat buffers, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("chunked_copy needs a contiguous buffer")
    if x.device.type == "cpu":
        return chunked_copy_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"chunked_copy runs on cuda or cpu tensors, not {x.device}")
    out = torch.empty_like(x)
    if x.numel():
        _launch(out, x)
        chunked_copy.launches += 1
    return out


chunked_copy.launches = 0
