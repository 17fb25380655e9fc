"""Fused combine-update (CUDA), with its plain PyTorch version.

One replay round of a lane class merges the received block into the
buffer window it lands on: ``cur + recv`` on the rows the schedule
addressed this round when the round combines, ``recv`` when it overwrites,
``cur`` everywhere else. Replaces the reference's Pallas ``fused_combine``
(``src/repro/kernels/combine_update.py:52``) and its wrapper
``fused_combine_update`` (``:82``); the kernel and its design note are in
``csrc/combine_update.cu``.

Both entry points update their first argument in place (the reference
aliases it onto the output). A CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises. bf16 and float32 only.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = [
    "KEEP", "OVERWRITE", "ACCUMULATE",
    "fused_combine", "fused_combine_update",
    "fused_combine_plain", "fused_combine_update_plain",
]

# row modes
KEEP, OVERWRITE, ACCUMULATE = 0, 1, 2

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fused_combine_plain(cur: torch.Tensor, recv: torch.Tensor,
                        row_mode: torch.Tensor) -> torch.Tensor:
    """``where(mode == 2, cur + recv, where(mode == 1, recv, cur))`` written
    back into ``cur``. The where form (not ``cur + where(mode, recv, 0)``)
    keeps KEEP rows bit-identical, -0.0 included."""
    merged = torch.where(row_mode == ACCUMULATE, cur + recv,
                         torch.where(row_mode == OVERWRITE, recv, cur))
    cur.copy_(merged)
    return cur


def fused_combine_update_plain(buf: torch.Tensor, recv: torch.Tensor, start,
                               lo, hi, combine) -> torch.Tensor:
    """Per rank ``r``: rows ``[start[r] + lo[r], start[r] + hi[r])`` of
    ``buf[r]`` merge the matching rows of ``recv[r]``; every other row of
    the ``[start[r], start[r] + block)`` window is left as it was."""
    B = recv.shape[1]
    rows = torch.arange(B, device=buf.device)
    for r in range(buf.shape[0]):
        s = int(start[r])
        valid = (rows >= int(lo[r])) & (rows < int(hi[r]))
        mode = (valid.to(torch.int32) * (1 + int(combine))).reshape(B, 1)
        fused_combine_plain(buf[r, s:s + B], recv[r], mode)
    return buf


def _check_pair(cur: torch.Tensor, recv: torch.Tensor) -> None:
    if cur.dtype not in _DTYPES:
        raise TypeError(f"fused_combine takes float32 or bfloat16, not {cur.dtype}")
    if recv.dtype != cur.dtype or recv.device != cur.device:
        raise TypeError("cur and recv must share dtype and device")
    if cur.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_combine runs on cuda or cpu tensors, not {cur.device}")


def _launch(buf, recv, start, lo, hi, row_mode, rows, B, K, C, combine) -> None:
    lib = _build.load("combine_update")
    fn = lib.repro_merge_rows
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                                           ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    status = fn(buf.data_ptr(), recv.data_ptr(), ptr(start), ptr(lo), ptr(hi),
                ptr(row_mode), rows, B, K, C, int(combine), _DTYPES[buf.dtype], stream)
    _build.check(status, "fused_combine")


def fused_combine(cur: torch.Tensor, recv: torch.Tensor,
                  row_mode: torch.Tensor) -> torch.Tensor:
    """Merge ``recv`` into ``cur`` row-wise under ``row_mode``, in place.

    ``cur``/``recv``: (block, chunk_elems); ``row_mode``: (block, 1) int32 of
    KEEP (0) / OVERWRITE (1) / ACCUMULATE (2). Returns ``cur``."""
    _check_pair(cur, recv)
    if cur.dim() != 2 or recv.shape != cur.shape or tuple(row_mode.shape) != (cur.shape[0], 1):
        raise ValueError(f"shapes cur {tuple(cur.shape)}, recv {tuple(recv.shape)}, "
                         f"row_mode {tuple(row_mode.shape)}; want (B, C), (B, C), (B, 1)")
    if row_mode.dtype != torch.int32 or row_mode.device != cur.device:
        raise TypeError("row_mode must be int32 on the buffer's device")
    if cur.device.type == "cpu":
        return fused_combine_plain(cur, recv, row_mode)
    if not (cur.is_contiguous() and recv.is_contiguous() and row_mode.is_contiguous()):
        raise ValueError("fused_combine needs contiguous tensors on cuda")
    B, C = cur.shape
    zero = torch.zeros(1, dtype=torch.int32, device=cur.device)
    _launch(cur, recv, zero, None, None, row_mode, B, B, B, C, 0)
    fused_combine.launches += 1
    return cur


def fused_combine_update(buf: torch.Tensor, recv: torch.Tensor, start: torch.Tensor,
                         lo: torch.Tensor, hi: torch.Tensor, combine) -> torch.Tensor:
    """Apply one lane-class round to the rank-stacked ``buf`` (n, K, C) in
    place: for each rank ``r``, rows ``[start[r] + lo[r], start[r] + hi[r])``
    merge the matching rows of ``recv[r]`` (add when ``combine`` is truthy,
    else overwrite); no other row is written. ``start``/``lo``/``hi`` are
    int32 ``(n,)`` tensors on the buffer's device (rows of the lowered round
    tables); the caller guarantees ``start[r] + recv.shape[1] <= K``, which
    the lowering's clipped starts do. Returns ``buf``."""
    _check_pair(buf, recv)
    if buf.dim() != 3 or recv.dim() != 3 or recv.shape[0] != buf.shape[0] \
            or recv.shape[2] != buf.shape[2] or recv.shape[1] > buf.shape[1]:
        raise ValueError(f"buf {tuple(buf.shape)} and recv {tuple(recv.shape)}: "
                         "want (n, K, C) and (n, B, C) with B <= K")
    n = buf.shape[0]
    for name, t in (("start", start), ("lo", lo), ("hi", hi)):
        if t.dtype != torch.int32 or tuple(t.shape) != (n,) or t.device != buf.device:
            raise TypeError(f"{name} must be int32 of shape ({n},) on the buffer's device")
    if buf.device.type == "cpu":
        return fused_combine_update_plain(buf, recv, start, lo, hi, combine)
    if not all(t.is_contiguous() for t in (buf, recv, start, lo, hi)):
        raise ValueError("fused_combine_update needs contiguous tensors on cuda")
    _, K, C = buf.shape
    B = recv.shape[1]
    _launch(buf, recv, start, lo, hi, None, n * B, B, K, C, combine)
    fused_combine_update.launches += 1
    return buf


fused_combine.launches = 0
fused_combine_update.launches = 0
