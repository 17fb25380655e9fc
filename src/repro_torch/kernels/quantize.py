"""Per-block quantize / dequantize (CUDA), with their plain PyTorch versions.

A compressed collective hop ships each row of a chunk as a one-byte payload
(int8 or float8 e4m3fn) plus one f32 scale per 256-element block. Replaces
the reference's Pallas ``quantize_blocks`` / ``dequantize_blocks``
(``src/repro/kernels/quantize.py:73,101``) together with the padding of
their wrappers (``src/repro/kernels/ops.py:67-105``); the kernels and their
design note are in ``csrc/quantize.cu``.

Wrapper semantics are the reference's: a ragged column tail counts as zeros
up to ``Cp`` (C rounded up to a multiple of 256), payloads have ``Cp``
columns and scales ``Cp // 256``, and a zero-row input returns empty
results without a launch. ``rows=`` addresses the input (quantize) or
output (dequantize) rows through an int64 index tensor, so one launch
covers the send blocks of several ranks where they lie in the rank-stacked
buffer: ``quantize_blocks(x, f, rows=i)`` equals ``quantize_blocks(x[i], f)``.
A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. A row index outside the addressed tensor stops the kernel
(``__trap``), surfacing as a CUDA error at the next synchronization. On the
card dequantize writes aligned float4s at any output row offset (odd
pitches, a receive view).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = [
    "BLOCK_ELEMS", "QUANT_DTYPES",
    "quantize_blocks", "dequantize_blocks",
    "quantize_blocks_plain", "dequantize_blocks_plain",
]

BLOCK_ELEMS = 256

# wire format -> (payload dtype, qmax): int8 uses the symmetric [-127, 127]
# grid; e4m3fn has no inf (a cast past 448 is NaN), so the clip comes first
QUANT_DTYPES = {
    "int8": (torch.int8, 127.0),
    "fp8": (torch.float8_e4m3fn, 448.0),
}
_FMT_CODE = {"int8": 0, "fp8": 1}

# scale floor for all-zero blocks (payload 0, so the roundtrip stays exact)
_SCALE_FLOOR = 1e-30


def _check_fmt(fmt: str) -> None:
    if fmt not in QUANT_DTYPES:
        raise ValueError(f"unknown quantize format {fmt!r}; expected one of "
                         f"{sorted(QUANT_DTYPES)}")


def _blocks(C: int) -> int:
    return -(-max(C, 1) // BLOCK_ELEMS)


def _check_rows(rows, device) -> None:
    if rows is not None and (rows.dtype != torch.int64 or rows.dim() != 1
                             or rows.device != device):
        raise TypeError("rows must be a 1-D int64 tensor on the data's device")


def quantize_blocks_plain(x: torch.Tensor, fmt: str, *, rows=None):
    """``(values (B, Cp), scales (B, Cp // 256))`` for f32 ``x`` (B, C)."""
    _check_fmt(fmt)
    dtype, qmax = QUANT_DTYPES[fmt]
    if rows is not None:
        x = x[rows]
    B, C = x.shape
    nb = _blocks(C)
    x = x.float()
    if nb * BLOCK_ELEMS != C:
        x = torch.nn.functional.pad(x, (0, nb * BLOCK_ELEMS - C))
    blocks = x.reshape(B, nb, BLOCK_ELEMS)
    amax = blocks.abs().amax(dim=-1, keepdim=True)  # NaN propagates
    # the reference's XLA folds ``/ qmax`` into a multiply by the f32
    # reciprocal; the payload's ``/ scale`` stays an IEEE division
    inv_qmax = torch.tensor(1.0 / qmax, dtype=torch.float32, device=x.device)
    scale = torch.clamp(amax, min=_SCALE_FLOOR) * inv_qmax
    q = torch.clamp(blocks / scale, -qmax, qmax)
    if fmt == "int8":
        q = torch.round(q)  # half to even, as jnp.round and rintf
    return q.to(dtype).reshape(B, nb * BLOCK_ELEMS), scale.reshape(B, nb)


def dequantize_blocks_plain(values: torch.Tensor, scales: torch.Tensor, *,
                            out_cols: int | None = None, out=None, rows=None):
    """``values.float() * scale`` per block, the first ``out_cols`` columns;
    written into ``out`` (rows ``rows`` of it, when given) if ``out`` is
    passed."""
    B, Cp = values.shape
    blocks = values.float().reshape(B, Cp // BLOCK_ELEMS, BLOCK_ELEMS)
    x = (blocks * scales[..., None]).reshape(B, Cp)
    cols = Cp if out_cols is None else out_cols
    x = x[:, :cols]
    if out is None:
        return x
    if rows is None:
        out.copy_(x)
    else:
        out[rows] = x
    return out


def quantize_blocks(x: torch.Tensor, fmt: str, *, rows: torch.Tensor | None = None):
    """Quantize f32 ``x`` (B, C) under ``fmt`` ('int8' | 'fp8') into
    ``(values (B, Cp) int8/float8_e4m3fn, scales (B, Cp // 256) f32)``.
    With ``rows`` (int64 (R,)), quantize rows ``x[rows]`` instead: B = R."""
    _check_fmt(fmt)
    if x.dim() != 2 or x.dtype != torch.float32:
        raise TypeError(f"quantize_blocks takes a 2-D float32 tensor, not "
                        f"{tuple(x.shape)} {x.dtype}")
    _check_rows(rows, x.device)
    B = x.shape[0] if rows is None else rows.shape[0]
    C = x.shape[1]
    nb = _blocks(C)
    dtype, _ = QUANT_DTYPES[fmt]
    if B == 0:
        return (torch.zeros((0, nb * BLOCK_ELEMS), dtype=dtype, device=x.device),
                torch.zeros((0, nb), dtype=torch.float32, device=x.device))
    if x.device.type == "cpu":
        return quantize_blocks_plain(x, fmt, rows=rows)
    if x.device.type != "cuda" or x.stride(1) != 1:
        raise ValueError("quantize_blocks needs a cpu tensor or a cuda tensor with "
                         "contiguous rows")
    values = torch.empty((B, nb * BLOCK_ELEMS), dtype=dtype, device=x.device)
    scales = torch.empty((B, nb), dtype=torch.float32, device=x.device)
    fn = _build.load("quantize").repro_quantize_rows
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_longlong] * 4 + [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = fn(x.data_ptr(), None if rows is None else rows.data_ptr(), x.shape[0],
                x.stride(0), B, C, values.data_ptr(), scales.data_ptr(), _FMT_CODE[fmt],
                stream)
    _build.check(status, "quantize_blocks")
    quantize_blocks.launches += 1
    return values, scales


def dequantize_blocks(values: torch.Tensor, scales: torch.Tensor, *,
                      out_cols: int | None = None, out: torch.Tensor | None = None,
                      rows: torch.Tensor | None = None) -> torch.Tensor:
    """Inverse of :func:`quantize_blocks`: (B, Cp) payload + (B, Cp // 256)
    scales to f32, the first ``out_cols`` columns (all ``Cp`` by default).
    With ``out`` (f32, ``out_cols`` columns), write into it in place — into
    rows ``out[rows]`` when ``rows`` is given — and return it."""
    B, Cp = values.shape
    if Cp % BLOCK_ELEMS or tuple(scales.shape) != (B, Cp // BLOCK_ELEMS):
        raise ValueError(f"values {tuple(values.shape)} and scales "
                         f"{tuple(scales.shape)} are not a quantized block pair")
    fmt = {torch.int8: "int8", torch.float8_e4m3fn: "fp8"}.get(values.dtype)
    if fmt is None or scales.dtype != torch.float32 or scales.device != values.device:
        raise TypeError("dequantize_blocks takes an int8 or float8_e4m3fn payload and "
                        "float32 scales on one device")
    cols = Cp if out_cols is None else int(out_cols)
    if not 0 <= cols <= Cp:
        raise ValueError(f"out_cols {cols} outside [0, {Cp}]")
    _check_rows(rows, values.device)
    if out is not None:
        want_rows = B if rows is None else None
        if (out.dim() != 2 or out.dtype != torch.float32 or out.shape[1] != cols
                or out.device != values.device
                or (want_rows is not None and out.shape[0] != want_rows)):
            raise ValueError(f"out must be float32 ({B if rows is None else 'R'}, {cols}) "
                             f"on the payload's device, not {tuple(out.shape)} {out.dtype}")
        if rows is not None and rows.shape[0] != B:
            raise ValueError("rows must name one output row per payload row")
    if B == 0:
        return out if out is not None else torch.zeros(
            (0, cols), dtype=torch.float32, device=values.device)
    if values.device.type == "cpu":
        return dequantize_blocks_plain(values, scales, out_cols=cols, out=out, rows=rows)
    if values.device.type != "cuda" or not (values.is_contiguous() and scales.is_contiguous()):
        raise ValueError("dequantize_blocks needs contiguous cuda payload and scales")
    if values.data_ptr() % 4:
        raise ValueError("dequantize_blocks needs a 4-byte aligned payload")
    if out is None:
        out = torch.empty((B, cols), dtype=torch.float32, device=values.device)
    elif out.stride(1) != 1:
        raise ValueError("dequantize_blocks writes rows with contiguous columns")
    fn = _build.load("quantize").repro_dequantize_rows
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(values.device).cuda_stream
    status = fn(values.data_ptr(), scales.data_ptr(), B, Cp // BLOCK_ELEMS, cols,
                out.data_ptr(), None if rows is None else rows.data_ptr(), out.shape[0],
                out.stride(0), _FMT_CODE[fmt], stream)
    _build.check(status, "dequantize_blocks")
    dequantize_blocks.launches += 1
    return out


quantize_blocks.launches = 0
dequantize_blocks.launches = 0
