"""Wire formats for collectives, as in the reference's ``comm/compress.py``.

A :class:`WireFormat` is the per-plan choice of what bytes cross the link
for each chunk transfer: ``bf16`` is the bit-identical passthrough (any
dtype passes through), ``int8``/``fp8`` are per-256-element-block
quantized payloads plus one f32 scale per block.

Compression acts PER HOP at the executors' exchange seam
(:class:`CompressedWire`): the sender quantizes its block, payload and
scales cross as row copies, and the receiver dequantizes before the merge,
so combine arithmetic stays f32. :class:`CompressionState` holds the
error-feedback helpers the compressed train step uses.
"""
from __future__ import annotations

import dataclasses
import enum

import torch

from ..core.tree import tree_map
from ..kernels.quantize import BLOCK_ELEMS, dequantize_blocks, quantize_blocks

__all__ = [
    "WireFormat",
    "normalize_wire_format",
    "wire_chunk_bytes",
    "BLOCK_ELEMS",
    "CompressedWire",
    "CompressionState",
    "roundtrip",
]

# one f32 scale per BLOCK_ELEMS single-byte payload elements
_SCALE_BYTES = 4
_BLOCK_WIRE_BYTES = BLOCK_ELEMS + _SCALE_BYTES  # 260


class WireFormat(str, enum.Enum):
    """What a chunk looks like on the wire."""

    BF16 = "bf16"   # passthrough, bit-identical
    FP8 = "fp8"     # float8_e4m3fn payload + f32 block scales
    INT8 = "int8"   # int8 payload + f32 block scales

    @property
    def compressed(self) -> bool:
        return self is not WireFormat.BF16

    @property
    def nominal_ratio(self) -> float:
        """Declared payload reduction vs the f32 wire domain (the scale
        sidecar and block padding make the physical ratio slightly lower —
        4 * 256 / 260 ≈ 3.94 for a block-aligned chunk)."""
        return 4.0 if self.compressed else 1.0


def normalize_wire_format(fmt) -> WireFormat:
    """``None`` / strings / enum members -> :class:`WireFormat`."""
    if fmt is None:
        return WireFormat.BF16
    try:
        return WireFormat(fmt)
    except ValueError:
        raise ValueError(
            f"unknown wire format {fmt!r}; expected one of "
            f"{[f.value for f in WireFormat]}"
        ) from None


def wire_chunk_bytes(fmt, chunk_bytes: int) -> int:
    """Physical bytes on the wire for one transfer of a ``chunk_bytes``
    full-precision chunk under ``fmt``.

    Compressed formats operate on the f32 wire domain (entry points cast to
    f32 before chunking, so ``chunk_bytes`` is ``4 * elems`` exactly): the
    payload is one byte per element zero-padded to the 256-element scale
    block, plus one f32 scale per block — ``260 * ceil(elems / 256)``. The
    padding is counted because it is genuinely transferred (the kernels
    quantize whole blocks). ``bf16`` passthrough ships ``chunk_bytes``
    unchanged.
    """
    fmt = normalize_wire_format(fmt)
    if chunk_bytes <= 0:
        return 0
    if not fmt.compressed:
        return int(chunk_bytes)
    elems = -(-int(chunk_bytes) // 4)
    blocks = -(-elems // BLOCK_ELEMS)
    return blocks * _BLOCK_WIRE_BYTES



@dataclasses.dataclass(frozen=True)
class CompressedWire:
    """Executor hook: compress / decompress rows of an f32 block at the
    exchange seam (the reference's ``_wire_permute``)."""

    fmt: WireFormat

    def compress(self, block: torch.Tensor, *, rows: torch.Tensor | None = None):
        """``(payload, scales)`` of ``block`` (rows ``block[rows]`` when
        given), one launch."""
        return quantize_blocks(block, self.fmt.value, rows=rows)

    def decompress(self, values: torch.Tensor, scales: torch.Tensor, *, out_cols: int,
                   dtype: torch.dtype | None = None, out: torch.Tensor | None = None,
                   rows: torch.Tensor | None = None):
        """f32 rows of ``out_cols`` columns, written into ``out[rows]`` when
        ``out`` is given; cast to ``dtype`` when one is given, as the
        reference's (which needs it) are."""
        res = dequantize_blocks(values, scales, out_cols=out_cols, out=out, rows=rows)
        return res if dtype is None else res.to(dtype)


def roundtrip(x: torch.Tensor, fmt) -> torch.Tensor:
    """One local quantize -> dequantize hop of ``x`` (any shape), blocked
    over its flattened elements: the error-feedback model of what one wire
    hop loses. ``bf16`` is the identity."""
    fmt = normalize_wire_format(fmt)
    if not fmt.compressed or x.numel() == 0:
        return x
    flat = x.reshape(1, -1).float()
    v, s = quantize_blocks(flat, fmt.value)
    out = dequantize_blocks(v, s, out_cols=flat.shape[1])
    return out.reshape(x.shape).to(x.dtype)


class CompressionState:
    """Error-feedback residual helpers for compressed gradient sync.

    The trainer sends the compensated gradient ``c = g + e`` through the
    compressed collective and carries forward what one quantization hop
    lost, ``e' = c - roundtrip(c)``. On the emulated data axis each rank
    has its own residual: the trainer's residual leaves are rank-stacked
    ``(n, *shape)`` and :meth:`update_` works row by row in place, so ``c``
    and ``e'`` share one buffer.
    """

    @staticmethod
    def init(params, n: int | None = None):
        """f32 zeros shaped like ``params`` (with a leading rank axis of
        ``n`` when given)."""
        lead = () if n is None else (n,)
        return tree_map(lambda p: torch.zeros(lead + tuple(p.shape), dtype=torch.float32,
                                              device=p.device), params)

    @staticmethod
    def compensate(grads, residual):
        """``c = g + e`` in f32: the gradient actually synced."""
        return tree_map(lambda g, e: g.float() + e, grads, residual)

    @staticmethod
    def update(compensated, fmt):
        """``e' = c - roundtrip(c)`` (zeros for the passthrough)."""
        fmt = normalize_wire_format(fmt)
        if not fmt.compressed:
            return tree_map(torch.zeros_like, compensated)
        return tree_map(lambda c: c - roundtrip(c, fmt), compensated)

    @staticmethod
    def update_(stacked: torch.Tensor, fmt) -> torch.Tensor:
        """:meth:`update` in place on one rank-stacked leaf ``(n, *shape)``
        holding each rank's ``c``: row ``r`` becomes ``c_r - roundtrip(c_r)``."""
        fmt = normalize_wire_format(fmt)
        if not fmt.compressed:
            return stacked.zero_()
        for row in stacked:
            row.sub_(roundtrip(row, fmt))
        return stacked
