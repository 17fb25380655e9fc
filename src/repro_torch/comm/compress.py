"""Wire formats for collectives: the accounting half of the reference's
``comm/compress.py``.

A :class:`WireFormat` is the per-plan choice of what bytes cross the link
for each chunk transfer: ``bf16`` is the bit-identical passthrough (any
dtype passes through), ``int8``/``fp8`` are per-256-element-block
quantized payloads plus one f32 scale per block. The port plans and
accounts for all three; executing a compressed format needs the quantize
kernels, which are not ported yet, so the executors raise on it.
"""
from __future__ import annotations

import enum

__all__ = ["WireFormat", "normalize_wire_format", "wire_chunk_bytes", "BLOCK_ELEMS"]

# elements per quantization scale block (the reference's
# ``kernels/quantize.py`` BLOCK_ELEMS)
BLOCK_ELEMS = 256

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

