"""In-kernel schedule replay (CUDA), with its plain PyTorch version.

One launch replays a whole lowered schedule over the rank-stacked
``(n, num_chunks, cols)`` buffer, in place: per round, lane classes in
order; per class, every receiver's incoming rows are read from the class's
snapshot and merged into its window with the where-chain of
:mod:`.combine_update` (overwrite, or accumulate on combine rounds; rows
outside ``[lo, hi)`` are never written). Replaces the reference's Pallas
``inkernel_replay_shared`` (``src/repro/kernels/inkernel_collective.py:136``,
kernel body ``_shared_kernel`` ``:101``). The emulated mesh's stacked buffer
is the reference's shared buffer, so no gather precedes the replay. The
kernel and its design note are in ``csrc/inkernel_collective.cu``.

The schedule's tables go to the device as they are (:class:`KernelTables`
plus a per-class-round mode), once per lowering and device. The mode says
whether a class-round moves anything and whether it must stage: when a
row that the class-round reads is also a row it writes (two ranks swapping
a chunk), the incoming rows land in a scratch first, so every read sees
the snapshot. A CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises. bf16 and float32 only.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..core.schedules import KernelTables, LoweredSchedule, pack_tables
from . import _build

__all__ = ["inkernel_replay_shared", "inkernel_replay_shared_plain", "round_modes",
           "replay_bytes"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# per class-round mode
SKIP, DIRECT, STAGED = 0, 1, 2


def _windows(tables: KernelTables, c: int, s: int):
    """``(src, dst, lo, hi)`` of every pair of class ``c`` that moves rows in
    round ``s``."""
    out = []
    for src, dst in tables.perms[c]:
        lo, hi = int(tables.lo[c, s, dst]), int(tables.hi[c, s, dst])
        if hi > lo:
            out.append((src, dst, lo, hi))
    return out


@functools.lru_cache(maxsize=256)
def round_modes(tables: KernelTables) -> np.ndarray:
    """int32 ``(num_classes, num_rounds)``: SKIP where the class-round moves
    no row, STAGED where a row it reads is a row it writes (flat row
    indices of the stacked buffer), else DIRECT."""
    C, T, K = tables.num_classes, tables.num_rounds, tables.num_chunks
    modes = np.zeros((C, T), np.int32)
    for c in range(C):
        if tables.blocks[c] == 0:
            continue
        for s in range(T):
            win = _windows(tables, c, s)
            if not win:
                continue
            reads = np.concatenate([
                src * K + tables.send_start[c, s, src] + np.arange(lo, hi)
                for src, _dst, lo, hi in win])
            writes = np.concatenate([
                dst * K + tables.recv_start[c, s, dst] + np.arange(lo, hi)
                for _src, dst, lo, hi in win])
            modes[c, s] = STAGED if np.intersect1d(reads, writes).size else DIRECT
    return modes


def replay_bytes(tables: KernelTables, cols: int, element_size: int) -> int:
    """Bytes one replay must move: over every row a class-round merges, the
    source row read, the destination read on combine rounds, the
    destination written."""
    total = 0
    for c in range(tables.num_classes):
        for s in range(tables.num_rounds):
            rows = sum(hi - lo for _src, _dst, lo, hi in _windows(tables, c, s))
            total += rows * (3 if tables.combine[c, s] else 2)
    return total * cols * element_size


def inkernel_replay_shared_plain(lowered: LoweredSchedule, buf: torch.Tensor) -> torch.Tensor:
    """The reference's control flow in PyTorch: per round and class, read
    every pair's source window into a snapshot, then merge each into its
    destination window. Returns ``buf``, updated in place."""
    tables = pack_tables(lowered)
    for s in range(tables.num_rounds):
        for c in range(tables.num_classes):
            win = _windows(tables, c, s)
            snap = [buf[src, tables.send_start[c, s, src] + lo:
                        tables.send_start[c, s, src] + hi].clone()
                    for src, _dst, lo, hi in win]
            for (_src, dst, lo, hi), rows in zip(win, snap):
                r0 = int(tables.recv_start[c, s, dst])
                cur = buf[dst, r0 + lo:r0 + hi]
                if tables.combine[c, s]:
                    cur.add_(rows)
                else:
                    cur.copy_(rows)
    return buf


@functools.lru_cache(maxsize=256)
def _device_tables(tables: KernelTables, device: torch.device):
    """The kernel's int32 table block on ``device``, uploaded once per
    lowering, and the landing scratch's rows per rank (0 when no
    class-round stages). Layout (``csrc/inkernel_collective.cu``): npairs
    (C), pairs (C, n, 2), blocks (C), send_start, recv_start, lo, hi
    (C, T, n), combine (C, T), mode (C, T)."""
    C, n = tables.num_classes, tables.n
    pairs = np.zeros((C, n, 2), np.int32)
    npairs = np.zeros(C, np.int32)
    for c, perm in enumerate(tables.perms):
        npairs[c] = len(perm)
        for p, (src, dst) in enumerate(perm):
            pairs[c, p] = (src, dst)
    modes = round_modes(tables)
    block = np.asarray(tables.blocks, np.int32)
    flat = np.concatenate([
        npairs, pairs.ravel(), block, tables.send_start.ravel(), tables.recv_start.ravel(),
        tables.lo.ravel(), tables.hi.ravel(), tables.combine.ravel(), modes.ravel(),
    ]).astype(np.int32)
    staged = (modes == STAGED).any(axis=1)
    land_rows = int(block[staged].max()) if staged.any() else 0
    return torch.from_numpy(flat).to(device), land_rows


def _launch(buf: torch.Tensor, tables: KernelTables) -> None:
    dev_tab, land_rows = _device_tables(tables, buf.device)
    n, K, cols = buf.shape
    land = (torch.empty((n * land_rows, cols), dtype=buf.dtype, device=buf.device)
            if land_rows else None)
    fn = _build.load("inkernel_collective").repro_inkernel_replay
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    status = fn(buf.data_ptr(), None if land is None else land.data_ptr(), dev_tab.data_ptr(),
                tables.num_classes, tables.num_rounds, n, K, cols, land_rows,
                _DTYPES[buf.dtype], stream)
    _build.check(status, "inkernel_replay_shared")


def inkernel_replay_shared(lowered: LoweredSchedule, buf: torch.Tensor) -> torch.Tensor:
    """Replay every round of ``lowered`` on the rank-stacked ``buf``
    ``(n, num_chunks, cols)`` in one kernel launch, in place (row ``r`` is
    rank ``r``'s buffer). Returns ``buf``."""
    if buf.dtype not in _DTYPES:
        raise TypeError(f"inkernel_replay_shared takes float32 or bfloat16, not {buf.dtype}")
    if buf.dim() != 3 or buf.shape[0] != lowered.n or buf.shape[1] != lowered.num_chunks:
        raise ValueError(f"buffer {tuple(buf.shape)} does not fit a lowering over "
                         f"n={lowered.n} ranks and {lowered.num_chunks} chunks")
    tables = pack_tables(lowered)
    if tables.num_rounds == 0 or tables.num_classes == 0 or buf.shape[2] == 0:
        return buf
    if buf.device.type == "cpu":
        return inkernel_replay_shared_plain(lowered, buf)
    if buf.device.type != "cuda" or not buf.is_contiguous():
        raise ValueError("inkernel_replay_shared needs a cpu tensor or a contiguous cuda "
                         f"tensor, not {buf.device} (contiguous={buf.is_contiguous()})")
    _launch(buf, tables)
    inkernel_replay_shared.launches += 1
    return buf


inkernel_replay_shared.launches = 0
