"""In-kernel schedule replay (CUDA), with its plain PyTorch versions.

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

:func:`inkernel_replay`, what the executors call, takes the
device-initiated replay instead (:func:`rdma_replay`, the reference's
``_rdma_replay``, ``:246``): one group of thread blocks per rank, which
reaches the other ranks only through a per-rank pointer table (their
landing slots and flag words) and synchronizes with its partners through
point-to-point flags, never through a grid-wide barrier. The kernel and its
design note are in ``csrc/inkernel_rdma.cu``; the flag values every wait
needs are computed here (:func:`rdma_wait_targets`).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..core.schedules import KernelTables, LoweredSchedule, pack_tables
from . import _build

__all__ = ["inkernel_replay", "inkernel_replay_shared", "inkernel_replay_shared_plain",
           "neighbor_tables", "rdma_replay", "rdma_replay_plain", "rdma_wait_targets",
           "round_modes", "replay_bytes"]

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


# ---------------------------------------------------------------------------
# device-initiated replay: rank groups, landing slots, point-to-point flags
# ---------------------------------------------------------------------------

# the largest rank count the kernel's pointer table holds
MAX_RANKS = 64

# fields of one (round, class, rank) entry of the kernel's table
# (``csrc/inkernel_rdma.cu``): the partner this rank puts to and the one it
# receives from (-1: none this class-round), the put's rows [lo, hi) of the
# block, its send_start, the merge's rows [lo, hi), its recv_start, the
# three wait targets of :func:`rdma_wait_targets`, the combine flag
RDMA_FIELDS = 12


def neighbor_tables(tables: KernelTables) -> tuple[np.ndarray, np.ndarray]:
    """Per-class partner maps: ``dst_of[c, r]`` is where rank r sends this
    class (r itself when inactive), ``src_of[c, r]`` who sends to it. A copy
    of the reference's ``_neighbor_tables`` (``:162``)."""
    C, n = tables.num_classes, tables.n
    dst_of = np.tile(np.arange(n, dtype=np.int32), (C, 1))
    src_of = dst_of.copy()
    for c, perm in enumerate(tables.perms):
        for src, dst in perm:
            dst_of[c, src] = dst
            src_of[c, dst] = src
    return dst_of, src_of


@functools.lru_cache(maxsize=256)
def _active_partners(tables: KernelTables) -> tuple[np.ndarray, np.ndarray]:
    """int32 ``(C, T, n)`` each: the rank's put partner and receive partner
    in every class-round where the pair moves rows (``hi > lo``), else -1.
    The reference's partners (:func:`neighbor_tables`) restricted to the
    pairs that carry data: a pair with an empty window signals nothing."""
    C, T, n = tables.num_classes, tables.num_rounds, tables.n
    dst_of, src_of = neighbor_tables(tables)
    to = np.full((C, T, n), -1, np.int32)
    frm = np.full((C, T, n), -1, np.int32)
    for c in range(C):
        for s in range(T):
            for r in range(n):
                d = int(dst_of[c, r])
                if d != r and tables.hi[c, s, d] > tables.lo[c, s, d]:
                    to[c, s, r] = d
                q = int(src_of[c, r])
                if q != r and tables.hi[c, s, r] > tables.lo[c, s, r]:
                    frm[c, s, r] = q
    return to, frm


@functools.lru_cache(maxsize=256)
def rdma_wait_targets(tables: KernelTables) -> np.ndarray:
    """int32 ``(C, T, n, 3)``: the flag values rank ``r`` waits for in
    class-round ``(c, s)``: its barrier word from its put partner, its
    barrier word from its receive partner, its receive word from its
    receive partner (0 where it has no such partner).

    Every rank keeps one barrier word and one receive word per sender, and
    each counts that sender's signals since the launch. In a class-round
    where a pair moves rows, the source signals the destination's barrier
    word and the destination the source's (the reference's neighbour
    barrier, ``:215``), then the source puts and signals the destination's
    receive word. A target is the count of the sender's signals through
    this class-round, walked in the kernel's order (rounds, then classes):
    a sender's signals to one word come in its program order, so the word
    reaches the target exactly when the sender has signalled this
    class-round. One word per rank for all senders, as the reference's
    barrier semaphore, would let a partner that runs ahead stand in for
    one that has not arrived."""
    C, T, n = tables.num_classes, tables.num_rounds, tables.n
    to, frm = _active_partners(tables)
    bar = np.zeros((n, n), np.int64)   # bar[receiver, sender]
    recv = np.zeros((n, n), np.int64)
    out = np.zeros((C, T, n, 3), np.int32)
    for s in range(T):
        for c in range(C):
            for r in range(n):
                if to[c, s, r] >= 0:
                    bar[to[c, s, r], r] += 1
                    recv[to[c, s, r], r] += 1
                if frm[c, s, r] >= 0:
                    bar[frm[c, s, r], r] += 1
            for r in range(n):
                d, q = to[c, s, r], frm[c, s, r]
                if d >= 0:
                    out[c, s, r, 0] = bar[r, d]
                if q >= 0:
                    out[c, s, r, 1] = bar[r, q]
                    out[c, s, r, 2] = recv[r, q]
    return out


def _land_rows(tables: KernelTables) -> int:
    """Rows of one rank's landing slot: the largest block of a class that
    moves rows. One slot per rank serves every class, because a source puts
    only after its destination has signalled that this class-round's
    barrier was reached, which it does only after its last merge."""
    to, _frm = _active_partners(tables)
    used = [tables.blocks[c] for c in range(tables.num_classes) if (to[c] >= 0).any()]
    return max(used, default=0)


def rdma_replay_plain(lowered: LoweredSchedule, buf: torch.Tensor) -> torch.Tensor:
    """The reference's ``_rdma_kernel`` control flow in PyTorch on the
    rank-stacked ``(n, K, cols)`` buffer: per round and class, every source
    first puts rows ``[lo, hi)`` of its send window into its destination's
    landing slot, then every destination merges its slot into its window
    (overwrite, or accumulate on combine rounds; bf16 summed in f32 and
    rounded once). Returns ``buf``, updated in place."""
    tables = pack_tables(lowered)
    n, _K, cols = buf.shape
    land = buf.new_empty((n, _land_rows(tables), cols))
    for s in range(tables.num_rounds):
        for c in range(tables.num_classes):
            win = _windows(tables, c, s)
            for src, dst, lo, hi in win:
                a = int(tables.send_start[c, s, src])
                land[dst, lo:hi] = buf[src, a + lo:a + hi]
            for _src, dst, lo, hi in win:
                r0 = int(tables.recv_start[c, s, dst])
                cur = buf[dst, r0 + lo:r0 + hi]
                if tables.combine[c, s]:
                    cur.add_(land[dst, lo:hi])
                else:
                    cur.copy_(land[dst, lo:hi])
    return buf


@functools.lru_cache(maxsize=256)
def rdma_table(tables: KernelTables) -> np.ndarray:
    """The kernel's int32 table ``(T, C, n, RDMA_FIELDS)``, one entry per
    round, class and rank (fields at :data:`RDMA_FIELDS`)."""
    C, T, n = tables.num_classes, tables.num_rounds, tables.n
    to, frm = _active_partners(tables)
    waits = rdma_wait_targets(tables)
    out = np.zeros((T, C, n, RDMA_FIELDS), np.int32)
    for c in range(C):
        for s in range(T):
            for r in range(n):
                d = int(to[c, s, r])
                e = out[s, c, r]
                e[0], e[1] = d, frm[c, s, r]
                if d >= 0:
                    e[2], e[3] = tables.lo[c, s, d], tables.hi[c, s, d]
                e[4] = tables.send_start[c, s, r]
                e[5], e[6] = tables.lo[c, s, r], tables.hi[c, s, r]
                e[7] = tables.recv_start[c, s, r]
                e[8:11] = waits[c, s, r]
                e[11] = tables.combine[c, s]
    return out


@functools.lru_cache(maxsize=256)
def _rdma_device_tables(tables: KernelTables, device: torch.device) -> torch.Tensor:
    """:func:`rdma_table` on ``device``, uploaded once per lowering."""
    return torch.from_numpy(np.ascontiguousarray(rdma_table(tables))).to(device)


def _flag_words(n: int) -> int:
    """int32 flag words of one rank: its blocks' arrival counter, a barrier
    word and a receive word per sender, padded to 128 bytes."""
    return -(-(1 + 2 * n) // 32) * 32


def rdma_launch(buf: torch.Tensor, tables: KernelTables, dev_tab: torch.Tensor) -> None:
    """Launch the kernel of ``csrc/inkernel_rdma.cu`` on ``buf`` with the
    table ``dev_tab`` (:func:`rdma_table` on the device); counts nothing."""
    n, K, cols = buf.shape
    rows = _land_rows(tables)
    land = torch.empty((n, rows, cols), dtype=buf.dtype, device=buf.device)
    words = _flag_words(n)
    flags = torch.empty((n, words), dtype=torch.int32, device=buf.device)
    es = buf.element_size()
    # the pointer table: each rank's buffer row, landing slot and flag words
    ptrs = ([buf.data_ptr() + r * K * cols * es for r in range(n)]
            + [land.data_ptr() + r * rows * cols * es for r in range(n)]
            + [flags.data_ptr() + r * words * 4 for r in range(n)])
    fn = _build.load("inkernel_rdma").repro_inkernel_rdma
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    status = fn((ctypes.c_uint64 * (3 * n))(*ptrs), dev_tab.data_ptr(), tables.num_classes,
                tables.num_rounds, n, cols, flags.data_ptr(), n * words, _DTYPES[buf.dtype],
                stream)
    _build.check(status, "inkernel_rdma")


def rdma_replay(lowered: LoweredSchedule, buf: torch.Tensor) -> torch.Tensor:
    """Replay every round of ``lowered`` on the rank-stacked ``buf``
    ``(n, num_chunks, cols)`` in one launch of the device-initiated kernel,
    in place. Returns ``buf``.

    A wait that is never met traps the kernel after 10 s. The launch has
    already returned success by then, so ``_build.check`` cannot see the
    trap: it comes up as a generic CUDA error ("unspecified launch
    failure") at the caller's next synchronizing call, and leaves the CUDA
    context unusable."""
    if buf.dtype not in _DTYPES:
        raise TypeError(f"rdma_replay takes float32 or bfloat16, not {buf.dtype}")
    if buf.dim() != 3 or buf.shape[0] != lowered.n or buf.shape[1] != lowered.num_chunks:
        raise ValueError(f"buffer {tuple(buf.shape)} does not fit a lowering over "
                         f"n={lowered.n} ranks and {lowered.num_chunks} chunks")
    tables = pack_tables(lowered)
    if tables.num_rounds == 0 or tables.num_classes == 0 or buf.shape[2] == 0:
        return buf
    if buf.device.type == "cpu":
        return rdma_replay_plain(lowered, buf)
    if buf.device.type != "cuda" or not buf.is_contiguous():
        raise ValueError("rdma_replay needs a cpu tensor or a contiguous cuda tensor, "
                         f"not {buf.device} (contiguous={buf.is_contiguous()})")
    if lowered.n > MAX_RANKS:
        raise ValueError(f"rdma_replay holds at most {MAX_RANKS} ranks, not {lowered.n}")
    rdma_launch(buf, tables, _rdma_device_tables(tables, buf.device))
    rdma_replay.launches += 1
    return buf


rdma_replay.launches = 0


def inkernel_replay(lowered: LoweredSchedule, buf: torch.Tensor) -> torch.Tensor:
    """The executors' in-kernel replay: the device-initiated
    :func:`rdma_replay`, as the reference's ``inkernel_replay`` (``:285``)
    takes ``_rdma_replay`` on its accelerator (``:294-295``)."""
    return rdma_replay(lowered, buf)
