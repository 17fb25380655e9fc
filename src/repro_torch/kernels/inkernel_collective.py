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
windows, landing slots and flag words) and synchronizes with its partners
through point-to-point flags, never through a grid-wide barrier. On a
DIRECT class-round the source writes straight into the destination's
window; only STAGED ones go through a landing slot. The kernel and its
design note are in ``csrc/inkernel_rdma.cu``; the flag values every wait
needs (:func:`rdma_wait_targets`) and the size of each rank's group
(:func:`rdma_groups`) are computed here.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..core.schedules import KernelTables, LoweredSchedule, pack_tables
from . import _build

__all__ = ["inkernel_replay", "inkernel_replay_shared",
           "inkernel_replay_shared_plain", "neighbor_tables", "rdma_groups", "rdma_replay",
           "rdma_replay_plain", "rdma_wait_targets", "round_modes", "replay_bytes"]

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
    return torch.from_numpy(flat).to(device), _land_rows(tables)


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
# device-initiated replay: rank groups, direct puts, point-to-point flags
# ---------------------------------------------------------------------------

# the largest rank count the kernel's pointer table holds
MAX_RANKS = 64

# fields of one (round, class, rank) entry of the kernel's table
# (``csrc/inkernel_rdma.cu``): the partner this rank puts to and the one it
# receives from (-1: none this class-round), the put's rows [lo, hi) of the
# block, its send_start, the merge's rows [lo, hi), its recv_start, the
# three wait targets of :func:`rdma_wait_targets`, the combine flag, the
# class-round's mode (:func:`round_modes`)
RDMA_FIELDS = 13


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
    """Rows of one rank's landing slot: the largest block of a class with a
    STAGED class-round, 0 when none stages (DIRECT puts write straight into
    the destination's window). One slot per rank serves every class,
    because a source puts only after its destination has signalled that
    this class-round's barrier was reached, which it does only after its
    last merge."""
    staged = (round_modes(tables) == STAGED).any(axis=1)
    return max((int(tables.blocks[c]) for c in np.flatnonzero(staged)), default=0)


def _rank_units(tables: KernelTables) -> np.ndarray:
    """int64 ``(n,)``: the row units each rank's group moves, as
    :func:`replay_bytes` counts them (a row 2, a combine row 3). A DIRECT
    row counts for its source; on STAGED class-rounds the put (slot write
    and source read, 2) counts for the source and the merge for the
    destination."""
    modes = round_modes(tables)
    units = np.zeros(tables.n, np.int64)
    for c in range(tables.num_classes):
        for s in range(tables.num_rounds):
            u = 3 if tables.combine[c, s] else 2
            for src, dst, lo, hi in _windows(tables, c, s):
                if modes[c, s] == STAGED:
                    units[src] += 2 * (hi - lo)
                    units[dst] += u * (hi - lo)
                else:
                    units[src] += u * (hi - lo)
    return units


def _direct_shifts(tables: KernelTables, cols: int, element_size: int) -> set[int]:
    """Source-minus-destination start offsets, in elements mod 16 bytes, of
    the spans the kernel's DIRECT class-rounds put on a ``(n, K, cols)``
    buffer whose base is 16-byte aligned: the shifts its funnelled
    16-byte stores must handle (0 when both ends are aligned alike)."""
    K, modes, out = tables.num_chunks, round_modes(tables), set()
    for c in range(tables.num_classes):
        for s in range(tables.num_rounds):
            if modes[c, s] == DIRECT:
                for src, dst, lo, _hi in _windows(tables, c, s):
                    a = src * K + int(tables.send_start[c, s, src]) + lo
                    b = dst * K + int(tables.recv_start[c, s, dst]) + lo
                    out.add((a - b) * cols * element_size % 16 // element_size)
    return out


@functools.lru_cache(maxsize=256)
def rdma_groups(tables: KernelTables, resident: int) -> tuple[int, ...]:
    """Blocks in each rank's group of the kernel's cooperative grid, from
    the ``resident`` blocks the card holds at once: one block each (every
    rank signals and waits, even one that moves nothing), the rest shared
    in proportion to the units each moves (:func:`_rank_units`), the
    remainders of the shares going to the largest fractions, lowest rank
    first on ties. Raises when the card holds fewer than ``n`` blocks."""
    n = tables.n
    if resident < n:
        raise RuntimeError(f"inkernel_rdma needs a block per rank: the card holds "
                           f"{resident} blocks at once, the plan has {n} ranks")
    units = _rank_units(tables)
    spare = resident - n
    if units.sum() == 0:
        units = np.ones(n, np.int64)
    share = spare * units / units.sum()
    sizes = 1 + np.floor(share).astype(np.int64)
    left = resident - int(sizes.sum())
    order = np.argsort(-(share - np.floor(share)), kind="stable")
    sizes[order[:left]] += 1
    return tuple(int(b) for b in sizes)


def rdma_replay_plain(lowered: LoweredSchedule, buf: torch.Tensor) -> torch.Tensor:
    """The reference's ``_rdma_kernel`` control flow in PyTorch on the
    rank-stacked ``(n, K, cols)`` buffer: per round and class, every source
    first puts rows ``[lo, hi)`` of its send window into its destination's
    landing slot, then every destination merges its slot into its window
    (overwrite, or accumulate on combine rounds; bf16 summed in f32 and
    rounded once). Returns ``buf``, updated in place."""
    tables = pack_tables(lowered)
    n, _K, cols = buf.shape
    land = buf.new_empty((n, max(tables.blocks), cols))
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
    modes = round_modes(tables)
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
                e[12] = modes[c, s]
    return out


@functools.lru_cache(maxsize=256)
def _rdma_device_tables(tables: KernelTables, device: torch.device) -> torch.Tensor:
    """:func:`rdma_table` on ``device``, uploaded once per lowering."""
    return torch.from_numpy(np.ascontiguousarray(rdma_table(tables))).to(device)


def _flag_words(n: int) -> int:
    """int32 flag words of one rank: its blocks' arrival counter, a barrier
    word and a receive word per sender, padded to 128 bytes."""
    return -(-(1 + 2 * n) // 32) * 32


def _resident(dtype: torch.dtype) -> int:
    """Blocks the card holds resident at once for the kernel's ``dtype``
    instantiation (the occupancy query)."""
    fn = _build.load("inkernel_rdma").repro_inkernel_rdma_resident
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    _build.check(fn(_DTYPES[dtype], ctypes.byref(blocks)), "inkernel_rdma occupancy query")
    return blocks.value


def rdma_launch(buf: torch.Tensor, tables: KernelTables, dev_tab: torch.Tensor,
                groups: tuple[int, ...] | None = None) -> None:
    """Launch the kernel of ``csrc/inkernel_rdma.cu`` on ``buf`` with the
    table ``dev_tab`` (:func:`rdma_table` on the device) and ``groups``
    blocks per rank (default :func:`rdma_groups`); counts nothing."""
    n, K, cols = buf.shape
    rows = _land_rows(tables)
    land = (torch.empty((n, rows, cols), dtype=buf.dtype, device=buf.device)
            if rows else None)
    words = _flag_words(n)
    flags = torch.empty((n, words), dtype=torch.int32, device=buf.device)
    es = buf.element_size()
    # the pointer table: each rank's buffer row, landing slot (null when no
    # class-round stages) and flag words; each group's first block
    ptrs = ([buf.data_ptr() + r * K * cols * es for r in range(n)]
            + [0 if land is None else land.data_ptr() + r * rows * cols * es
               for r in range(n)]
            + [flags.data_ptr() + r * words * 4 for r in range(n)])
    if groups is None:
        groups = rdma_groups(tables, _resident(buf.dtype))
    starts = [0, *np.cumsum(groups).tolist()]
    fn = _build.load("inkernel_rdma").repro_inkernel_rdma
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    status = fn((ctypes.c_uint64 * (3 * n))(*ptrs), (ctypes.c_int * (n + 1))(*starts),
                dev_tab.data_ptr(), tables.num_classes, tables.num_rounds, n, cols,
                flags.data_ptr(), n * words, _DTYPES[buf.dtype], stream)
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
