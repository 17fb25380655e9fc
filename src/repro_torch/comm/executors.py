"""Executors for the schedule IR on the emulated mesh.

Every executor replays a :class:`~repro_torch.core.schedules.Schedule` over a
rank-stacked buffer ``(n, num_chunks, chunk_elems)`` (row ``r`` is rank
``r``'s buffer) and updates it IN PLACE — the reference donates the buffer
to the same effect.

* :func:`execute_collective` — the *unrolled* (exact) executor: one
  exchange per lane per round, moving exactly the schedule's transfers.
* :func:`execute_compiled` — the *compiled* executor: replays the host-side
  lowering (``lower_schedule``: dense per-round tables + one static
  permutation per lane class). Per round and class it gathers the send
  blocks into the receivers' slots and merges them with one launch of the
  fused combine-update kernel (:mod:`repro_torch.kernels.combine_update`).
* :func:`execute_inkernel` — the whole lowered schedule in one launch of
  the device-initiated in-kernel replay
  (:mod:`repro_torch.kernels.inkernel_collective`).

An exchange between ranks is a device-memory copy between rows of the
stacked buffer: the ``lax.ppermute`` of the reference restricted to the
pairs that carry data (:mod:`repro_torch.launch.mesh`). Send
blocks are snapshotted before any destination is written, as the round
semantics require (a rank may send and receive in one lane).

``wire`` (a :class:`~repro_torch.comm.compress.CompressedWire`) compresses
every exchange, the reference's ``_wire_permute`` seam: one quantize launch
over the rows the lane (or the class's round) sends, wherever they lie in
the f32 buffer; payload and scales cross as row copies; one dequantize
launch writes the receivers' rows; then the merge runs in f32 as without
compression. Only the rows a receiver merges are sent: rows are
quantized independently, so the values are the reference's, which also
quantizes the masked rows of each block.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.schedules import LoweredSchedule, Schedule, lower_schedule
from ..kernels.combine_update import fused_combine_update
from ..kernels.inkernel_collective import inkernel_replay

__all__ = ["execute_collective", "execute_compiled", "execute_inkernel"]


def _check(buf: torch.Tensor, n: int, num_chunks: int) -> None:
    if buf.dim() != 3 or buf.shape[0] != n or buf.shape[1] != num_chunks:
        raise ValueError(f"buffer {tuple(buf.shape)} does not fit a schedule over "
                         f"n={n} ranks and {num_chunks} chunks")


def _check_wire(buf: torch.Tensor, wire) -> None:
    if wire is not None and buf.dtype != torch.float32:
        raise TypeError(f"a compressed wire runs on the f32 wire domain, not {buf.dtype}")


def _index(rows: list[int], device) -> torch.Tensor:
    return torch.tensor(rows, dtype=torch.int64, device=device)


def _wire_rows(wire, flat: torch.Tensor, send: torch.Tensor):
    """Quantize ``flat[send]`` in one launch and ship payload and scales:
    the copies are the bytes that cross the wire."""
    values, scales = wire.compress(flat, rows=send)
    return values.clone(), scales.clone()


def _execute_lane(transfers, buf: torch.Tensor, wire=None) -> None:
    count = transfers[0].chunk_count
    if wire is not None:
        n, K, C = buf.shape
        send = _index([t.src * K + t.chunk_start + i for t in transfers for i in range(count)],
                      buf.device)
        values, scales = _wire_rows(wire, buf.view(n * K, C), send)
        received = wire.decompress(values, scales, out_cols=C)
        for j, t in enumerate(transfers):
            cur = buf[t.dst, t.chunk_start:t.chunk_start + count]
            block = received[j * count:(j + 1) * count]
            if t.combine:
                cur.add_(block)
            else:
                cur.copy_(block)
        return
    dsts = {t.dst for t in transfers}
    sent = []
    for t in transfers:
        block = buf[t.src, t.chunk_start:t.chunk_start + count]
        # a source row that is also written in this lane must be read first
        sent.append((t, block.clone() if t.src in dsts else block))
    for t, block in sent:
        cur = buf[t.dst, t.chunk_start:t.chunk_start + count]
        if t.combine:
            cur.add_(block)
        else:
            cur.copy_(block)


def execute_collective(schedule: Schedule, buf: torch.Tensor, *, wire=None) -> torch.Tensor:
    """Replay any schedule over ``buf`` round by round, lane by lane (the
    lane partition comes from the cached host-side lowering)."""
    _check(buf, schedule.n, schedule.num_chunks)
    _check_wire(buf, wire)
    for lanes in lower_schedule(schedule).round_lanes:
        for lane in lanes:
            _execute_lane(lane, buf, wire)
    return buf


def _wire_tables(cls, K: int, device):
    """Per round, the flat rows a compressed class sends and the receive-
    slot rows they land in: rows ``[lo, hi)`` of each active pair's block.
    One device tensor each for all rounds, sliced per round."""
    send, recv, bounds = [], [], []
    for s in range(cls.send_start.shape[0]):
        a = len(send)
        for src, dst in cls.perm:
            lo, hi = int(cls.lo[s, dst]), int(cls.hi[s, dst])
            base = src * K + int(cls.send_start[s, src])
            send.extend(base + i for i in range(lo, hi))
            recv.extend(dst * cls.block + i for i in range(lo, hi))
        bounds.append((a, len(send)))
    return _index(send, device), _index(recv, device), bounds


def execute_compiled(schedule: Schedule | LoweredSchedule,
                     buf: torch.Tensor, *, wire=None) -> torch.Tensor:
    """Compiled replay: a loop over the lowered rounds; per lane class one
    gather of the send blocks and one fused combine-update launch.

    Inactive (fill/drain) pairs of a class carry nothing: their destination
    window is empty (``lo == hi``), so the kernel keeps those rows and their
    receive slot is never read. With ``wire``, the gather is one quantize
    launch over the rows merged this round, their copies, and one
    dequantize launch into the receive slots."""
    lowered = (
        schedule if isinstance(schedule, LoweredSchedule) else lower_schedule(schedule)
    )
    _check(buf, lowered.n, lowered.num_chunks)
    _check_wire(buf, wire)
    if lowered.num_rounds == 0:
        return buf
    n, K, C = buf.shape
    flat = buf.view(n * K, C)
    classes = []
    for cls in lowered.classes:
        # [recv_start, lo, hi] per round and rank, on the buffer's device once
        tab = torch.from_numpy(np.stack([cls.recv_start, cls.lo, cls.hi], axis=1))
        recv = torch.empty((n, cls.block, C), dtype=buf.dtype, device=buf.device)
        rows = None if wire is None else _wire_tables(cls, K, buf.device)
        classes.append((cls, tab.to(buf.device), recv, rows))
    for s in range(lowered.num_rounds):
        for cls, tab, recv, rows in classes:
            if rows is not None:
                send, land, bounds = rows
                a, b = bounds[s]
                if b > a:
                    values, scales = _wire_rows(wire, flat, send[a:b])
                    wire.decompress(values, scales, out_cols=C,
                                    out=recv.view(n * cls.block, C), rows=land[a:b])
            else:
                for src, dst in cls.perm:
                    if cls.hi[s, dst] > cls.lo[s, dst]:
                        a = int(cls.send_start[s, src])
                        recv[dst].copy_(buf[src, a:a + cls.block])
            fused_combine_update(buf, recv, tab[s, 0], tab[s, 1], tab[s, 2],
                                 int(cls.combine[s]))
    return buf


def execute_inkernel(schedule: Schedule | LoweredSchedule,
                     buf: torch.Tensor) -> torch.Tensor:
    """In-kernel replay: ONE launch of
    :func:`~repro_torch.kernels.inkernel_collective.inkernel_replay` for the
    whole lowered schedule, on the rank-stacked buffer in place: the
    device-initiated kernel, in which each rank's group of blocks puts into
    its partners' landing slots and synchronizes with them through flags
    (the reference's ``_rdma_replay``). A CPU tensor takes its plain
    version. Bit-identical to :func:`execute_compiled` and
    :func:`execute_collective`. Takes no ``wire``:
    ``comm.api._resolve_exec_path`` keeps compressed plans off this path."""
    lowered = (
        schedule if isinstance(schedule, LoweredSchedule) else lower_schedule(schedule)
    )
    _check(buf, lowered.n, lowered.num_chunks)
    if lowered.num_rounds == 0:
        return buf
    return inkernel_replay(lowered, buf)
