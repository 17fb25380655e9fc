"""Pure-numpy schedule replays: the value-level oracles of the executors.

:func:`simulate_collective` replays a :class:`~.schedules.Schedule` with
round-start (concurrent) semantics; :func:`simulate_lowered` replays its
host-side lowering exactly as the compiled and in-kernel executors do.
Both take per-rank buffers ``data[r]`` of shape ``(num_chunks, chunk)``
and return new ones. :func:`timed_rounds` is the round-accurate clock the
stream simulator prices buckets with. The reference's fault-injection
arguments are not ported (ROADMAP item "Fault runtime").
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .schedules import LoweredSchedule, Schedule

__all__ = ["simulate_collective", "simulate_lowered", "timed_rounds"]


def simulate_collective(schedule: Schedule, data: Sequence[np.ndarray]) -> list[np.ndarray]:
    """Replay any schedule (bcast/reduce/allreduce/allgather/reduce_scatter):
    every transfer reads the sender's buffer as it was at the start of the
    round, then overwrites the destination chunk range or, for
    ``combine=True`` transfers, accumulates into it."""
    bufs = [np.array(d, copy=True) for d in data]
    for rnd in schedule.rounds:
        staged = [(t, bufs[t.src][t.chunk_start:t.chunk_start + t.chunk_count].copy())
                  for t in rnd.transfers]
        for t, payload in staged:
            sl = slice(t.chunk_start, t.chunk_start + t.chunk_count)
            if t.combine:
                bufs[t.dst][sl] = bufs[t.dst][sl] + payload
            else:
                bufs[t.dst][sl] = payload
    return bufs


def simulate_lowered(lowered: LoweredSchedule, data: Sequence[np.ndarray]) -> list[np.ndarray]:
    """Replay a lowering: per round, lane classes apply in order; each class
    snapshots every source block (at its clipped ``send_start``) before it
    writes, and each destination takes only rows ``[lo, hi)`` of its block
    at ``recv_start`` (overwrite, or accumulate on combine rounds)."""
    bufs = [np.array(d, copy=True) for d in data]
    for s in range(lowered.num_rounds):
        for cls in lowered.classes:
            blocks = {
                dst: bufs[src][cls.send_start[s, src]:cls.send_start[s, src] + cls.block].copy()
                for src, dst in cls.perm
            }
            for _src, dst in cls.perm:
                lo, hi = int(cls.lo[s, dst]), int(cls.hi[s, dst])
                if hi <= lo:
                    continue
                r0 = int(cls.recv_start[s, dst])
                if cls.combine[s]:
                    bufs[dst][r0 + lo:r0 + hi] += blocks[dst][lo:hi]
                else:
                    bufs[dst][r0 + lo:r0 + hi] = blocks[dst][lo:hi]
    return bufs


def timed_rounds(schedule: Schedule, chunk_bytes: int, ts: float, bw: float) -> float:
    """Round-accurate time estimate: each round costs ts + (bytes of the
    largest transfer in the round)/bw; rounds serialize. Empty rounds cost
    nothing. This is the 'simulator clock' the closed forms of
    :mod:`.cost_model` approximate."""
    total = 0.0
    for rnd in schedule.rounds:
        if not rnd.transfers:
            continue
        biggest = max(t.chunk_count for t in rnd.transfers) * chunk_bytes
        total += ts + biggest / bw
    return total
