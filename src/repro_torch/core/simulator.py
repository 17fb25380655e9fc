"""Pure-numpy schedule replays: the value-level oracles of the executors.

:func:`simulate_bcast` and :func:`simulate_reduce` run a broadcast and a
reduce-to-root schedule under the causality rule the fabric enforces (a
rank sends only chunks it owns at the start of the round; a reduce
partial is consumed once), raising :class:`CausalityError` when a
schedule breaks it; :func:`check_complete` asserts that a broadcast
leaves every rank owning every chunk.

:func:`simulate_collective` replays a :class:`~.schedules.Schedule` with
round-start (concurrent) semantics; :func:`simulate_lowered` replays its
host-side lowering exactly as the compiled and in-kernel executors do.
Both take per-rank buffers ``data[r]`` of shape ``(num_chunks, chunk)``
and return new ones. :func:`timed_rounds` is the round-accurate clock the
stream simulator prices buckets with.

Each takes ``faults``, a :class:`~repro_torch.comm.faults.FaultSpec` read by
duck-typing (the spec raises its own typed errors): dead ranks raise
``DeadRankError`` before any round runs, transient drops are retransmits of
the round-start payload (the values stay bit-identical unless a streak
exceeds the budget, ``TransientDropError``), and slow links and stalls
stretch only :func:`timed_rounds`' clock.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .schedules import LoweredSchedule, Schedule

__all__ = ["CausalityError", "simulate_bcast", "simulate_reduce", "check_complete",
           "simulate_collective", "simulate_lowered", "timed_rounds"]


class CausalityError(AssertionError):
    """A schedule sends a chunk its sender does not own yet (or a reduce
    partial that was already merged)."""


def simulate_bcast(schedule: Schedule, data: Sequence[np.ndarray]) -> list[np.ndarray]:
    """Run a bcast schedule over per-rank buffers ``data[r]`` of shape
    ``(num_chunks, chunk)``; returns the final buffers. The root owns every
    chunk at the start; a transfer's chunks are owned by its destination
    after the round (all transfers of a round are concurrent)."""
    n, root = schedule.n, schedule.root
    bufs = [np.array(d, copy=True) for d in data]
    owned = [set() for _ in range(n)]
    owned[root] = set(range(schedule.num_chunks))
    for ridx, rnd in enumerate(schedule.rounds):
        pre = [set(o) for o in owned]
        staged = []
        for t in rnd.transfers:
            for c in t.chunks():
                if c not in pre[t.src]:
                    raise CausalityError(
                        f"{schedule.name}: round {ridx}: rank {t.src} sends chunk {c} "
                        f"before owning it ({t})")
            staged.append((t, bufs[t.src][t.chunk_start:t.chunk_start + t.chunk_count].copy()))
        for t, payload in staged:
            bufs[t.dst][t.chunk_start:t.chunk_start + t.chunk_count] = payload
            owned[t.dst].update(t.chunks())
    return bufs


def simulate_reduce(schedule: Schedule, data: Sequence[np.ndarray]) -> list[np.ndarray]:
    """Run a reduce-to-root schedule (sum combiner): a transfer adds the
    sender's whole current partial into the receiver, and a rank whose
    partial was sent may not send again. The root ends with ``sum(data)``."""
    if schedule.kind != "reduce":
        raise ValueError("schedule is not a reduce schedule")
    bufs = [np.array(d, copy=True) for d in data]
    alive = [True] * schedule.n
    for ridx, rnd in enumerate(schedule.rounds):
        staged = []
        for t in rnd.transfers:
            if not alive[t.src]:
                raise CausalityError(
                    f"{schedule.name}: round {ridx}: rank {t.src} already merged ({t})")
            staged.append((t, bufs[t.src].copy()))
        for t, payload in staged:
            bufs[t.dst] = bufs[t.dst] + payload
            alive[t.src] = False
    return bufs


def check_complete(schedule: Schedule) -> None:
    """Raise ``AssertionError`` unless every rank owns every chunk after the
    bcast ``schedule`` (the root's chunk ids, replayed by
    :func:`simulate_bcast`)."""
    n, K = schedule.n, schedule.num_chunks
    data = [np.full((K, 1), -1.0) for _ in range(n)]
    data[schedule.root] = np.arange(K, dtype=np.float64).reshape(K, 1)
    out = simulate_bcast(schedule, data)
    want = data[schedule.root]
    for r in range(n):
        if not np.array_equal(out[r], want):
            missing = [c for c in range(K) if out[r][c, 0] != want[c, 0]]
            raise AssertionError(
                f"{schedule.name}: rank {r} incomplete after schedule; missing chunks {missing}")


def _stalled(faults, num_rounds: int) -> int:
    """Stalled rounds of ``faults`` that the replay reaches."""
    return 0 if faults is None else len([r for r in faults.stalled_rounds if r < num_rounds])


def simulate_collective(schedule: Schedule, data: Sequence[np.ndarray], faults=None,
                        report: dict | None = None) -> list[np.ndarray]:
    """Replay any schedule (bcast/reduce/allreduce/allgather/reduce_scatter):
    every transfer reads the sender's buffer as it was at the start of the
    round, then overwrites the destination chunk range or, for
    ``combine=True`` transfers, accumulates into it.

    With ``faults`` each transfer draws its retransmits keyed by (round,
    src, dst); ``report`` (a dict) receives ``retries`` and
    ``stalled_rounds``."""
    if faults is not None:
        faults.check_alive(schedule)
    bufs = [np.array(d, copy=True) for d in data]
    retries = 0
    for ridx, rnd in enumerate(schedule.rounds):
        staged = [(t, bufs[t.src][t.chunk_start:t.chunk_start + t.chunk_count].copy())
                  for t in rnd.transfers]
        if faults is not None and faults.drop_prob > 0.0:
            for t, _payload in staged:
                retries += faults.retries(ridx, t.src, t.dst)
        for t, payload in staged:
            sl = slice(t.chunk_start, t.chunk_start + t.chunk_count)
            if t.combine:
                bufs[t.dst][sl] = bufs[t.dst][sl] + payload
            else:
                bufs[t.dst][sl] = payload
    if report is not None:
        report["retries"] = retries
        report["stalled_rounds"] = _stalled(faults, len(schedule.rounds))
    return bufs


def simulate_lowered(lowered: LoweredSchedule, data: Sequence[np.ndarray], faults=None,
                     report: dict | None = None) -> list[np.ndarray]:
    """Replay a lowering: per round, lane classes apply in order; each class
    snapshots every source block (at its clipped ``send_start``) before it
    writes, and each destination takes only rows ``[lo, hi)`` of its block
    at ``recv_start`` (overwrite, or accumulate on combine rounds).

    ``faults``/``report`` as :func:`simulate_collective`'s, over the lanes'
    (src, dst) pairs: the dead-rank check runs over every lane, and drop
    streaks are keyed by (round, src, dst, lane-class index)."""
    if faults is not None:
        faults.check_alive_pairs(
            {(src, dst) for cls in lowered.classes for src, dst in cls.perm},
            context=lowered.name,
        )
    bufs = [np.array(d, copy=True) for d in data]
    retries = 0
    for s in range(lowered.num_rounds):
        for ci, cls in enumerate(lowered.classes):
            blocks = {
                dst: bufs[src][cls.send_start[s, src]:cls.send_start[s, src] + cls.block].copy()
                for src, dst in cls.perm
            }
            if faults is not None and faults.drop_prob > 0.0:
                for src, dst in cls.perm:
                    if int(cls.hi[s, dst]) > int(cls.lo[s, dst]):
                        retries += faults.retries(s, src, dst, tag=ci)
            for _src, dst in cls.perm:
                lo, hi = int(cls.lo[s, dst]), int(cls.hi[s, dst])
                if hi <= lo:
                    continue
                r0 = int(cls.recv_start[s, dst])
                if cls.combine[s]:
                    bufs[dst][r0 + lo:r0 + hi] += blocks[dst][lo:hi]
                else:
                    bufs[dst][r0 + lo:r0 + hi] = blocks[dst][lo:hi]
    if report is not None:
        report["retries"] = retries
        report["stalled_rounds"] = _stalled(faults, lowered.num_rounds)
    return bufs


def timed_rounds(schedule: Schedule, chunk_bytes: int, ts: float, bw: float,
                 faults=None) -> float:
    """Round-accurate time estimate: each round costs ts + (bytes of the
    largest transfer in the round)/bw; rounds serialize. Empty rounds cost
    nothing. This is the 'simulator clock' the closed forms of
    :mod:`.cost_model` approximate.

    With ``faults`` a round's bandwidth term is gated by its slowest active
    link (each link's factor divides ``bw``), drops inflate the traffic by
    the expected retransmit factor 1/(1-p), and each stalled round adds
    ``stall_s``. Dead ranks raise ``DeadRankError``: a dead mesh has no
    finish time."""
    if faults is not None:
        faults.check_alive(schedule)
    retry = faults.retry_factor if faults is not None else 1.0
    stalled = set(faults.stalled_rounds) if faults is not None else ()
    total = 0.0
    for ridx, rnd in enumerate(schedule.rounds):
        if not rnd.transfers:
            continue
        if faults is None:
            biggest = max(t.chunk_count for t in rnd.transfers) * chunk_bytes
        else:
            biggest = max(t.chunk_count * chunk_bytes * faults.slowdown(t.src, t.dst)
                          for t in rnd.transfers)
        total += ts + biggest * retry / bw
        if ridx in stalled:
            total += faults.stall_s
    return total
