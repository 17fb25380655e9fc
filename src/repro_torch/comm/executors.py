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
* :func:`execute_inkernel` — the one-launch persistent replay; not ported.

An exchange between ranks is a device-memory copy between rows of the
stacked buffer: the ``lax.ppermute`` of the reference restricted to the
pairs that carry data (:mod:`repro_torch.launch.mesh`). Send
blocks are snapshotted before any destination is written, as the round
semantics require (a rank may send and receive in one lane).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.schedules import LoweredSchedule, Schedule, lower_schedule
from ..kernels.combine_update import fused_combine_update

__all__ = ["execute_collective", "execute_compiled", "execute_inkernel"]


def _check(buf: torch.Tensor, n: int, num_chunks: int) -> None:
    if buf.dim() != 3 or buf.shape[0] != n or buf.shape[1] != num_chunks:
        raise ValueError(f"buffer {tuple(buf.shape)} does not fit a schedule over "
                         f"n={n} ranks and {num_chunks} chunks")


def _execute_lane(transfers, buf: torch.Tensor) -> None:
    count = transfers[0].chunk_count
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


def execute_collective(schedule: Schedule, buf: torch.Tensor) -> torch.Tensor:
    """Replay any schedule over ``buf`` round by round, lane by lane (the
    lane partition comes from the cached host-side lowering)."""
    _check(buf, schedule.n, schedule.num_chunks)
    for lanes in lower_schedule(schedule).round_lanes:
        for lane in lanes:
            _execute_lane(lane, buf)
    return buf


def execute_compiled(schedule: Schedule | LoweredSchedule,
                     buf: torch.Tensor) -> torch.Tensor:
    """Compiled replay: a loop over the lowered rounds; per lane class one
    gather of the send blocks and one fused combine-update launch.

    Inactive (fill/drain) pairs of a class carry nothing: their destination
    window is empty (``lo == hi``), so the kernel keeps those rows and their
    receive slot is never read."""
    lowered = (
        schedule if isinstance(schedule, LoweredSchedule) else lower_schedule(schedule)
    )
    _check(buf, lowered.n, lowered.num_chunks)
    if lowered.num_rounds == 0:
        return buf
    n, _K, C = buf.shape
    classes = []
    for cls in lowered.classes:
        # [recv_start, lo, hi] per round and rank, on the buffer's device once
        tab = torch.from_numpy(np.stack([cls.recv_start, cls.lo, cls.hi], axis=1))
        recv = torch.empty((n, cls.block, C), dtype=buf.dtype, device=buf.device)
        classes.append((cls, tab.to(buf.device), recv))
    for s in range(lowered.num_rounds):
        for cls, tab, recv in classes:
            for src, dst in cls.perm:
                if cls.hi[s, dst] > cls.lo[s, dst]:
                    a = int(cls.send_start[s, src])
                    recv[dst].copy_(buf[src, a:a + cls.block])
            fused_combine_update(buf, recv, tab[s, 0], tab[s, 1], tab[s, 2],
                                 int(cls.combine[s]))
    return buf


def execute_inkernel(schedule: Schedule | LoweredSchedule,
                     buf: torch.Tensor) -> torch.Tensor:
    raise NotImplementedError(
        "the in-kernel executor (one persistent launch per schedule) is not "
        "ported yet: ROADMAP B.6 (inkernel_replay_shared)"
    )
