"""Hand-written broadcast and allreduce loops, and the one-shot baselines.

The generic schedule replay lives in :mod:`repro_torch.comm.executors`
(``execute_collective``, the exact unrolled replay; ``execute_compiled``,
the replay of the host-side lowering). :func:`execute_schedule` and
:func:`execute_reduce_schedule` here are thin wrappers over it.
:func:`pipelined_chain_fused` and :func:`ring_allreduce` are written
separately, round by round, as the single-op references the generic
executors are tested against.

Every function takes a rank-stacked value, rank axis first: row ``r`` is
what rank ``r`` holds (the reference's buffer inside ``shard_map`` over a
named axis). The bcast family's buffer is ``(n, num_chunks, chunk_elems)``;
only the root's row matters on entry, and on exit every row holds it. As
with the executors, a buffer is updated in place where it can be: use the
returned value.

Baselines ("the vendor library"): :func:`xla_psum_bcast` and
:func:`xla_allgather_bcast`, the one-shots (one reduction or one gather
over the rank axis) that ``comm.api`` also runs for ``algo='xla_psum'`` /
``'xla_allgather'``.
"""
from __future__ import annotations

import torch

from .schedules import Schedule, build

__all__ = [
    "execute_schedule",
    "execute_reduce_schedule",
    "pipelined_chain_fused",
    "ring_allreduce",
    "xla_psum_bcast",
    "xla_allgather_bcast",
    "schedule_bcast",
]

_CHAINS = ("pipelined_chain", "bidir_chain")


def execute_schedule(schedule: Schedule, buf: torch.Tensor) -> torch.Tensor:
    """Replay a bcast schedule over ``buf`` ``(n, num_chunks, chunk_elems)``
    with the generic unrolled executor."""
    if schedule.kind != "bcast":
        raise ValueError("use execute_reduce_schedule for reduce schedules")
    from ..comm.executors import execute_collective

    return execute_collective(schedule, buf)


def execute_reduce_schedule(schedule: Schedule, buf: torch.Tensor) -> torch.Tensor:
    """Replay a reduce-to-root schedule (sum combiner) over a rank-stacked
    buffer ``(n, *shape)`` of any shape, viewed as one chunk a rank."""
    if schedule.kind != "reduce":
        raise ValueError("not a reduce schedule")
    from ..comm.executors import execute_collective

    n = buf.shape[0]
    return execute_collective(schedule, buf.reshape(n, 1, -1)).reshape(buf.shape)


def pipelined_chain_fused(buf: torch.Tensor, *, root: int = 0) -> torch.Tensor:
    """The paper's pipelined chain (Eq. 5) as its own loop over
    ``num_chunks + n - 2`` rounds on ``buf`` ``(n, num_chunks, chunk_elems)``.

    Round ``s``: the rank at chain position ``p`` (``(rank - root) % n``)
    sends chunk ``s - p`` to position ``p + 1``, so position ``p >= 1``
    receives chunk ``s - p + 1`` from position ``p - 1`` when that chunk
    exists. The sent chunk and the received one differ on every rank, so
    one gather of the senders' rows and one write of the receivers' rows
    per round keep the round semantics."""
    n, num_chunks = buf.shape[0], buf.shape[1]
    if n == 1:
        return buf
    # (sender, receiver, chunk) of every round, one host-to-device copy
    rounds = [[((root + p - 1) % n, (root + p) % n, s - p + 1)
               for p in range(1, n) if 0 <= s - p + 1 < num_chunks]
              for s in range(num_chunks + n - 2)]
    table = torch.tensor([t for r in rounds for t in r], device=buf.device)
    a = 0
    for r in rounds:  # every round moves at least one chunk
        src, dst, chunk = table[a:a + len(r)].unbind(1)
        buf[dst, chunk] = buf[src, chunk]
        a += len(r)
    return buf


def ring_allreduce(x: torch.Tensor) -> torch.Tensor:
    """The explicit bandwidth-optimal ring allreduce (paper Sec. VII future
    work) over the rank axis of ``x`` ``(n, *shape)``: a reduce-scatter of
    ``n - 1`` rounds, in which each rank accumulates one chunk, then an
    all-gather of ``n - 1`` rounds.

    The flat buffer is padded to ``n`` chunks. Reduce-scatter round ``s``:
    rank ``r`` receives rank ``r - 1``'s operand (its chunk ``(r - 1) % n``
    at ``s = 0``, its running sum after) and adds it to its own chunk
    ``(r - s - 1) % n``, ``received + current`` in ``x``'s dtype, so every
    add rounds as the reference's does. The running sum is kept in that
    chunk itself: it is the chunk rank ``r + 1`` reads next round, and no
    rank writes a chunk another rank reads in the same round. Rank ``r``
    then owns the sum of chunk ``(r + 1) % n``; all-gather round ``s``
    copies chunk ``(r - s) % n`` from rank ``r - 1``.

    Works in ``x`` itself when it is contiguous and its size divides by
    ``n``, else in a padded copy; nothing else is allocated."""
    n = x.shape[0]
    if n == 1:
        return x
    flat = x.reshape(n, -1)
    size = flat.shape[1]
    chunk = -(-size // n)
    pad = n * chunk - size
    if pad:
        flat = torch.cat([flat, flat.new_zeros((n, pad))], dim=1)
    buf = flat.view(n, n, chunk)
    for s in range(n - 1):
        for r in range(n):
            c = (r - s - 1) % n
            buf[r, c].add_(buf[(r - 1) % n, c])
    for s in range(n - 1):
        for r in range(n):
            c = (r - s) % n
            buf[r, c].copy_(buf[(r - 1) % n, c])
    out = buf.view(n, -1)
    if pad:
        out = out[:, :size]
    return out.reshape(x.shape)


# ---------------------------------------------------------------------------
# one-shot baselines (the reference's native XLA collectives)
# ---------------------------------------------------------------------------


def _psum(x: torch.Tensor) -> torch.Tensor:
    """Every row the sum of the rank axis."""
    return x.sum(0, keepdim=True).expand_as(x).clone()


def _all_gather(x: torch.Tensor) -> torch.Tensor:
    """Every row ``(n, *shard)``: all ranks' rows stacked."""
    n = x.shape[0]
    return x.unsqueeze(0).expand((n,) + tuple(x.shape)).clone()


def xla_psum_bcast(x: torch.Tensor, *, root: int = 0) -> torch.Tensor:
    """Broadcast by masking non-root contributions and all-reducing."""
    n = x.shape[0]
    keep = (torch.arange(n, device=x.device) == root).reshape((n,) + (1,) * (x.dim() - 1))
    return _psum(torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=x.device)))


def xla_allgather_bcast(x: torch.Tensor, *, root: int = 0) -> torch.Tensor:
    """Broadcast by all-gather and a select of the root's slice (each rank
    keeps only that slice of its gathered rows)."""
    return x[root:root + 1].expand_as(x).clone()


# ---------------------------------------------------------------------------
# build + execute a named algorithm over a chunked buffer
# ---------------------------------------------------------------------------


def schedule_bcast(
    buf: torch.Tensor,
    *,
    algo: str,
    root: int = 0,
    fused: bool = True,
    **algo_kw,
) -> torch.Tensor:
    """Broadcast a ``(n, num_chunks, chunk)`` buffer with the named
    algorithm. The exact unrolled replay runs while its round count stays
    small; a chain with ``fused`` and more than 256 rounds takes the
    compiled replay (one merge launch per class-round), the policy of
    ``comm.api.apply_plan``. ``scatter_allgather`` needs ``num_chunks ==
    n``; whole-message algorithms view the buffer as one chunk."""
    n, num_chunks = buf.shape[0], buf.shape[1]
    if n == 1:
        return buf
    if algo in _CHAINS and fused and (num_chunks + n - 2) > 256:
        from ..comm.executors import execute_compiled

        return execute_compiled(build(algo, n, root, num_chunks=num_chunks, **algo_kw), buf)
    if algo in _CHAINS:
        sched = build(algo, n, root, num_chunks=num_chunks, **algo_kw)
    elif algo == "scatter_allgather":
        if num_chunks != n:
            raise ValueError(f"scatter_allgather wants num_chunks == n ({n}), got {num_chunks}")
        sched = build(algo, n, root, **algo_kw)
    else:
        if num_chunks != 1:
            out = schedule_bcast(buf.reshape(n, 1, -1), algo=algo, root=root, fused=fused,
                                 **algo_kw)
            return out.reshape(buf.shape)
        sched = build(algo, n, root, **algo_kw)
    return execute_schedule(sched, buf)
