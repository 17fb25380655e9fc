"""Schedule builders for the non-broadcast collectives (DESIGN.md Sec. 3).

Every builder emits a :class:`repro.core.schedules.Schedule` on the same IR
the broadcast library uses — reduce-family transfers carry ``combine=True``
and accumulate at the destination. The reduce builders are literal mirrors
of their broadcast counterparts (rounds reversed, src/dst swapped), the
allreduce builders compose reduce + broadcast phases, and the allgather /
reduce_scatter rings generalize the two phases of the power-of-two
``scatter_allgather`` broadcast (Eq. 4) to any rank count.

Data conventions (buffer is ``(num_chunks, chunk_elems)`` everywhere):

  * reduce / allreduce — every rank contributes its full buffer; on exit the
    root (reduce) or every rank (allreduce) holds the element-wise sum.
  * allgather — ``num_chunks == n``; rank r contributes row r; on exit every
    rank holds all rows.
  * reduce_scatter — ``num_chunks == n``; every rank contributes all rows;
    on exit rank r's row r holds the sum of everyone's row r.

Ragged ops view the chunk axis as a *row* axis (``Schedule.sizes``):

  * allgatherv — ``num_chunks == sum(sizes)``; rank r starts owning the row
    segment ``[off[r], off[r] + sizes[r])``; on exit every rank holds the
    full concatenation. Zero-sized ranks contribute nothing (their segment
    is never put on the wire).
  * alltoallv — rows are partitioned into n*n blocks laid out row-major by
    (src, dst); block (s, d) has ``sizes[s*n + d]`` rows at a fixed global
    offset, so a transfer reads and writes the SAME row range on both ends
    (the IR's invariant). Rank s fills blocks (s, *); on exit rank d's
    blocks (*, d) are valid. Diagonal blocks never travel.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from ..core.schedules import (
    Round,
    Schedule,
    Transfer,
    binomial_reduce,
    pipelined_chain,
    _rot,
)

__all__ = [
    "reverse_for_reduce",
    "binomial_reduce",
    "pipelined_reduce_chain",
    "reduce_then_bcast",
    "fused_rsb",
    "ring_allreduce_schedule",
    "ring_allgather",
    "doubling_allgather",
    "ring_reduce_scatter",
    "ragged_offsets",
    "alltoallv_matrix",
    "shrink_sizes",
    "ring_allgatherv",
    "doubling_allgatherv",
    "pairwise_alltoallv",
    "ring_alltoallv",
    "OP_BUILDERS",
    "RAGGED_OPS",
    "build_op",
]


def reverse_for_reduce(sched: Schedule, name: str) -> Schedule:
    """Mirror a bcast schedule into a reduce-to-root schedule: reverse the
    rounds, swap src/dst, and mark every transfer combining. The chunk-level
    pipelining (and therefore the cost model) carries over unchanged."""
    rounds = tuple(
        Round(tuple(
            Transfer(t.dst, t.src, t.chunk_start, t.chunk_count, combine=True)
            for t in r.transfers
        ))
        for r in reversed(sched.rounds)
    )
    return dataclasses.replace(sched, name=name, rounds=rounds, kind="reduce")


def pipelined_reduce_chain(n: int, root: int = 0, num_chunks: int = 8) -> Schedule:
    """Chunk-pipelined reduce-to-root: the paper's pipelined chain (Eq. 5)
    reversed — partial sums stream toward the root one chunk per hop, so the
    cost keeps Eq. 5's (M/C + n - 2)(ts + C/B) form."""
    return reverse_for_reduce(
        pipelined_chain(n, root, num_chunks), "pipelined_reduce_chain"
    )


def reduce_then_bcast(n: int, root: int, bcast_sched: Schedule) -> Schedule:
    """Two-phase allreduce with a barrier: reversed-binomial reduce-to-root
    over the whole buffer, then the tuned broadcast schedule (any algorithm,
    any chunking). The reduce rounds move the full chunk range at once."""
    num_chunks = bcast_sched.num_chunks
    red = binomial_reduce(n, root)
    red_rounds = tuple(
        Round(tuple(
            Transfer(t.src, t.dst, 0, num_chunks, combine=True)
            for t in r.transfers
        ))
        for r in red.rounds
    )
    return Schedule(
        f"reduce_then_bcast[{bcast_sched.name}]",
        n,
        root,
        num_chunks,
        red_rounds + bcast_sched.rounds,
        kind="allreduce",
    )


def fused_rsb(n: int, root: int = 0, num_chunks: int = 8) -> Schedule:
    """Fused pipelined reduce-chain + bcast-chain allreduce ("fused_rsb").

    Logical chain positions 0 (the head, at ``root``) .. n-1. Chunk c's
    partial sums hop head-ward, fully reduced at position 0 at round
    c + n - 2; the head immediately streams it back tail-ward while later
    chunks are still reducing. Round s carries, concurrently on the two
    directions of each full-duplex link:

      * reduce: edge p -> p-1 moves chunk s - (n - 1 - p)   (combine)
      * bcast:  edge p -> p+1 moves chunk s - (n - 1) - p   (overwrite)

    Total rounds: num_chunks + 2n - 3, matching t_fused_rsb in the cost
    model. A destination appears twice in a round (one reduce chunk, one
    bcast chunk) — the relaxed Round invariant allows it because the chunk
    ranges are disjoint.
    """
    if n == 1:
        return Schedule("fused_rsb", n, root, num_chunks, (), kind="allreduce")
    rounds = []
    for s in range(num_chunks + 2 * n - 3):
        transfers = []
        for p in range(1, n):  # reduce edge p -> p-1
            c = s - (n - 1 - p)
            if 0 <= c < num_chunks:
                transfers.append(
                    Transfer(_rot(p, root, n), _rot(p - 1, root, n), c, 1, combine=True)
                )
        for p in range(n - 1):  # bcast edge p -> p+1
            c = s - (n - 1) - p
            if 0 <= c < num_chunks:
                transfers.append(
                    Transfer(_rot(p, root, n), _rot(p + 1, root, n), c, 1)
                )
        if transfers:
            rounds.append(Round(tuple(transfers)))
    return Schedule("fused_rsb", n, root, num_chunks, tuple(rounds), kind="allreduce")


def ring_allreduce_schedule(n: int, root: int = 0) -> Schedule:
    """Bandwidth-optimal ring allreduce on the IR: n-1 combining
    reduce-scatter rounds, then n-1 allgather rounds (``root`` is irrelevant
    — the result is symmetric). ``num_chunks == n``; works for any n."""
    if n == 1:
        return Schedule("ring_allreduce", n, root, 1, (), kind="allreduce")
    rounds = []
    # reduce-scatter: round s, rank r sends its partial of chunk (r - s) mod n
    # to r+1; after n-1 rounds rank r owns the full sum of chunk (r+1) mod n.
    for s in range(n - 1):
        rounds.append(Round(tuple(
            Transfer(r, (r + 1) % n, (r - s) % n, 1, combine=True) for r in range(n)
        )))
    # allgather: circulate the reduced chunks.
    for s in range(n - 1):
        rounds.append(Round(tuple(
            Transfer(r, (r + 1) % n, (r + 1 - s) % n, 1) for r in range(n)
        )))
    return Schedule("ring_allreduce", n, root, n, tuple(rounds), kind="allreduce")


def ring_allgather(n: int, root: int = 0) -> Schedule:
    """Ring allgather for ANY rank count — the generalization of the
    power-of-two scatter_allgather bcast's second phase. Rank r starts
    owning row r; round s moves row (r - s) mod n over edge r -> r+1."""
    if n == 1:
        return Schedule("ring_allgather", n, root, 1, (), kind="allgather")
    rounds = tuple(
        Round(tuple(Transfer(r, (r + 1) % n, (r - s) % n, 1) for r in range(n)))
        for s in range(n - 1)
    )
    return Schedule("ring_allgather", n, root, n, rounds, kind="allgather")


def doubling_allgather(n: int, root: int = 0) -> Schedule:
    """Recursive-doubling allgather (power-of-two n): round t pairs rank r
    with r XOR 2^t and exchanges the 2^t contiguous rows each side owns —
    log2(n) startups for the same total bytes as the ring."""
    if n & (n - 1):
        raise ValueError(f"doubling_allgather requires power-of-two n, got {n}")
    if n == 1:
        return Schedule("doubling_allgather", n, root, 1, (), kind="allgather")
    rounds = []
    span = 1
    while span < n:
        transfers = []
        for r in range(n):
            base = (r // span) * span
            transfers.append(Transfer(r, r ^ span, base, span))
        rounds.append(Round(tuple(transfers)))
        span *= 2
    return Schedule("doubling_allgather", n, root, n, tuple(rounds), kind="allgather")


def ring_reduce_scatter(n: int, root: int = 0) -> Schedule:
    """Ring reduce-scatter for any n: n-1 combining rounds after which rank
    r's row r holds the element-wise sum of everyone's row r."""
    if n == 1:
        return Schedule("ring_reduce_scatter", n, root, 1, (), kind="reduce_scatter")
    rounds = tuple(
        Round(tuple(
            Transfer(r, (r + 1) % n, (r - s - 1) % n, 1, combine=True)
            for r in range(n)
        ))
        for s in range(n - 1)
    )
    return Schedule("ring_reduce_scatter", n, root, n, rounds, kind="reduce_scatter")


# ---------------------------------------------------------------------------
# Ragged collectives (allgatherv / alltoallv)
# ---------------------------------------------------------------------------


def _gatherv_sizes(n: int, sizes) -> tuple[int, ...]:
    """Validated per-rank row counts for the allgatherv builders."""
    flat = tuple(int(s) for s in sizes)
    if len(flat) != n:
        raise ValueError(f"allgatherv sizes must have n={n} entries, got {len(flat)}")
    return flat


def ragged_offsets(sizes) -> tuple[tuple[int, ...], int]:
    """Prefix offsets of a size vector: ``(off_0..off_k, total)`` with a
    sentinel ``off[k] == total`` so segment k spans ``[off[k], off[k+1])``."""
    off, acc = [], 0
    for s in sizes:
        if s < 0:
            raise ValueError(f"sizes must be non-negative: {tuple(sizes)}")
        off.append(acc)
        acc += int(s)
    off.append(acc)
    return tuple(off), acc


def alltoallv_matrix(sizes, n: int) -> tuple[tuple[int, ...], ...]:
    """Normalize an alltoallv size spec to an n x n matrix ``M[src][dst]``.

    Accepts a length-n vector (every source sends ``sizes[d]`` rows to rank
    d — the expert-dispatch case, where capacity is per destination), a flat
    length-n*n row-major vector, or a full matrix."""
    sizes = tuple(sizes)
    if len(sizes) and isinstance(sizes[0], (tuple, list)):
        m = tuple(tuple(int(v) for v in row) for row in sizes)
        if len(m) != n or any(len(row) != n for row in m):
            raise ValueError(f"alltoallv matrix must be {n}x{n}")
        return m
    if len(sizes) == n:
        row = tuple(int(v) for v in sizes)
        return tuple(row for _ in range(n))
    if len(sizes) == n * n:
        flat = tuple(int(v) for v in sizes)
        return tuple(flat[s * n:(s + 1) * n] for s in range(n))
    raise ValueError(f"alltoallv sizes must have n, n*n, or matrix shape; got {len(sizes)}")


def shrink_sizes(op: str, sizes, survivors) -> tuple[int, ...]:
    """Remap a ragged size vector onto a survivor mesh: the dead ranks'
    segments (allgatherv) or source rows AND destination columns (alltoallv)
    drop out of the global row frame. ``survivors`` lists physical ranks in
    ascending order; the result is indexed by the survivor-mesh logical
    rank. Flat tuples in, flat tuple out (alltoallv row-major)."""
    surv = tuple(int(r) for r in survivors)
    sizes = tuple(sizes)
    if op == "allgatherv":
        return tuple(int(sizes[r]) for r in surv)
    if op != "alltoallv":
        raise ValueError(f"shrink_sizes is for ragged ops, not {op!r}")
    if sizes and isinstance(sizes[0], (tuple, list)):
        n = len(sizes)
    else:
        n = int(round(len(sizes) ** 0.5))
        if n * n != len(sizes):
            raise ValueError(
                f"alltoallv sizes must be an n x n matrix or flat n*n vector, "
                f"got length {len(sizes)}"
            )
    m = alltoallv_matrix(sizes, n)
    return tuple(int(m[s][d]) for s in surv for d in surv)


def ring_allgatherv(n: int, sizes, root: int = 0) -> Schedule:
    """Ring allgatherv: round s forwards the segment that originated at rank
    (r - s) mod n over edge r -> r+1. Empty segments never enter the ring,
    so zero-sized ranks cost nothing; every round is gated by the largest
    segment in flight — under skew the ring's bandwidth advantage evaporates
    (see cost_model.t_ring_allgatherv)."""
    sizes = _gatherv_sizes(n, sizes)
    off, total = ragged_offsets(sizes)
    if n == 1 or total == 0:
        return Schedule("ring_allgatherv", n, root, total, (), kind="allgatherv",
                        sizes=tuple(int(s) for s in sizes))
    rounds = []
    for s in range(n - 1):
        transfers = []
        for r in range(n):
            seg = (r - s) % n
            if sizes[seg]:
                transfers.append(
                    Transfer(r, (r + 1) % n, off[seg], int(sizes[seg]))
                )
        if transfers:
            rounds.append(Round(tuple(transfers)))
    return Schedule("ring_allgatherv", n, root, total, tuple(rounds),
                    kind="allgatherv", sizes=tuple(int(s) for s in sizes))


def doubling_allgatherv(n: int, sizes, root: int = 0) -> Schedule:
    """Recursive-doubling allgatherv (power-of-two n): round t exchanges the
    contiguous group of 2^t segments each side has gathered so far. Ragged
    groups are still contiguous row ranges, so each exchange is ONE
    variable-height transfer — log2(n) startups regardless of skew."""
    if n & (n - 1):
        raise ValueError(f"doubling_allgatherv requires power-of-two n, got {n}")
    sizes = _gatherv_sizes(n, sizes)
    off, total = ragged_offsets(sizes)
    if n == 1 or total == 0:
        return Schedule("doubling_allgatherv", n, root, total, (), kind="allgatherv",
                        sizes=tuple(int(s) for s in sizes))
    rounds = []
    span = 1
    while span < n:
        transfers = []
        for r in range(n):
            base = (r // span) * span
            cnt = off[base + span] - off[base]
            if cnt:
                transfers.append(Transfer(r, r ^ span, off[base], cnt))
        if transfers:
            rounds.append(Round(tuple(transfers)))
        span *= 2
    return Schedule("doubling_allgatherv", n, root, total, tuple(rounds),
                    kind="allgatherv", sizes=tuple(int(s) for s in sizes))


def pairwise_alltoallv(n: int, sizes, root: int = 0) -> Schedule:
    """Pairwise-exchange alltoallv: step s (1..n-1) sends block (r, r+s)
    directly to its destination — every block crosses the wire exactly once,
    n-1 startups, each step gated by its largest block."""
    m = alltoallv_matrix(sizes, n)
    flat = tuple(v for row in m for v in row)
    off, total = ragged_offsets(flat)
    rounds = []
    for s in range(1, n):
        transfers = []
        for r in range(n):
            d = (r + s) % n
            cnt = m[r][d]
            if cnt:
                transfers.append(Transfer(r, d, off[r * n + d], cnt))
        if transfers:
            rounds.append(Round(tuple(transfers)))
    return Schedule("pairwise_alltoallv", n, root, total, tuple(rounds),
                    kind="alltoallv", sizes=flat)


def ring_alltoallv(n: int, sizes, root: int = 0) -> Schedule:
    """Store-and-forward ring alltoallv: block (s, d) hops s -> s+1 -> ... -> d.
    At round t every block still in transit is at rank (s + t) mod n, and all
    blocks leaving rank r that round share the source s = (r - t) mod n, so
    their destination set is a cyclic interval — at most two contiguous row
    ranges per edge per round. Neighbor-only traffic, but each block pays its
    hop count in wire bytes."""
    m = alltoallv_matrix(sizes, n)
    flat = tuple(v for row in m for v in row)
    off, total = ragged_offsets(flat)
    rounds = []
    for t in range(n - 1):
        transfers = []
        for r in range(n):
            s = (r - t) % n
            # destinations still ahead of this block: (d - s) mod n > t
            ds = [d for d in range(n) if (d - s) % n > t]
            if not ds:
                continue
            # split the cyclic interval into contiguous column runs
            runs, run = [], [ds[0]]
            for d in ds[1:]:
                if d == run[-1] + 1:
                    run.append(d)
                else:
                    runs.append(run)
                    run = [d]
            runs.append(run)
            for run in runs:
                lo, hi = run[0], run[-1]
                cnt = off[s * n + hi + 1] - off[s * n + lo]
                if cnt:
                    transfers.append(Transfer(r, (r + 1) % n, off[s * n + lo], cnt))
        if transfers:
            rounds.append(Round(tuple(transfers)))
    return Schedule("ring_alltoallv", n, root, total, tuple(rounds),
                    kind="alltoallv", sizes=flat)


# ---------------------------------------------------------------------------
# Registry (reduce_then_bcast is composite — built in plan.py, where the
# inner bcast decision is available)
# ---------------------------------------------------------------------------

OP_BUILDERS: dict[str, dict[str, Callable[..., Schedule]]] = {
    "reduce": {
        "binomial_reduce": lambda n, root, num_chunks=1: binomial_reduce(n, root),
        "pipelined_reduce_chain": pipelined_reduce_chain,
    },
    "allreduce": {
        "fused_rsb": fused_rsb,
        "ring_allreduce": lambda n, root, num_chunks=None: ring_allreduce_schedule(n, root),
    },
    "allgather": {
        "ring_allgather": lambda n, root, num_chunks=None: ring_allgather(n, root),
        "doubling_allgather": lambda n, root, num_chunks=None: doubling_allgather(n, root),
    },
    "reduce_scatter": {
        "ring_reduce_scatter": lambda n, root, num_chunks=None: ring_reduce_scatter(n, root),
    },
    # ragged ops take a size vector instead of num_chunks; sizes=None falls
    # back to the uniform one-row-per-rank layout (the plain op's shape)
    "allgatherv": {
        "ring_allgatherv": lambda n, root, sizes=None: ring_allgatherv(
            n, sizes if sizes is not None else (1,) * n, root),
        "doubling_allgatherv": lambda n, root, sizes=None: doubling_allgatherv(
            n, sizes if sizes is not None else (1,) * n, root),
    },
    "alltoallv": {
        "pairwise_alltoallv": lambda n, root, sizes=None: pairwise_alltoallv(
            n, sizes if sizes is not None else (1,) * n, root),
        "ring_alltoallv": lambda n, root, sizes=None: ring_alltoallv(
            n, sizes if sizes is not None else (1,) * n, root),
    },
}

RAGGED_OPS = ("allgatherv", "alltoallv")


def build_op(op: str, algo: str, n: int, root: int = 0, *, num_chunks: int = 1,
             sizes=None) -> Schedule:
    """Build + validate a non-bcast op schedule by name."""
    try:
        builder = OP_BUILDERS[op][algo]
    except KeyError:
        have = {o: sorted(a) for o, a in OP_BUILDERS.items()}
        raise KeyError(f"no builder for op={op!r} algo={algo!r}; have {have}") from None
    if op in RAGGED_OPS:
        sched = builder(n, root, sizes=sizes)
    else:
        sched = builder(n, root, num_chunks=num_chunks)
    sched.validate_ranks()
    return sched
