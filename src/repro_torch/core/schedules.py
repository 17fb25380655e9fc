"""Static broadcast/reduce schedule generation.

A *schedule* is the algorithm-level description of a collective: an ordered
tuple of rounds, where every transfer inside one round happens concurrently
(disjoint destinations -> one ``lax.ppermute`` per round) and rounds are
serialized by data dependency.

The same schedule objects drive three consumers:

  * ``core.algorithms``   — the shard_map/ppermute executor (JAX, on device)
  * ``core.simulator``    — a pure-numpy step simulator used for property tests
  * ``core.cost_model``   — round-count / bytes-on-wire accounting

This mirrors the paper's framing (Sec. III/IV): the algorithm is a schedule of
point-to-point sends; the runtime then maps it onto the fabric.

Chunks: the message is viewed as ``num_chunks`` equal chunks. Whole-message
algorithms use ``num_chunks == 1``. A transfer moves the contiguous chunk
range ``[chunk_start, chunk_start + chunk_count)``.

Ragged collectives (allgatherv/alltoallv) reuse the same chunk axis as a
*row* axis: ``Schedule.sizes`` records the per-rank (or per-block) row
counts, ``num_chunks == sum(sizes)``, and transfers move variable-height
contiguous row ranges. Nothing else in the IR changes — the lowering's
per-rank ``[lo, hi)`` windows already express a ragged tail as a narrower
row window of a fixed-height block.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Tuple

import numpy as np

__all__ = [
    "Transfer",
    "Round",
    "Schedule",
    "LaneClass",
    "LoweredSchedule",
    "KernelTables",
    "lane_partition",
    "lower_schedule",
    "pack_tables",
    "direct",
    "chain",
    "pipelined_chain",
    "binomial",
    "knomial",
    "scatter_allgather",
    "binomial_reduce",
    "ALGORITHMS",
    "build",
]


@dataclasses.dataclass(frozen=True)
class Transfer:
    """One point-to-point send of a contiguous chunk range.

    ``combine=True`` marks a reducing transfer: the receiver accumulates the
    payload into its buffer (sum) instead of overwriting. This is the only
    IR difference between broadcast-family and reduce-family collectives —
    everything else (rounds, chunking, lanes) is shared.
    """

    src: int
    dst: int
    chunk_start: int = 0
    chunk_count: int = 1
    combine: bool = False

    def chunks(self) -> range:
        return range(self.chunk_start, self.chunk_start + self.chunk_count)


@dataclasses.dataclass(frozen=True)
class Round:
    """Transfers that are issued concurrently (one ppermute per lane).

    A destination may appear more than once in a round only if the incoming
    chunk ranges are disjoint (e.g. the fused allreduce chain, where an
    interior rank receives a reduce chunk and a bcast chunk concurrently on
    its two full-duplex links).

    Transfers in one round may move ranges of different heights (ragged
    collectives do); :func:`lane_partition` keeps each ppermute lane
    uniform-height so the executors' static block slices stay valid."""

    transfers: Tuple[Transfer, ...]

    def __post_init__(self):
        by_dst: dict[int, list[Transfer]] = {}
        for t in self.transfers:
            by_dst.setdefault(t.dst, []).append(t)
        for dst, ts in by_dst.items():
            if len(ts) > 1:
                seen: set[int] = set()
                for t in ts:
                    rng = set(t.chunks())
                    if seen & rng:
                        raise ValueError(
                            f"overlapping chunk ranges for destination {dst}: {ts}"
                        )
                    seen |= rng
        if any(t.chunk_count <= 0 for t in self.transfers):
            raise ValueError("transfers must move a non-empty chunk range")

    @property
    def chunk_count(self) -> int:
        return self.transfers[0].chunk_count if self.transfers else 0


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A full collective schedule."""

    name: str
    n: int
    root: int
    num_chunks: int
    rounds: Tuple[Round, ...]
    # collective op this schedule implements: 'bcast' | 'reduce' |
    # 'allreduce' | 'allgather' | 'reduce_scatter' | 'allgatherv' |
    # 'alltoallv'. Reduce-family transfers carry combine=True (accumulate at
    # dst); see repro.comm.schedules for the non-bcast builders.
    kind: str = "bcast"
    # Ragged collectives: per-rank (allgatherv, len n) or per-(src, dst)
    # block (alltoallv, len n*n row-major) row counts. When set,
    # ``num_chunks == sum(sizes)`` and the chunk axis is the row axis of the
    # ragged payload. ``None`` for uniform collectives.
    sizes: Tuple[int, ...] | None = None

    @property
    def num_rounds(self) -> int:
        return len(self.rounds)

    def wire_chunks(self) -> int:
        """Total chunk-transfers on the wire (bandwidth accounting)."""
        return sum(t.chunk_count for r in self.rounds for t in r.transfers)

    def validate_ranks(self) -> None:
        if self.sizes is not None:
            if len(self.sizes) not in (self.n, self.n * self.n):
                raise ValueError(
                    f"sizes must have n or n*n entries, got {len(self.sizes)}"
                )
            if any(s < 0 for s in self.sizes):
                raise ValueError(f"sizes must be non-negative: {self.sizes}")
            if sum(self.sizes) != self.num_chunks:
                raise ValueError(
                    f"sum(sizes)={sum(self.sizes)} != num_chunks={self.num_chunks}"
                )
        for r in self.rounds:
            for t in r.transfers:
                if not (0 <= t.src < self.n and 0 <= t.dst < self.n):
                    raise ValueError(f"rank out of range in {t} (n={self.n})")
                if t.src == t.dst:
                    raise ValueError(f"self-send in {t}")
                if not (0 <= t.chunk_start and t.chunk_start + t.chunk_count <= self.num_chunks):
                    raise ValueError(f"chunk range out of bounds in {t}")


def _rot(rank: int, root: int, n: int) -> int:
    """Relabel logical rank (root-relative) to physical rank."""
    return (rank + root) % n


# ---------------------------------------------------------------------------
# Host-side lowering: schedule -> dense per-round index tables
#
# The trace-level executor (comm.executors.execute_collective) unrolls every
# round into HLO, so program size grows with the round count. Lowering turns
# a schedule into a handful of *lane classes* — each a static ppermute
# permutation plus dense (num_rounds, n) numpy index tables — which the
# compiled executor (comm.executors.execute_compiled) replays with ONE
# lax.fori_loop over rounds: HLO size is O(num_classes), independent of
# num_chunks and round count. All of this runs once per schedule on the host
# (cached), never at trace time.
# ---------------------------------------------------------------------------


def lane_partition(transfers) -> list[list[Transfer]]:
    """Partition a round's transfers into ppermute lanes: within one lane
    each rank is a source at most once AND a destination at most once, and
    all transfers share the combine flag and block height (so the executor's
    static-shape slice per lane stays valid for ragged rounds). Multi-lane
    rounds (bidir chain, fused_rsb) run on disjoint full-duplex links
    concurrently on TPU.

    Greedy first-fit is O(T^2) in the round's transfer count — which is why
    it lives in the host-side lowering (computed once per schedule via
    :func:`lower_schedule`), not at trace time."""
    lanes: list[list[Transfer]] = []
    for t in transfers:
        for lane in lanes:
            if (
                lane[0].combine == t.combine
                and lane[0].chunk_count == t.chunk_count
                and all(t.src != u.src and t.dst != u.dst for u in lane)
            ):
                lane.append(t)
                break
        else:
            lanes.append([t])
    return lanes


@dataclasses.dataclass(frozen=True, eq=False)
class LaneClass:
    """One static ppermute 'wire' of the compiled executor.

    ``perm`` is the union of every (src, dst) pair the class ever carries —
    a valid permutation fragment (each rank a source at most once, a
    destination at most once) held CONSTANT across rounds; rounds where a
    pair is inactive send a clipped garbage block that the destination's
    ``lo == hi`` window masks away (exactly the fill/drain discipline of the
    old hand-written fori_loop executors). ``combine`` is PER ROUND (a class
    carries one lane per round, and that lane's combine flag may differ
    between rounds) — this is what lets ring_allreduce's reduce-scatter and
    allgather phases share one fully-active class instead of two
    half-idle ones. The dense tables are indexed ``[round, rank]``:

      * ``send_start`` — first buffer row the rank slices into its outgoing
        block (clipped to ``num_chunks - block``);
      * ``recv_start`` — first buffer row the incoming block lands on
        (same transfer's ``chunk_start``, identically clipped, so the row
        alignment inside the block is shared by both ends);
      * ``lo`` / ``hi`` — the half-open row window of the block that is
        actually valid at the destination this round (``lo == hi`` when the
        rank is not a destination).
    """

    perm: Tuple[Tuple[int, int], ...]
    combine: np.ndarray             # (num_rounds,) int32: 1 = accumulate
    block: int                      # block height (max chunk_count it carries)
    send_start: np.ndarray          # (num_rounds, n) int32
    recv_start: np.ndarray          # (num_rounds, n) int32
    lo: np.ndarray                  # (num_rounds, n) int32
    hi: np.ndarray                  # (num_rounds, n) int32


@dataclasses.dataclass(frozen=True, eq=False)
class LoweredSchedule:
    """Dense round tables + hoisted lane partition for one schedule."""

    name: str
    kind: str
    n: int
    num_chunks: int
    classes: Tuple[LaneClass, ...]
    # lane partition per (non-empty) round, in schedule order — the unrolled
    # executor replays these; computed once here, never at trace time
    round_lanes: Tuple[Tuple[Tuple[Transfer, ...], ...], ...]

    @property
    def num_rounds(self) -> int:
        return len(self.round_lanes)

    @property
    def num_classes(self) -> int:
        return len(self.classes)

    def lane_counts(self) -> Tuple[int, ...]:
        """Lanes per round (pinned by the lane-partition unit tests)."""
        return tuple(len(lanes) for lanes in self.round_lanes)

    def wire_chunks_exact(self) -> int:
        """Chunk-transfers the exact (unrolled) replay puts on the wire."""
        return sum(
            t.chunk_count for lanes in self.round_lanes for lane in lanes for t in lane
        )

    def wire_chunks_compiled(self) -> int:
        """Chunk-transfers the compiled replay puts on the wire: every class
        sends its full block over its full permutation every round (inactive
        pairs carry masked garbage — the compiled executor trades fill/drain
        wire for O(1) HLO)."""
        return self.num_rounds * sum(len(c.perm) * c.block for c in self.classes)

    @property
    def zero_waste(self) -> bool:
        """True when the compiled replay sends exactly the schedule's bytes
        (fully-active rounds, e.g. the ring family) — compiled then
        dominates the unrolled executor outright."""
        return self.wire_chunks_compiled() == self.wire_chunks_exact()


@functools.lru_cache(maxsize=256)
def lower_schedule(schedule: Schedule) -> LoweredSchedule:
    """Lower a schedule to dense per-round index tables (host-side, cached).

    Greedy class assignment: walk rounds in order; each lane joins the
    first class whose permutation it can extend without conflict (a rank
    already sending must keep its destination; a new pair must not reuse an
    occupied destination), one lane per class per round. The combine flag is
    recorded per round, not per class, so a class may carry combining rounds
    and overwriting rounds (ring_allreduce: one class for both phases).
    Chain/ring schedules collapse to 1-2 classes regardless of chunk count;
    tree schedules get O(log n) classes (one per doubling level).
    """
    K = max(schedule.num_chunks, 1)
    n = schedule.n
    rounds = [r for r in schedule.rounds if r.transfers]
    round_lanes = tuple(
        tuple(tuple(lane) for lane in lane_partition(r.transfers)) for r in rounds
    )
    T = len(rounds)

    classes: list[dict] = []
    for ri, lanes in enumerate(round_lanes):
        used: set[int] = set()
        for lane in lanes:
            placed = None
            for ci, cl in enumerate(classes):
                if ci in used:
                    continue
                ok = True
                for t in lane:
                    d = cl["perm"].get(t.src)
                    if (d is not None and d != t.dst) or (d is None and t.dst in cl["dsts"]):
                        ok = False
                        break
                if ok:
                    placed = ci
                    break
            if placed is None:
                classes.append({"perm": {}, "dsts": set(), "entries": []})
                placed = len(classes) - 1
            cl = classes[placed]
            for t in lane:
                if t.src not in cl["perm"]:
                    cl["perm"][t.src] = t.dst
                    cl["dsts"].add(t.dst)
            cl["entries"].append((ri, lane))
            used.add(placed)

    out: list[LaneClass] = []
    for cl in classes:
        block = max(t.chunk_count for _ri, lane in cl["entries"] for t in lane)
        combine = np.zeros((T,), np.int32)
        send = np.zeros((T, n), np.int32)
        recv = np.zeros((T, n), np.int32)
        lo = np.zeros((T, n), np.int32)
        hi = np.zeros((T, n), np.int32)
        clip = max(K - block, 0)
        for ri, lane in cl["entries"]:
            combine[ri] = int(lane[0].combine)
            for t in lane:
                s = min(t.chunk_start, clip)
                send[ri, t.src] = s
                recv[ri, t.dst] = s
                off = t.chunk_start - s
                lo[ri, t.dst] = off
                hi[ri, t.dst] = off + t.chunk_count
        perm = tuple(sorted(cl["perm"].items()))
        out.append(LaneClass(perm, combine, block, send, recv, lo, hi))

    return LoweredSchedule(
        schedule.name, schedule.kind, n, K, tuple(out), round_lanes
    )


@dataclasses.dataclass(frozen=True, eq=False)
class KernelTables:
    """Kernel-ready stacked layout of a lowering's per-class round tables.

    The in-kernel executor (``repro.kernels.inkernel_collective``) replays a
    whole schedule inside ONE Pallas launch, so it needs every class's tables
    as dense operands it can index absolutely from the kernel body:

      * ``send_start``/``recv_start``/``lo``/``hi`` — int32
        ``(num_classes, num_rounds, n)``, the per-class ``LaneClass`` tables
        stacked on a leading class axis (scalar-prefetch operands on TPU);
      * ``combine`` — int32 ``(num_classes, num_rounds)``;
      * ``perms``/``blocks`` — the static per-class permutation fragments
        and block heights, which become kernel *structure* (python loops),
        not data.

    Classes with ``block == 0`` never occur (lowering drops empty rounds and
    every transfer moves >= 1 chunk), but a ragged schedule may address
    zero-height windows through ``lo == hi`` — the kernel's row mask handles
    those identically to the numpy simulator's skip.
    """

    n: int
    num_chunks: int
    perms: Tuple[Tuple[Tuple[int, int], ...], ...]
    blocks: Tuple[int, ...]
    send_start: np.ndarray          # (num_classes, num_rounds, n) int32
    recv_start: np.ndarray          # (num_classes, num_rounds, n) int32
    lo: np.ndarray                  # (num_classes, num_rounds, n) int32
    hi: np.ndarray                  # (num_classes, num_rounds, n) int32
    combine: np.ndarray             # (num_classes, num_rounds) int32

    @property
    def num_classes(self) -> int:
        return len(self.blocks)

    @property
    def num_rounds(self) -> int:
        return self.send_start.shape[1]


@functools.lru_cache(maxsize=256)
def pack_tables(lowered: LoweredSchedule) -> KernelTables:
    """Stack a lowering's per-class tables into the kernel-resident layout.

    Cached on the ``LoweredSchedule`` identity (``lower_schedule`` is itself
    cached, so repeated plans share one packing)."""
    n, T = lowered.n, lowered.num_rounds
    cs = lowered.classes
    if not cs:
        z3 = np.zeros((0, T, n), np.int32)
        return KernelTables(
            n, lowered.num_chunks, (), (), z3, z3, z3, z3,
            np.zeros((0, T), np.int32),
        )
    return KernelTables(
        n,
        lowered.num_chunks,
        tuple(c.perm for c in cs),
        tuple(c.block for c in cs),
        np.ascontiguousarray(np.stack([c.send_start for c in cs]), np.int32),
        np.ascontiguousarray(np.stack([c.recv_start for c in cs]), np.int32),
        np.ascontiguousarray(np.stack([c.lo for c in cs]), np.int32),
        np.ascontiguousarray(np.stack([c.hi for c in cs]), np.int32),
        np.ascontiguousarray(np.stack([c.combine for c in cs]), np.int32),
    )


# ---------------------------------------------------------------------------
# Fundamental algorithms (paper Sec. III-A)
# ---------------------------------------------------------------------------


def direct(n: int, root: int = 0) -> Schedule:
    """Eq. 1 — serialized loop of root -> i sends of the whole message."""
    rounds = tuple(
        Round((Transfer(root, _rot(i, root, n)),)) for i in range(1, n)
    )
    return Schedule("direct", n, root, 1, rounds)


def chain(n: int, root: int = 0) -> Schedule:
    """Eq. 2 — chain without wrap-around; whole message per hop."""
    rounds = tuple(
        Round((Transfer(_rot(i - 1, root, n), _rot(i, root, n)),))
        for i in range(1, n)
    )
    return Schedule("chain", n, root, 1, rounds)


def pipelined_chain(n: int, root: int = 0, num_chunks: int = 8) -> Schedule:
    """Eq. 5 — THE paper's proposed design.

    The root pushes chunks down the chain; every interior process forwards
    chunk ``c`` one round after receiving it. Round ``s`` carries chunk
    ``s - j`` over edge ``j -> j+1`` (logical ranks). Total rounds:
    ``num_chunks + n - 2``.
    """
    if n == 1:
        return Schedule("pipelined_chain", n, root, num_chunks, ())
    rounds = []
    for s in range(num_chunks + n - 2):
        transfers = []
        for j in range(n - 1):  # edge j -> j+1
            c = s - j
            if 0 <= c < num_chunks:
                transfers.append(
                    Transfer(_rot(j, root, n), _rot(j + 1, root, n), c, 1)
                )
        if transfers:
            rounds.append(Round(tuple(transfers)))
    return Schedule("pipelined_chain", n, root, num_chunks, tuple(rounds))


def knomial(n: int, root: int = 0, k: int = 2) -> Schedule:
    """Eq. 3 — k-nomial tree. ``k == 2`` is the binomial tree.

    Logical round ``t`` (t = 0.. ceil(log_k n)-1): every rank that already has
    the data (logical rank < k**t) sends to ranks ``r + j * k**t`` for
    j = 1..k-1. The j-loop is serialized into sub-rounds (a parent has one
    egress port), matching MPI implementations; for k == 2 this coincides
    with the paper's Eq. 3 round count exactly.
    """
    if k < 2:
        raise ValueError("k must be >= 2")
    rounds = []
    span = 1  # k**t
    while span < n:
        for j in range(1, k):
            transfers = []
            for r in range(span):
                dst = r + j * span
                if dst < n:
                    transfers.append(Transfer(_rot(r, root, n), _rot(dst, root, n)))
            if transfers:
                rounds.append(Round(tuple(transfers)))
        span *= k
    return Schedule(f"knomial{k}", n, root, 1, tuple(rounds))


def binomial(n: int, root: int = 0) -> Schedule:
    sched = knomial(n, root, k=2)
    return dataclasses.replace(sched, name="binomial")


def _is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


def scatter_allgather(n: int, root: int = 0) -> Schedule:
    """Eq. 4 — binomial-tree scatter + ring allgather (bandwidth-optimal).

    Requires power-of-two ``n`` (as the paper's model assumes). The message is
    split into ``n`` chunks; after the scatter, logical rank ``r`` owns chunk
    ``r``; the ring then circulates chunks for ``n - 1`` rounds.
    """
    if not _is_pow2(n):
        raise ValueError(f"scatter_allgather requires power-of-two n, got {n}")
    if n == 1:
        return Schedule("scatter_allgather", n, root, 1, ())
    rounds = []
    # Phase 1: recursive-halving scatter. Owner of block [lo, lo+size) sends
    # the upper half to rank lo + size/2.
    size = n
    while size > 1:
        half = size // 2
        transfers = []
        for lo in range(0, n, size):
            transfers.append(
                Transfer(_rot(lo, root, n), _rot(lo + half, root, n), lo + half, half)
            )
        rounds.append(Round(tuple(transfers)))
        size = half
    # Phase 2: ring allgather. Round s: logical rank r sends chunk (r - s) mod n
    # to (r + 1) mod n.
    for s in range(n - 1):
        transfers = []
        for r in range(n):
            c = (r - s) % n
            transfers.append(Transfer(_rot(r, root, n), _rot((r + 1) % n, root, n), c, 1))
        rounds.append(Round(tuple(transfers)))
    return Schedule("scatter_allgather", n, root, n, tuple(rounds))


def bidirectional_chain(n: int, root: int = 0, num_chunks: int = 8) -> Schedule:
    """BEYOND-PAPER: bidirectional pipelined chain.

    TPU ICI links are full-duplex: the root streams ALL chunks down a
    rightward chain serving logical ranks 1..ceil((n-1)/2) and, concurrently,
    down a leftward chain serving the rest. Each chunk reaches the farthest
    rank in ~(n-1)/2 hops instead of n-1, so the round count drops from
    (M/C + n - 2) to (M/C + ceil((n-1)/2) - 1) — it halves the latency term
    of Eq. 5 while keeping the bandwidth term (both directions carry the
    full message, on disjoint links). The executor issues the two directions
    as separate ppermute lanes within one round.
    """
    if n <= 2:
        return dataclasses.replace(
            pipelined_chain(n, root, num_chunks), name="bidir_chain"
        )
    n_right = (n - 1 + 1) // 2          # logical ranks 1..n_right
    n_left = n - 1 - n_right            # logical ranks n-1 .. n_right+1
    rounds = []
    s = 0
    while True:
        transfers = []
        for j in range(n_right):        # right edge j -> j+1, chunk s-j
            c = s - j
            if 0 <= c < num_chunks:
                transfers.append(Transfer(_rot(j, root, n), _rot(j + 1, root, n), c, 1))
        for j in range(n_left):         # left edge -j -> -(j+1), chunk s-j
            c = s - j
            if 0 <= c < num_chunks:
                transfers.append(
                    Transfer(_rot(-j, root, n), _rot(-(j + 1), root, n), c, 1)
                )
        if not transfers:
            break
        rounds.append(Round(tuple(transfers)))
        s += 1
    return Schedule("bidir_chain", n, root, num_chunks, tuple(rounds))


# ---------------------------------------------------------------------------
# Reduce (paper Sec. VII future work — we provide it for the bcast-sync
# trainer: reduce-to-root is the mirror image of the binomial bcast)
# ---------------------------------------------------------------------------


def binomial_reduce(n: int, root: int = 0) -> Schedule:
    """Reduce-to-root: the binomial bcast schedule reversed, with src/dst
    swapped. Transfers in a round are combined (summed) into the destination."""
    fwd = binomial(n, root)
    rounds = tuple(
        Round(tuple(
            Transfer(t.dst, t.src, t.chunk_start, t.chunk_count, combine=True)
            for t in r.transfers
        ))
        for r in reversed(fwd.rounds)
    )
    return Schedule("binomial_reduce", n, root, 1, rounds, kind="reduce")


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ALGORITHMS: dict[str, Callable[..., Schedule]] = {
    "direct": direct,
    "chain": chain,
    "pipelined_chain": pipelined_chain,
    "bidir_chain": bidirectional_chain,
    "binomial": binomial,
    "knomial": knomial,
    "scatter_allgather": scatter_allgather,
}


def build(name: str, n: int, root: int = 0, **kw) -> Schedule:
    if name not in ALGORITHMS:
        raise KeyError(f"unknown algorithm {name!r}; have {sorted(ALGORITHMS)}")
    sched = ALGORITHMS[name](n, root, **kw)
    sched.validate_ranks()
    return sched
