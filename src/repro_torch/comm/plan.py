"""CollectivePlan: one tuned, inspectable decision + schedule per collective.

A plan is the host-side artifact the consumers (trainer sync, serving weight
distribution, hillclimb, benchmarks) share: which algorithm, how many chunks,
the predicted time, and the concrete schedule — all decided BEFORE tracing,
so the same object can be logged, costed, and executed. This is the "tuned
tables decide every collective" layer of DESIGN.md Sec. 3.
"""
from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict

from ..core import cost_model
from ..core.schedules import LoweredSchedule, Schedule, build, lower_schedule
from ..core.tuner import OPS, RAGGED_OPS, Decision, Tuner, default_tuner
from . import schedules as comm_schedules
from .compress import WireFormat, normalize_wire_format, wire_chunk_bytes

__all__ = [
    "CollectivePlan",
    "plan_collective",
    "plan_cached",
    "plan_cache_clear",
    "cache_stats",
    "decide",
    "expected_wire_bytes",
]

# one-shot baselines (no schedule; one native collective in the reference,
# plain tensor ops over the rank axis in the port),
# and the ops each can legally implement — an op/one-shot mismatch must
# raise like a schedule-based mismatch does (build_op KeyError), not
# silently run the wrong collective
ONE_SHOT = {"xla_psum", "xla_allgather"}
_ONE_SHOT_OPS = {
    "xla_psum": ("bcast", "reduce", "allreduce"),
    "xla_allgather": ("bcast", "allgather"),
}

# ops whose schedules are pinned to num_chunks == n
_N_CHUNK_ALGOS = {
    "scatter_allgather",
    "ring_allreduce",
    "ring_allgather",
    "doubling_allgather",
    "ring_reduce_scatter",
}

_CHAIN_ALGOS = {"pipelined_chain", "bidir_chain", "pipelined_reduce_chain", "fused_rsb"}

# ragged algos: chunking is pinned by the size vector, not swept
_RAGGED_ALGOS = {
    "ring_allgatherv", "doubling_allgatherv", "pairwise_alltoallv", "ring_alltoallv",
}


def _norm_sizes(op: str, sizes, n: int) -> tuple[int, ...] | None:
    """Canonical size vector for cache keys and tuner pricing: a flat tuple
    of non-negative ints (alltoallv matrices flatten row-major)."""
    if sizes is None:
        return None
    if op not in RAGGED_OPS:
        raise ValueError(f"sizes= is only meaningful for {RAGGED_OPS}, not {op!r}")
    if op == "alltoallv":
        m = comm_schedules.alltoallv_matrix(sizes, n)
        return tuple(v for row in m for v in row)
    flat = tuple(int(s) for s in sizes)
    if len(flat) != n:
        raise ValueError(f"allgatherv sizes must have n={n} entries, got {len(flat)}")
    if any(s < 0 for s in flat):
        raise ValueError(f"sizes must be non-negative: {flat}")
    return flat


@dataclasses.dataclass(frozen=True)
class CollectivePlan:
    """A fully-resolved collective: op + decision + executable schedule."""

    op: str
    M: int                      # full logical payload (bytes)
    n: int
    root: int
    inter_pod: bool
    decision: Decision
    schedule: Schedule | None   # None for noop and the one-shot baselines
    # ragged ops: the canonical row-count vector (per rank for allgatherv,
    # per (src, dst) block row-major for alltoallv); None for uniform ops.
    # M == sum(sizes) * row_bytes, so wire accounting stays exact.
    sizes: tuple[int, ...] | None = None

    @property
    def algo(self) -> str:
        return self.decision.algo

    @property
    def num_chunks(self) -> int:
        return self.decision.num_chunks

    @property
    def predicted_s(self) -> float:
        return self.decision.predicted_s

    @property
    def wire_format(self) -> WireFormat:
        return normalize_wire_format(self.decision.wire_format)

    def wire_bytes(self) -> int:
        """Total bytes on the wire across all links (schedule accounting:
        chunk-transfers x actual per-transfer wire size, which under a
        compressed format is the block-padded payload + scale sidecar —
        see :func:`repro_torch.comm.compress.wire_chunk_bytes`). One-shot
        baselines are priced at their native-collective equivalents: psum-bcast =
        2M(n-1)/n-ish ring, gather = n*M; noop = 0. One-shots never
        compress (``decide`` rejects the combination)."""
        if self.schedule is not None:
            chunk_bytes = math.ceil(self.M / max(self.schedule.num_chunks, 1))
            return self.schedule.wire_chunks() * wire_chunk_bytes(
                self.wire_format, chunk_bytes
            )
        if self.algo == "xla_psum":
            return 2 * self.M * (self.n - 1)  # mask + all-reduce (ring both phases)
        if self.algo == "xla_allgather":
            return self.n * self.M
        return 0

    def lowered(self) -> LoweredSchedule | None:
        """Dense round tables for the compiled executor (host-side, cached
        per schedule in ``core.schedules.lower_schedule``)."""
        return None if self.schedule is None else lower_schedule(self.schedule)


def decide(
    op: str,
    M: int,
    n: int,
    *,
    algo: str = "auto",
    num_chunks: int | None = None,
    tuner: Tuner | None = None,
    inter_pod: bool = False,
    sizes=None,
    exec_path: str | None = None,
    wire_format: str | None = None,
) -> Decision:
    """Resolve (op, M, n) to a Decision. ``algo='auto'`` consults the tuner;
    a manual algo gets analytic chunking AND an analytic ``predicted_s`` (so
    manual and auto decisions are comparable in reports — the old bcast path
    returned NaN here). Ragged ops take their row-count vector via
    ``sizes`` (see :meth:`Tuner.select`). An explicit ``exec_path``
    ('inkernel'|'compiled'|'unrolled') pins the executor tier on the
    Decision, overriding whatever the tuner's table carries; an explicit
    ``wire_format`` ('bf16'|'fp8'|'int8') likewise pins what the chunks
    look like on the wire. Compressed formats are scoped to the dense
    schedule-based ops — ragged ops and the XLA one-shots (whose transfers
    we don't own) reject them."""
    if op not in OPS:
        raise ValueError(f"unknown collective op {op!r}; have {OPS}")
    if exec_path is not None and exec_path not in ("inkernel", "compiled", "unrolled"):
        raise ValueError(
            f"exec_path must be 'inkernel'|'compiled'|'unrolled', got {exec_path!r}"
        )
    fmt = normalize_wire_format(wire_format)
    if fmt.compressed:
        if op in RAGGED_OPS:
            raise ValueError(
                f"compressed wire format {fmt.value!r} is not supported for "
                f"ragged op {op!r} (per-rank chunk sizes break the uniform "
                "block accounting)"
            )
        if algo in ONE_SHOT:
            raise ValueError(
                f"one-shot {algo!r} lowers to a native XLA collective — its "
                f"transfers cannot carry wire format {fmt.value!r}"
            )
    if algo in ONE_SHOT and op not in _ONE_SHOT_OPS[algo]:
        raise ValueError(
            f"one-shot {algo!r} cannot implement op {op!r} (valid for {_ONE_SHOT_OPS[algo]})"
        )
    t = tuner or default_tuner()
    sizes = _norm_sizes(op, sizes, n)
    if n <= 1:
        return Decision("noop", 1, max(M, 1), 0.0, "analytic")
    if algo == "auto":
        dec = t.select(M, n, op=op, inter_pod=inter_pod, sizes=sizes)
        if exec_path is not None and dec.algo != "noop":
            dec = dataclasses.replace(dec, exec_path=exec_path)
        if wire_format is not None and dec.algo != "noop":
            if fmt.compressed and dec.algo in ONE_SHOT:
                raise ValueError(
                    f"tuner selected one-shot {dec.algo!r} which cannot carry "
                    f"wire format {fmt.value!r}; pin a schedule-based algo"
                )
            dec = dataclasses.replace(dec, wire_format=fmt.value)
        return dec
    B = t.hw.path_bw(inter_pod)
    if num_chunks is None:
        if algo in _RAGGED_ALGOS:
            num_chunks = max(sum(sizes), 1) if sizes else n
        elif algo in ("pipelined_chain", "bidir_chain", "pipelined_reduce_chain"):
            # per-algorithm analytic chunking (a generic fallback of 8 chunks
            # made a 64-rank chain carry 5x extra fill/drain garbage —
            # EXPERIMENTS.md §Perf pair 3)
            hops = ((n - 1 + 1) // 2 + 1) if algo == "bidir_chain" else n
            c_star = cost_model.optimal_chunk_bytes(M, hops, t.hw, B)
            num_chunks = max(1, min(t.max_chunks, math.ceil(M / c_star)))
        elif algo == "fused_rsb":
            c_star = cost_model.optimal_chunk_bytes_fused(M, n, t.hw, B)
            num_chunks = max(1, min(t.max_chunks, math.ceil(M / c_star)))
        elif algo in _N_CHUNK_ALGOS:
            num_chunks = n
        elif algo == "reduce_then_bcast":
            num_chunks = t.select(M, n, op="bcast", inter_pod=inter_pod).num_chunks
        else:
            num_chunks = 1
    num_chunks = int(num_chunks)
    chunk = math.ceil(M / max(1, num_chunks))
    if algo in cost_model.ALGO_COSTS:
        kw = {"C": float(chunk)} if algo in _CHAIN_ALGOS else {}
        if algo == "reduce_then_bcast":
            inner = t.select(M, n, op="bcast", inter_pod=inter_pod)
            kw = {"t_bcast": inner.predicted_s}
        elif algo in _RAGGED_ALGOS and sizes is not None and sum(sizes) > 0:
            row_bytes = M / sum(sizes)
            kw = {"sizes": [s * row_bytes for s in sizes]}
        predicted = cost_model.cost(algo, M, n, t.hw, inter_pod=inter_pod, **kw)
    else:
        predicted = float("nan")  # one-shot baselines have no Eq. 1-6 model
    return Decision(algo, num_chunks, chunk, predicted, "manual",
                    exec_path=exec_path,
                    wire_format=None if wire_format is None else fmt.value)


def plan_collective(
    op: str,
    M: int,
    n: int,
    *,
    root: int = 0,
    algo: str = "auto",
    num_chunks: int | None = None,
    tuner: Tuner | None = None,
    inter_pod: bool = False,
    sizes=None,
    exec_path: str | None = None,
    wire_format: str | None = None,
) -> CollectivePlan:
    """Decide + build the executable schedule for one collective."""
    sizes = _norm_sizes(op, sizes, n)
    dec = decide(op, M, n, algo=algo, num_chunks=num_chunks, tuner=tuner,
                 inter_pod=inter_pod, sizes=sizes, exec_path=exec_path,
                 wire_format=wire_format)
    t = tuner or default_tuner()
    if dec.algo == "noop" or dec.algo in ONE_SHOT:
        return CollectivePlan(op, M, n, root, inter_pod, dec, None, sizes)
    if op == "bcast":
        kw = {}
        if dec.algo in ("pipelined_chain", "bidir_chain"):
            kw["num_chunks"] = dec.num_chunks
        elif dec.algo == "knomial":
            kw["k"] = t.knomial_k
        sched = build(dec.algo, n, root, **kw)
    elif dec.algo == "reduce_then_bcast":
        inner = decide("bcast", M, n, tuner=tuner, inter_pod=inter_pod)
        if inner.algo in ONE_SHOT or inner.algo == "noop":
            inner = dataclasses.replace(inner, algo="binomial", num_chunks=1)
        kw = {}
        if inner.algo in ("pipelined_chain", "bidir_chain"):
            kw["num_chunks"] = inner.num_chunks
        elif inner.algo == "knomial":
            kw["k"] = t.knomial_k
        bcast_sched = build(inner.algo, n, root, **kw)
        sched = comm_schedules.reduce_then_bcast(n, root, bcast_sched)
        dec = dataclasses.replace(dec, num_chunks=sched.num_chunks,
                                  chunk_bytes=math.ceil(M / max(1, sched.num_chunks)))
    else:
        sched = comm_schedules.build_op(op, dec.algo, n, root,
                                        num_chunks=dec.num_chunks, sizes=sizes)
        if sched.num_chunks != dec.num_chunks:
            dec = dataclasses.replace(dec, num_chunks=sched.num_chunks,
                                      chunk_bytes=math.ceil(M / max(1, sched.num_chunks)))
        if op in RAGGED_OPS:
            sizes = sched.sizes  # the builder's canonical (flattened) vector
    return CollectivePlan(op, M, n, root, inter_pod, dec, sched, sizes)


# ---------------------------------------------------------------------------
# host-side plan cache
#
# Trainers and serving engines resolve the SAME (op, M, n) points every step
# — re-pricing the tuner and re-building (and re-lowering) an identical
# schedule each call is pure host overhead at trace time. The cache key
# carries the tuner's content fingerprint, so any `Tuner.record` /
# `record_overlap` / `calibrate` (a new empirical row, a tuned depth)
# changes the key and stale plans are never replayed after calibration.
# ---------------------------------------------------------------------------

_PLAN_CACHE: "OrderedDict[tuple, CollectivePlan]" = OrderedDict()
_PLAN_CACHE_MAX = 512
_PLAN_CACHE_STATS = {"hits": 0, "misses": 0, "evictions": 0}


def plan_cached(
    op: str,
    M: int,
    n: int,
    *,
    root: int = 0,
    algo: str = "auto",
    num_chunks: int | None = None,
    tuner: Tuner | None = None,
    inter_pod: bool = False,
    sizes=None,
    exec_path: str | None = None,
    stream: str | None = None,
    wire_format: str | None = None,
) -> CollectivePlan:
    """LRU-cached :func:`plan_collective`. Key: (op, M, n, root, algo,
    num_chunks, inter_pod, sizes vector, exec_path, wire_format,
    stream-graph fingerprint, tuner fingerprint). The buffer dtype
    is already folded into ``M`` (a byte count), so same-point calls from
    different dtypes correctly share one plan; ragged plans for different
    size vectors never collide (the canonical flat vector is in the key).
    Plans are frozen and their schedules immutable, so sharing the object
    across callers (and across traced programs) is safe; the pre-lowered
    round tables ride along via ``CollectivePlan.lowered()``'s own cache.

    ``exec_path`` pins the executor tier on the Decision
    (see :func:`decide`); it is a key component so callers pinning
    different tiers never share a plan object. ``stream`` is the opaque
    stream-graph fingerprint from :func:`repro_torch.comm.streams.graph_key`
    — plans resolved inside one graph shape never leak into another (or
    into the stream-less single-collective path, which keys ``None``).

    Hit/miss/eviction counters are observable via :func:`cache_stats`."""
    if exec_path is not None and exec_path not in ("inkernel", "compiled", "unrolled"):
        raise ValueError(
            f"exec_path must be 'inkernel'|'compiled'|'unrolled', got {exec_path!r}"
        )
    t = tuner or default_tuner()
    sizes = _norm_sizes(op, sizes, n)
    key = (
        op,
        int(M),
        int(n),
        int(root),
        algo,
        None if num_chunks is None else int(num_chunks),
        bool(inter_pod),
        sizes,
        exec_path,
        None if wire_format is None else normalize_wire_format(wire_format).value,
        None if stream is None else str(stream),
        t.fingerprint(),
    )
    plan = _PLAN_CACHE.get(key)
    if plan is not None:
        _PLAN_CACHE.move_to_end(key)
        _PLAN_CACHE_STATS["hits"] += 1
        return plan
    _PLAN_CACHE_STATS["misses"] += 1
    plan = plan_collective(
        op, M, n, root=root, algo=algo, num_chunks=num_chunks, tuner=t,
        inter_pod=inter_pod, sizes=sizes, exec_path=exec_path,
        wire_format=wire_format,
    )
    _PLAN_CACHE[key] = plan
    while len(_PLAN_CACHE) > _PLAN_CACHE_MAX:
        _PLAN_CACHE.popitem(last=False)
        _PLAN_CACHE_STATS["evictions"] += 1
    return plan


def cache_stats() -> dict:
    """Snapshot of the plan cache's observability counters: cumulative
    ``hits``/``misses``/``evictions`` since the last
    :func:`plan_cache_clear`, plus current ``size`` and ``maxsize``."""
    return dict(_PLAN_CACHE_STATS, size=len(_PLAN_CACHE), maxsize=_PLAN_CACHE_MAX)


def plan_cache_clear() -> None:
    _PLAN_CACHE.clear()
    _PLAN_CACHE_STATS.update(hits=0, misses=0, evictions=0)


def expected_wire_bytes(op: str, algo: str, M: int, n: int, num_chunks: int = 1,
                        sizes=None, wire_format: str | None = None) -> float:
    """Closed-form bytes-on-wire accounting the property tests check the
    schedule-level accounting (``CollectivePlan.wire_bytes``) against.
    Ragged algos need the row-count vector: wire bytes depend on WHICH ranks
    (blocks) hold the rows, not just the total.

    ``wire_format`` applies :func:`repro_torch.comm.compress.wire_chunk_bytes`
    to every dense transfer: each closed form below is (transfer count) x
    (per-transfer bytes), and compression acts on the per-transfer chunk —
    so the compress-table gate can demand EXACT equality between this form
    and the measured plan accounting. Ragged algos reject compressed
    formats (same scope rule as :func:`decide`)."""
    fmt = normalize_wire_format(wire_format)
    if n <= 1 or algo == "noop":
        return 0.0
    if algo in _RAGGED_ALGOS:
        if fmt.compressed:
            raise ValueError(
                f"compressed wire format {fmt.value!r} is not supported for "
                f"ragged algo {algo!r}"
            )
        sizes = _norm_sizes(op, sizes, n) if sizes is not None else None
        if sizes is None or sum(sizes) == 0:
            return 0.0
        row = M / sum(sizes)
        if algo == "ring_allgatherv":
            # every segment crosses n-1 ring edges
            return (n - 1) * sum(sizes) * row
        if algo == "doubling_allgatherv":
            # round t: each of the 2^t ranks holding a contiguous group of
            # 2^t segments sends it to its partner
            total, span = 0, 1
            while span < n:
                for base in range(0, n, span):
                    total += span * sum(sizes[base:min(base + span, n)])
                span *= 2
            return total * row
        m = comm_schedules.alltoallv_matrix(
            tuple(sizes[r * n:(r + 1) * n] for r in range(n))
            if len(sizes) == n * n else sizes, n)
        if algo == "pairwise_alltoallv":
            # every off-diagonal block crosses the wire exactly once
            return sum(m[s][d] for s in range(n) for d in range(n) if s != d) * row
        if algo == "ring_alltoallv":
            # store-and-forward: each block pays its hop count
            return sum(
                m[s][d] * ((d - s) % n) for s in range(n) for d in range(n)
            ) * row
    # every dense form is (transfer count) x (per-transfer chunk bytes);
    # the wire format transforms the per-transfer size, never the count
    chunk = math.ceil(M / max(1, num_chunks))
    share = math.ceil(M / n)
    if algo == "scatter_allgather":
        # (n/2)*log2(n) scatter chunk-sends + n*(n-1) ring chunk-sends
        count, per = (n // 2) * int(math.log2(n)) + n * (n - 1), share
    elif algo in ("ring_allgather", "ring_reduce_scatter"):
        count, per = n * (n - 1), share
    elif algo == "doubling_allgather":
        count, per = n * (n - 1), share  # sum_t n * 2^t = n (n - 1)
    elif algo == "ring_allreduce":
        count, per = 2 * n * (n - 1), share
    elif algo == "fused_rsb":
        count, per = 2 * (n - 1) * num_chunks, chunk
    elif algo == "reduce_then_bcast":
        raise ValueError("composite: account the two phases separately")
    else:
        # every tree/chain bcast (and its reduce mirror) moves the full
        # message over exactly n-1 edges
        count, per = (n - 1) * num_chunks, chunk
    return count * wire_chunk_bytes(fmt, per)
