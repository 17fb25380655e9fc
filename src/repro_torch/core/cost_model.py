"""Analytical cost models for broadcast algorithms (paper Sec. III, Eqs. 1-6).

Notation follows Table I of the paper:
    M   message size (bytes)
    C   chunk size (bytes)
    B   link bandwidth (bytes/s)
    n   number of ranks
    t_s startup time per transfer

The port carries the closed forms the tuner prices with. Its default
hardware profile is :data:`H100_SXM`; a caller that wants another machine's
constants builds a :class:`Hardware` and passes it in.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

__all__ = [
    "Hardware",
    "H100_SXM",
    "CPU_SIM",
    "calibrate_t_launch",
    "cost",
    "cost_degraded",
    "degraded_bandwidth",
    "cost_wire",
    "LinkClass",
    "calibrate_link_classes",
    "cost_link_class",
    "WIRE_PAYLOAD_FRACTION",
    "optimal_chunk_bytes",
    "optimal_chunk_bytes_fused",
    "skew_ratio",
    "t_exec_path",
    "t_bucketed_barrier",
    "multi_stream_finish_times",
    "window_finish_times",
    "t_overlapped",
    "optimal_overlap_depth",
    "ALGO_COSTS",
]


@dataclasses.dataclass(frozen=True)
class Hardware:
    """Fabric constants used by the analytic model and the tuner."""

    name: str
    ts: float            # startup latency per transfer (s)
    link_bw: float       # per-link bandwidth inside a node (bytes/s)
    interpod_bw: float   # per-link bandwidth across nodes (bytes/s)
    host_bw: float       # host staging path ("B_PCIe", bytes/s)
    peak_flops: float    # per chip, bf16 dense
    hbm_bw: float        # per chip
    # per kernel-launch overhead (s): what each round of a host-mediated
    # executor pays at the launch boundary
    t_launch: float = 5e-6

    def path_bw(self, inter_pod: bool) -> float:
        return self.interpod_bw if inter_pod else self.link_bw


# NVIDIA H100 SXM5 80 GB.
#   peak_flops, hbm_bw: NVIDIA's H100 data sheet (dense bf16 989 TFLOP/s,
#     HBM3 3.35 TB/s).
#   link_bw: NVLink 4, 900 GB/s per card to the other cards of the host,
#     450 GB/s each way (data sheet) — what one hop of a node's chain sees.
#   interpod_bw: one 400 Gb/s NDR InfiniBand port (50 GB/s) per card, the
#     DGX H100 node-to-node layout.
#   host_bw: PCIe Gen5 x16, 64 GB/s each way.
#   ts, t_launch: measured by ``chip_smoke.py`` (its "calibrate" line) on an
#     NVIDIA H100 80GB HBM3 at a 700 W power limit: ts is one emulated
#     point-to-point transfer of a 1 KiB block between two ranks of the
#     one-card mesh, t_launch one launch of the fused_combine kernel on a
#     1 KiB block. Both are launch-bound on that machine.
#   So ts is the emulation's per-transfer overhead (a host-issued row copy
#   on one card), NOT the startup of an NVLink hop, while link_bw is the
#   NVLink rate: the chunk counts this profile gives price neither the real
#   fabric nor the emulation. Re-measure ts over the multi-GPU backend
#   (ROADMAP item "Multi-GPU backend") once it exists.
H100_SXM = Hardware(
    name="h100_sxm",
    ts=2.327e-05,
    link_bw=450e9,
    interpod_bw=50e9,
    host_bw=64e9,
    peak_flops=989e12,
    hbm_bw=3.35e12,
    t_launch=2.841e-05,
)


# Constants for interpreting CPU microbenchmarks (used only to sanity-check
# measured-vs-model shape agreement; absolute values are calibrated at
# runtime). The reference's values.
CPU_SIM = Hardware(
    name="cpu_sim",
    ts=50e-6,
    link_bw=8e9,
    interpod_bw=2e9,
    host_bw=8e9,
    peak_flops=1e11,
    hbm_bw=2e10,
    t_launch=100e-6,
)


def _fit_line(pts) -> tuple[float | None, float, float]:
    """Least-squares slope of the ``(x, y)`` points and the means of x and
    y; the slope is None when every x is the same."""
    xs, ys = zip(*pts)
    mx, my = sum(xs) / len(xs), sum(ys) / len(ys)
    den = sum((x - mx) ** 2 for x in xs)
    if den <= 0:
        return None, mx, my
    return sum((x - mx) * (y - my) for x, y in pts) / den, mx, my


def calibrate_t_launch(table: dict) -> float:
    """Per-round launch overhead (s/round) from a table keyed
    ``n<r>/<op>/<algo>/K<k>`` whose entries carry ``num_rounds`` and
    ``unrolled_lower_s`` (the reference's compile-table format).

    Each (n, op, algo) group that sweeps several chunk counts gives
    (num_rounds, seconds) pairs; the least-squares slope of each multi-K
    group is that group's per-round cost, and the result is the median
    across groups. ``chip_smoke.py`` fills such a table on the card with
    the host seconds of compiled replays under the same field name.
    """
    groups: dict[tuple, list[tuple[float, float]]] = {}
    for key, e in table.items():
        parts = key.split("/")
        if len(parts) != 4:
            continue
        groups.setdefault(tuple(parts[:3]), []).append(
            (float(e["num_rounds"]), float(e["unrolled_lower_s"]))
        )
    slopes = [fit[0] for pts in groups.values()
              if len(pts) >= 2 and (fit := _fit_line(pts))[0] is not None]
    if not slopes:
        raise ValueError(
            "calibrate_t_launch: table has no multi-K group to fit a slope on"
        )
    slopes.sort()
    mid = len(slopes) // 2
    return slopes[mid] if len(slopes) % 2 else 0.5 * (slopes[mid - 1] + slopes[mid])


def t_exec_path(path: str, num_rounds: int, num_classes: int, hw: Hardware) -> float:
    """Launch-boundary overhead of one executor choice (s), added to the
    wire-time closed forms:

      * ``unrolled`` — one exchange and one merge per lane class per round;
      * ``compiled`` — a gather and a merge launch per round;
      * ``inkernel`` — one launch for the whole schedule.
    """
    rounds = max(int(num_rounds), 0)
    classes = max(int(num_classes), 1)
    if path == "inkernel":
        return hw.t_launch
    if path == "compiled":
        return 2.0 * rounds * hw.t_launch
    if path == "unrolled":
        return 2.0 * rounds * classes * hw.t_launch
    raise ValueError(f"exec path must be 'inkernel'|'compiled'|'unrolled', got {path!r}")


# ---------------------------------------------------------------------------
# Closed forms, Eqs. 1-6
# ---------------------------------------------------------------------------


def t_direct(M: float, n: int, hw: Hardware, B: float) -> float:
    """Eq. 1: T = n * (ts + M/B). (Paper keeps the n factor; the root's n-1
    serialized sends plus the initiation round-off.)"""
    return n * (hw.ts + M / B)


def t_chain(M: float, n: int, hw: Hardware, B: float) -> float:
    """Eq. 2: T = (n-1) * (ts + M/B)."""
    return (n - 1) * (hw.ts + M / B)


def t_knomial(M: float, n: int, hw: Hardware, B: float, k: int = 2, multiport: bool = False) -> float:
    """Eq. 3: T = ceil(log_k n) * (ts + M/B) (multiport idealization).

    Our executor serializes a parent's k-1 child sends (single egress port),
    so the default prices (k-1)*ceil(log_k n) rounds; for k=2 both agree.
    """
    if n <= 1:
        return 0.0
    steps = math.ceil(math.log(n, k))
    if not multiport:
        steps *= k - 1
    return steps * (hw.ts + M / B)


def t_scatter_allgather(M: float, n: int, hw: Hardware, B: float) -> float:
    """Eq. 4: (ceil(log2 n) + n - 1) * ts + 2*(n-1)/n * M/B."""
    if n <= 1:
        return 0.0
    return (math.ceil(math.log2(n)) + n - 1) * hw.ts + 2.0 * (n - 1) / n * M / B


def t_pipelined_chain(M: float, n: int, hw: Hardware, B: float, C: float | None = None) -> float:
    """Eq. 5: T = (M/C + n - 2) * (ts + C/B), the paper's proposed design."""
    if n <= 1:
        return 0.0
    if C is None:
        C = optimal_chunk_bytes(M, n, hw, B)
    C = min(max(C, 1.0), M)
    num_chunks = math.ceil(M / C)
    return (num_chunks + max(n - 2, 0)) * (hw.ts + C / B)


def t_bidir_chain(M: float, n: int, hw: Hardware, B: float, C: float | None = None) -> float:
    """BEYOND-PAPER: bidirectional pipelined chain over full-duplex links —
    both directions carry the full message concurrently, so the chunk
    pipeline only has to cover ceil((n-1)/2) hops:
        T = (M/C + ceil((n-1)/2) - 1) * (ts + C/B)."""
    if n <= 2:
        return t_pipelined_chain(M, n, hw, B, C=C)
    hops = (n - 1 + 1) // 2
    if C is None:
        C = optimal_chunk_bytes(M, hops + 1, hw, B)
    C = min(max(C, 1.0), M)
    num_chunks = math.ceil(M / C)
    return (num_chunks + max(hops - 1, 0)) * (hw.ts + C / B)


def t_knomial_staged(M: float, n: int, hw: Hardware, B: float, k: int = 2) -> float:
    """Eq. 6: host-staged k-nomial: M/B_host + ceil(log_k n) * (ts + M/B)."""
    return M / hw.host_bw + t_knomial(M, n, hw, B, k=k)


def optimal_chunk_bytes(M: float, n: int, hw: Hardware, B: float) -> float:
    """Analytic minimizer of Eq. 5 over C:

        d/dC [(M/C + n-2)(ts + C/B)] = -M*ts/C^2 + (n-2)/B = 0
        =>  C* = sqrt(M * ts * B / (n - 2))

    For n <= 2 the chain is a single hop and chunking only adds startup
    cost, so C* = M.
    """
    if n <= 2 or M <= 0:
        return float(max(M, 1))
    c = math.sqrt(M * hw.ts * B / (n - 2))
    return float(min(max(c, 1.0), M))


# ---------------------------------------------------------------------------
# Non-bcast collectives (repro_torch.comm): closed forms for the per-op tuner.
# M is always the FULL logical buffer (the bcast payload, the allreduce
# gradient, the gathered allgather output) — shard sizes are M/n.
# ---------------------------------------------------------------------------


def t_fused_rsb(M: float, n: int, hw: Hardware, B: float, C: float | None = None) -> float:
    """Fused pipelined reduce-chain + bcast-chain allreduce ("fused_rsb").

    Chunk c is fully reduced at the chain head after n-1 hops and is
    immediately streamed back down while later chunks are still reducing, so
    the two phases overlap on the full-duplex links:

        T = (M/C + 2n - 3) * (ts + C/B)
    """
    if n <= 1:
        return 0.0
    if C is None:
        C = optimal_chunk_bytes_fused(M, n, hw, B)
    C = min(max(C, 1.0), M)
    num_chunks = math.ceil(M / C)
    return (num_chunks + max(2 * n - 3, 0)) * (hw.ts + C / B)


def optimal_chunk_bytes_fused(M: float, n: int, hw: Hardware, B: float) -> float:
    """Minimizer of t_fused_rsb over C: C* = sqrt(M * ts * B / (2n - 3))."""
    if n <= 1 or M <= 0:
        return float(max(M, 1))
    c = math.sqrt(M * hw.ts * B / max(2 * n - 3, 1))
    return float(min(max(c, 1.0), M))


def t_reduce_then_bcast(M: float, n: int, hw: Hardware, B: float, t_bcast: float | None = None) -> float:
    """Two-phase allreduce: reversed-binomial reduce-to-root, barrier, then
    the tuned broadcast (``t_bcast``; defaults to the binomial tree)."""
    if n <= 1:
        return 0.0
    t_reduce = t_knomial(M, n, hw, B, k=2)
    if t_bcast is None:
        t_bcast = t_knomial(M, n, hw, B, k=2)
    return t_reduce + t_bcast


def t_ring_allreduce(M: float, n: int, hw: Hardware, B: float) -> float:
    """Bandwidth-optimal ring: reduce-scatter (n-1 rounds) + allgather
    (n-1 rounds), each round moving one M/n chunk per rank."""
    if n <= 1:
        return 0.0
    return 2 * (n - 1) * (hw.ts + math.ceil(M / n) / B)


def t_ring_allgather(M: float, n: int, hw: Hardware, B: float) -> float:
    """Ring allgather: n-1 rounds of one M/n chunk per rank (any n)."""
    if n <= 1:
        return 0.0
    return (n - 1) * (hw.ts + math.ceil(M / n) / B)


def t_doubling_allgather(M: float, n: int, hw: Hardware, B: float) -> float:
    """Recursive-doubling allgather (power-of-two n): log2(n) rounds whose
    payload doubles each round — same bytes as the ring, log startups."""
    if n <= 1:
        return 0.0
    return math.ceil(math.log2(n)) * hw.ts + (n - 1) / n * M / B


def t_ring_reduce_scatter(M: float, n: int, hw: Hardware, B: float) -> float:
    """Ring reduce-scatter: n-1 combining rounds of one M/n chunk per rank."""
    if n <= 1:
        return 0.0
    return (n - 1) * (hw.ts + math.ceil(M / n) / B)


# ---------------------------------------------------------------------------
# Ragged collectives (allgatherv / alltoallv). ``sizes`` is the per-rank (or
# per-block) payload in BYTES; ``None`` prices the uniform M/n (M/n^2) split,
# which collapses every form below to its uniform counterpart. The skew term
# max(sizes) vs sum(sizes) is what inverts the ring/pairwise decision — the
# regime the Allgatherv study (arXiv:1812.05964) measures.
# ---------------------------------------------------------------------------


def skew_ratio(sizes: Sequence[float]) -> float:
    """max(sizes) / mean(sizes) — 1.0 for uniform, up to len(sizes) for a
    single hot rank. The tuner buckets empirical keys on log2 of this."""
    sizes = [float(s) for s in sizes]
    total = sum(sizes)
    if not sizes or total <= 0:
        return 1.0
    return max(sizes) * len(sizes) / total


def _gatherv_sizes(M: float, n: int, sizes: Sequence[float] | None) -> list[float]:
    if sizes is None:
        return [M / max(n, 1)] * n
    return [float(s) for s in sizes]


def _a2av_matrix(M: float, n: int, sizes: Sequence[float] | None) -> list[list[float]]:
    if sizes is None:
        b = M / max(n * n, 1)
        return [[b] * n for _ in range(n)]
    flat = [float(s) for s in sizes]
    if len(flat) == n:          # per-destination vector, uniform across sources
        return [list(flat) for _ in range(n)]
    if len(flat) == n * n:
        return [flat[r * n:(r + 1) * n] for r in range(n)]
    raise ValueError(f"alltoallv sizes must have n or n*n entries, got {len(flat)}")


def t_ring_allgatherv(M: float, n: int, hw: Hardware, B: float,
                      sizes: Sequence[float] | None = None) -> float:
    """Ring allgatherv: n-1 neighbor rounds, but EVERY round is gated by the
    largest segment in flight somewhere on the ring:

        T = (n - 1) * (ts + max(sizes)/B)

    Uniform sizes recover t_ring_allgather; under skew the cost is keyed on
    max(sizes) while the wire total is keyed on sum(sizes) — the ring's
    bandwidth optimality evaporates as skew grows."""
    if n <= 1:
        return 0.0
    sz = _gatherv_sizes(M, n, sizes)
    return (n - 1) * (hw.ts + max(sz) / B)


def t_doubling_allgatherv(M: float, n: int, hw: Hardware, B: float,
                          sizes: Sequence[float] | None = None) -> float:
    """Recursive-doubling allgatherv: log2(n) rounds, round t gated by the
    largest contiguous group of 2^t segments.

    Unlike the switch-fabric ``t_doubling_allgather`` (the paper's IB
    cluster, where any pair is one hop), the ragged variant prices the
    ring-embedded fabric: a distance-2^t exchange occupies 2^t
    consecutive links, dividing per-link bandwidth by the hop count. Under
    uniform sizes the quadratic hop-weighted bytes lose to the ring; under
    skew the hot segment pays its (n-1) hop-bytes either way and doubling
    wins back (n-1) - log2(n) startups — the inversion the tuner keys on."""
    if n <= 1:
        return 0.0
    sz = _gatherv_sizes(M, n, sizes)
    t, span = 0.0, 1
    while span < n:
        worst = 0.0
        for base in range(0, n, span):
            worst = max(worst, sum(sz[base:min(base + span, n)]))
        if worst > 0:
            t += hw.ts + min(span, n - span) * worst / B
        span *= 2
    return t


def t_pairwise_alltoallv(M: float, n: int, hw: Hardware, B: float,
                         sizes: Sequence[float] | None = None) -> float:
    """Pairwise-exchange alltoallv: n-1 steps, step s gated by the largest
    (r -> r+s) block; every block crosses the wire once, but a step of ring
    distance d occupies d consecutive ring links (hop-weighted bandwidth,
    as in :func:`t_doubling_allgatherv`). Hot-destination (incast) skew
    makes the far steps carry the hot block over their full distance —
    the regime where the store-and-forward ring wins."""
    if n <= 1:
        return 0.0
    m = _a2av_matrix(M, n, sizes)
    t = 0.0
    for s in range(1, n):
        worst = max(m[r][(r + s) % n] for r in range(n))
        if worst > 0:
            t += hw.ts + min(s, n - s) * worst / B
    return t


def t_ring_alltoallv(M: float, n: int, hw: Hardware, B: float,
                     sizes: Sequence[float] | None = None) -> float:
    """Store-and-forward ring alltoallv: n-1 neighbor rounds; round t is
    gated by the heaviest edge, which carries every not-yet-delivered block
    whose current holder feeds that edge. Each block pays its hop count in
    wire bytes, so hot blocks far from their destination hurt most."""
    if n <= 1:
        return 0.0
    m = _a2av_matrix(M, n, sizes)
    t = 0.0
    for step in range(n - 1):
        worst = 0.0
        for r in range(n):
            s = (r - step) % n
            load = sum(m[s][d] for d in range(n) if (d - s) % n > step)
            worst = max(worst, load)
        if worst > 0:
            t += hw.ts + worst / B
    return t


# ---------------------------------------------------------------------------
# Compute/communication overlap (the CNTK end-to-end regime, paper Sec. V-D):
# bucketed gradient sync pipelined against backward compute. These price
# *schedules of* collectives — the overlap engine (repro_torch.comm.overlap) feeds
# them per-bucket times from CollectivePlans.
# ---------------------------------------------------------------------------


def t_bucketed_barrier(
    bucket_comm_s: Sequence[float],
    compute_s: float,
    stage_s: Sequence[float] | None = None,
) -> float:
    """Barrier schedule: ALL compute, then ALL staging, then every bucket's
    collective back-to-back (what ``pallreduce_tree`` runs). The
    network idles for the whole compute phase."""
    stage = sum(stage_s) if stage_s is not None else 0.0
    return float(compute_s) + stage + float(sum(bucket_comm_s))


def multi_stream_finish_times(
    streams: Sequence[dict],
    *,
    starvation_bound: int | None = None,
    trace: list | None = None,
) -> list:
    """THE link-scheduler recurrence — the multi-stream generalization of the
    single-stream in-flight-window timeline. Every contending stream is a dict:

        avail     per-bucket earliest availability times (compute gating)
        stage     per-bucket staging costs (off-link; pack / chunked_copy)
        comm      per-bucket link occupancy — a scalar (the bucket is one
                  indivisible transfer) or a sequence of round quanta (the
                  scheduler may preempt the stream between quanta: 'priority
                  preemption points at round boundaries')
        depth     in-flight window depth (default 1): bucket k's staging
                  waits for comm_end[k - depth]
        priority  higher wins contended dispatches (default 0)
        link      name of the serial resource the stream occupies
                  (default "net"); different links never contend
        after     indices of streams that must FULLY finish before this
                  stream's first bucket may stage (DAG edges)

    Arbitration, per link: a transfer may dispatch at
    ``t = max(link_free, min(ready))`` over that link's pending quanta —
    the link never idles while any transfer is ready (no-idle property).
    Among the quanta ready by ``t``, the highest-priority stream wins
    (ties: latest-ready loses, then lower stream index wins) UNLESS some
    eligible stream has already been passed over ``starvation_bound``
    times — then the most-starved stream is forced (fairness property:
    with S contending streams no stream is passed over more than
    ``starvation_bound + S - 2`` consecutive times; exact bound for
    S == 2). ``starvation_bound=None`` disables aging (pure priority).

    Works on any numeric type (floats or integer rounds). Returns the
    per-stream per-bucket comm finish times. With ONE stream this reduces
    exactly to the single-stream recurrence (:func:`window_finish_times`):

        stage_k starts at max(avail_k, comm_end_{k-depth})   (free slot)
        comm_k  starts at max(stage-end_k, comm_end_{k-1})   (serial net)

    If ``trace`` is a list, one record per dispatched quantum is appended
    (stream, bucket, quantum, start, end, link, link_free, min_ready,
    contenders) in commit order — the replay schedule consumers execute.
    """
    S = len(streams)
    quanta: list[list[list]] = []
    nbuckets: list[int] = []
    depth: list[int] = []
    prio: list = []
    link: list[str] = []
    after: list[tuple[int, ...]] = []
    for st in streams:
        qs = [list(c) if isinstance(c, (list, tuple)) else [c] for c in st["comm"]]
        if any(not q for q in qs):
            raise ValueError("every bucket needs >= 1 comm quantum")
        quanta.append(qs)
        nbuckets.append(len(qs))
        depth.append(max(1, min(int(st.get("depth", 1)), max(len(qs), 1))))
        prio.append(st.get("priority", 0))
        link.append(str(st.get("link", "net")))
        deps = tuple(int(d) for d in st.get("after", ()))
        if any(d < 0 or d >= S for d in deps):
            raise ValueError(f"'after' index out of range: {deps}")
        after.append(deps)
    comm_end: list[list] = [[0] * nbuckets[s] for s in range(S)]
    nk = [0] * S   # next bucket per stream
    nq = [0] * S   # next quantum within that bucket
    qend = [0] * S  # end time of the stream's previous quantum
    link_free: dict = {}
    skips = [0] * S
    while True:
        pend: dict[str, list] = {}
        active = False
        for s in range(S):
            if nk[s] >= nbuckets[s]:
                continue
            active = True
            if any(nk[d] < nbuckets[d] for d in after[s]):
                continue  # upstream stream still draining
            k = nk[s]
            if nq[s] == 0:
                dep_done = 0
                for d in after[s]:
                    if nbuckets[d]:
                        dep_done = max(dep_done, comm_end[d][-1])
                slot_free = comm_end[s][k - depth[s]] if k >= depth[s] else 0
                ready = max(streams[s]["avail"][k], slot_free, dep_done) + streams[s]["stage"][k]
            else:
                ready = qend[s]  # mid-bucket: back-to-back quanta
            pend.setdefault(link[s], []).append((ready, s))
        if not pend:
            if active:
                raise ValueError("stream deadlock: cycle in 'after' edges")
            break
        best = None
        for ln in sorted(pend):
            cands = pend[ln]
            lfree = link_free.get(ln, 0)
            t = max(lfree, min(r for r, _ in cands))
            elig = [s for r, s in cands if r <= t]
            ready_of = {s: r for r, s in cands}
            starved = [
                s for s in elig
                if starvation_bound is not None and skips[s] >= starvation_bound
            ]
            pool = starved or elig
            if starved:
                chosen = max(pool, key=lambda s: (skips[s], prio[s], -s))
            else:
                chosen = max(pool, key=lambda s: (prio[s], -ready_of[s], -s))
            if best is None or (t, ln) < (best[0], best[1]):
                best = (t, ln, lfree, ready_of, chosen, elig)
        t, ln, lfree, ready_of, s, elig = best
        end = t + quanta[s][nk[s]][nq[s]]
        link_free[ln] = end
        qend[s] = end
        for o in elig:
            skips[o] = 0 if o == s else skips[o] + 1
        if trace is not None:
            trace.append({
                "stream": s, "bucket": nk[s], "quantum": nq[s],
                "start": t, "end": end, "link": ln,
                "link_free": lfree, "min_ready": min(ready_of.values()),
                "ready": ready_of[s], "contenders": len(elig),
                "skips": max(skips) if skips else 0,
            })
        nq[s] += 1
        if nq[s] >= len(quanta[s][nk[s]]):
            comm_end[s][nk[s]] = end
            nk[s] += 1
            nq[s] = 0
    return comm_end


def window_finish_times(
    avail: Sequence,
    stage: Sequence,
    comm: Sequence,
    depth: int,
) -> list:
    """The greedy in-flight-window recurrence both :func:`t_overlapped`
    (seconds) and the round simulator (``repro_torch.comm.streams``, integer
    rounds) drain through. Since the stream refactor this is literally the
    1-stream case of :func:`multi_stream_finish_times` — kept as the named
    entry point so the analytic depth tuner, the round accounting, and the
    multi-stream arbiter can never drift apart. Per bucket k (dispatch
    order):

        stage_k starts at max(avail_k, comm_end_{k-depth})   (free slot)
        comm_k  starts at max(stage-end_k, comm_end_{k-1})   (serial net)

    Works on any numeric type (floats or integer rounds). Returns the
    per-bucket comm finish times.
    """
    return multi_stream_finish_times(
        [{"avail": avail, "stage": stage, "comm": comm, "depth": depth}]
    )[0]


def t_overlapped(
    bucket_comm_s: Sequence[float],
    compute_s: float,
    *,
    depth: int = 2,
    stage_s: Sequence[float] | None = None,
) -> float:
    """Overlapped (bucket-streamed) schedule: greedy timeline estimate.

    Buckets are listed in DISPATCH order (backward-order streaming — the
    DDP/Horovod pattern). Bucket k's gradient becomes available a fraction
    (k+1)/K through the backward pass; staging (pack / ``chunked_copy``)
    needs a free slot in the ``depth``-deep in-flight window (the double/
    multi-buffer the consumer allocates), and the serialized network drains
    staged buckets in dispatch order (:func:`window_finish_times`).

    ``depth`` only buys time when staging is non-free: depth 1 serializes
    stage and comm, depth 2 is classic double buffering, deeper windows hide
    staging bursts at the cost of one live bucket buffer each. Returns the
    finish time of the last bucket's collective.
    """
    K = len(bucket_comm_s)
    if K == 0:
        return float(compute_s)
    avail = [compute_s * (k + 1) / K for k in range(K)]
    stage = list(stage_s) if stage_s is not None else [0.0] * K
    return float(window_finish_times(avail, stage, bucket_comm_s, depth)[-1])


def optimal_overlap_depth(
    bucket_comm_s: Sequence[float],
    compute_s: float,
    *,
    stage_s: Sequence[float] | None = None,
    max_depth: int = 8,
) -> int:
    """Smallest in-flight window minimizing :func:`t_overlapped` (ties go to
    the shallower window — each extra depth is a live staged bucket buffer)."""
    K = len(bucket_comm_s)
    if K <= 1:
        return 1
    best_d, best_t = 1, float("inf")
    for d in range(1, min(max_depth, K) + 1):
        t = t_overlapped(bucket_comm_s, compute_s, depth=d, stage_s=stage_s)
        if t < best_t * (1.0 - 1e-12):
            best_d, best_t = d, t
    return best_d


def t_nccl_ring(M: float, n: int, hw: Hardware, B: float, slice_bytes: float = 256 << 10) -> float:
    """The NCCL-stand-in baseline: a pipelined ring with a FIXED slice size
    and no algorithm switching (what NCCL 1.x broadcast does). At small M the
    (n-1) serial hops of ``t_s`` dominate — the regime where the paper
    reports 14x/16.6x wins for the tuned library."""
    if n <= 1:
        return 0.0
    C = min(max(slice_bytes, 1.0), M)
    num_chunks = math.ceil(M / C)
    return (num_chunks + max(n - 2, 0)) * (hw.ts + C / B)


ALGO_COSTS = {
    "nccl_ring": t_nccl_ring,
    "direct": t_direct,
    "chain": t_chain,
    "binomial": lambda M, n, hw, B: t_knomial(M, n, hw, B, k=2),
    "knomial": t_knomial,
    "knomial_staged": t_knomial_staged,
    "scatter_allgather": t_scatter_allgather,
    "pipelined_chain": t_pipelined_chain,
    "bidir_chain": t_bidir_chain,
    # reduce mirrors (same round structure, reversed)
    "binomial_reduce": lambda M, n, hw, B: t_knomial(M, n, hw, B, k=2),
    "pipelined_reduce_chain": t_pipelined_chain,
    # allreduce / allgather / reduce_scatter (repro_torch.comm ops)
    "reduce_then_bcast": t_reduce_then_bcast,
    "fused_rsb": t_fused_rsb,
    "ring_allreduce": t_ring_allreduce,
    "ring_allgather": t_ring_allgather,
    "doubling_allgather": t_doubling_allgather,
    "ring_reduce_scatter": t_ring_reduce_scatter,
    # ragged ops (skew-aware; sizes in bytes via cost(..., sizes=...))
    "ring_allgatherv": t_ring_allgatherv,
    "doubling_allgatherv": t_doubling_allgatherv,
    "pairwise_alltoallv": t_pairwise_alltoallv,
    "ring_alltoallv": t_ring_alltoallv,
}


def cost(algo: str, M: float, n: int, hw: Hardware = H100_SXM, *, inter_pod: bool = False, **kw) -> float:
    """Predicted latency (s) of ``algo`` for an M-byte bcast over n ranks."""
    B = hw.path_bw(inter_pod)
    return ALGO_COSTS[algo](M, n, hw, B, **kw)


def worst_link_factor(slow_links) -> float:
    """Worst per-link slowdown factor in a health report (>= 1.0).

    ``slow_links`` is a {(src, dst): factor} mapping or an iterable of
    ((src, dst), factor) pairs. Every schedule serializes rounds, so the
    whole collective is gated by its slowest active link: the bandwidth
    term of a closed form degrades by exactly this factor."""
    items = list(slow_links.values()) if isinstance(slow_links, dict) else [
        f for _pair, f in slow_links
    ]
    if not items:
        return 1.0
    return max(1.0, max(float(f) for f in items))


def degraded_bandwidth(B: float, slow_links) -> float:
    """Effective per-link bandwidth once the worst reported slowdown gates
    the round clock."""
    return B / worst_link_factor(slow_links)


def cost_degraded(algo: str, M: float, n: int, hw: Hardware = H100_SXM, *,
                  inter_pod: bool = False, slow_links=(), **kw) -> float:
    """:func:`cost` under a degraded-link health report: the same closed
    form, evaluated at :func:`degraded_bandwidth`. With an empty report this
    is exactly ``cost``, so replanning on a health transition re-ranks
    algorithms only for a reason."""
    B = degraded_bandwidth(hw.path_bw(inter_pod), slow_links)
    return ALGO_COSTS[algo](M, n, hw, B, **kw)


# ---------------------------------------------------------------------------
# compressed wire formats: bytes-vs-precision pricing
# ---------------------------------------------------------------------------

# wire payload per full-precision byte (f32 wire domain): compressed
# formats ship one byte per 4-byte element plus one f32 scale per
# 256-element block — 260 wire bytes per 1024 payload bytes
# (``comm.compress.wire_chunk_bytes`` before the block-padding ceil)
WIRE_PAYLOAD_FRACTION = {
    "bf16": 1.0,
    "fp8": 260.0 / 1024.0,
    "int8": 260.0 / 1024.0,
}

# HBM passes each compressed hop adds on top of the transfer itself: the
# sender reads the block and writes the payload, the receiver reads the
# payload and writes the block back — ~2 full-size passes, charged once
# against the whole message
_QUANTIZE_HBM_PASSES = 2.0


def cost_wire(
    algo: str,
    M: float,
    n: int,
    hw: Hardware = H100_SXM,
    *,
    wire_format: str | None = None,
    inter_pod: bool = False,
    **kw,
) -> float:
    """:func:`cost` under a wire format: the closed form at the format's
    wire payload (bandwidth terms shrink by the compression fraction;
    startup and round terms are unchanged) plus the quantize/dequantize
    HBM toll. ``bf16``/``None`` is exactly ``cost``. The
    :class:`~repro_torch.core.tuner.OnlineTuner` prices its arms with it."""
    fmt = wire_format or "bf16"
    if fmt not in WIRE_PAYLOAD_FRACTION:
        raise ValueError(
            f"unknown wire format {fmt!r}; have {sorted(WIRE_PAYLOAD_FRACTION)}"
        )
    frac = WIRE_PAYLOAD_FRACTION[fmt]
    if "C" in kw:
        kw = dict(kw, C=max(kw["C"] * frac, 1.0))
    t = ALGO_COSTS[algo](M * frac, n, hw, hw.path_bw(inter_pod), **kw)
    if frac < 1.0:
        t += _QUANTIZE_HBM_PASSES * M / hw.hbm_bw
    return t


@dataclasses.dataclass(frozen=True)
class LinkClass:
    """One calibrated link class: a (bandwidth, startup) pair for a set of
    physically alike links. Asymmetric and multi-rail topologies are
    distinct class names ('nvlink', 'host', 'rail0:up', ...)."""

    name: str
    bw: float  # bytes/s
    ts: float  # per-transfer startup (s)


def calibrate_link_classes(
    samples: dict[str, Sequence[tuple[float, float]]]
) -> dict[str, "LinkClass"]:
    """Fit per-class link constants from measured point-to-point transfers.

    ``samples[name]`` is a list of ``(bytes, seconds)`` pairs for one link
    class. Each class gets the least-squares line ``t = ts + bytes / bw``:
    the slope is ``1/bw``, the intercept the startup (clamped at 0). Needs
    >= 2 distinct sizes per class and a positive slope; otherwise raises.
    """
    classes: dict[str, LinkClass] = {}
    for name, pts in samples.items():
        pts = [(float(b), float(t)) for b, t in pts]
        if len(pts) < 2 or len({b for b, _ in pts}) < 2:
            raise ValueError(
                f"link class {name!r}: need >= 2 samples at distinct sizes "
                f"to fit (bw, ts), got {pts}"
            )
        slope, mx, my = _fit_line(pts)
        if slope <= 0:
            raise ValueError(
                f"link class {name!r}: non-positive transfer-time slope "
                f"({slope:.3e} s/byte) — samples cannot identify a bandwidth"
            )
        classes[name] = LinkClass(name, bw=1.0 / slope,
                                  ts=max(my - slope * mx, 0.0))
    return classes


def cost_link_class(
    algo: str,
    M: float,
    n: int,
    link: "LinkClass",
    hw: Hardware = H100_SXM,
    **kw,
) -> float:
    """Predicted latency of ``algo`` over links of one calibrated class:
    the closed form at the class's bandwidth, with the hardware's startup
    replaced by the class's."""
    return ALGO_COSTS[algo](M, n, dataclasses.replace(hw, ts=link.ts),
                            link.bw, **kw)
