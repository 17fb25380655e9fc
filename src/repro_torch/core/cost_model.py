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
    "cost",
    "optimal_chunk_bytes",
    "optimal_chunk_bytes_fused",
    "skew_ratio",
    "t_exec_path",
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
#   (ROADMAP A.14) once it exists.
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

