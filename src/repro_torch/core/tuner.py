"""The collective tuning framework (paper Sec. IV-B/IV-C, "MV2-GDR-Opt").

Selects an algorithm and chunk size per (op, message size, rank count,
path class), the way MVAPICH2-GDR's tuning tables do, from the analytic
cost models (Eqs. 1-6) on the target :class:`~.cost_model.Hardware`. An
optional empirical ``table`` keyed like the reference's overrides the
analytic choice inside its bucket; recording and loading tables
(``record``/``load``/``OnlineTuner``) are not ported yet.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from typing import Callable, Sequence

from . import cost_model
from .cost_model import H100_SXM, Hardware

__all__ = ["Decision", "Tuner", "default_tuner", "OPS", "RAGGED_OPS"]

# collective ops the tuner prices; 'bcast' keeps the legacy table-key format
OPS = ("bcast", "reduce", "allreduce", "allgather", "reduce_scatter",
       "allgatherv", "alltoallv")

# ragged ops: decisions additionally depend on the per-rank size vector
# (skew-bucketed into the empirical key; fed to the skew-aware cost forms)
RAGGED_OPS = ("allgatherv", "alltoallv")


def _is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


@dataclasses.dataclass(frozen=True)
class Decision:
    """A tuning decision for one (op, M, n) point.

    ``overlap_depth`` is the tuned in-flight bucket window for bucket-
    streamed execution; ``None`` means the table carries no depth for this
    point (the overlap planner is not ported yet).

    ``fused_path`` is the compiled-executor flag: ``True`` pins this point
    to the compiled replay (``comm.executors.execute_compiled``),
    ``False`` to the exact unrolled replay, ``None`` (default) defers to
    ``comm.api.apply_plan``'s round-count/zero-waste policy. Calibration can
    record it per point the way it records ``num_chunks``.

    ``exec_path`` generalizes ``fused_path`` to the three-executor routing
    tier: 'inkernel' | 'compiled' | 'unrolled' pins the point to that
    executor (``comm.api._resolve_exec_path``'s middle tier — an explicit
    ``inkernel=`` call-site flag still outranks it); ``None`` defers to
    ``fused_path``/policy. The auto policy never selects inkernel on its
    own: it enters via this tuned field or the explicit flag.

    ``wire_format`` is what the chunks look like on the wire: 'bf16'
    (bit-identical passthrough) | 'fp8' | 'int8' (per-block quantized —
    see :mod:`repro_torch.comm.compress`); ``None`` means passthrough. Like
    ``exec_path`` it can come from the table (an :class:`OnlineTuner`
    exploring formats records it) or be pinned at the call site.
    """

    algo: str
    num_chunks: int
    chunk_bytes: int
    predicted_s: float
    source: str  # 'analytic' | 'empirical' | 'explore'
    overlap_depth: int | None = None
    fused_path: bool | None = None
    exec_path: str | None = None
    wire_format: str | None = None


# algorithms the executor can run, with practical applicability predicates
_CANDIDATES: dict[str, Callable[[int, int], bool]] = {
    "direct": lambda M, n: n <= 4,
    "chain": lambda M, n: True,
    "binomial": lambda M, n: True,
    "knomial": lambda M, n: n >= 8,
    "scatter_allgather": lambda M, n: _is_pow2(n) and n >= 4 and M >= 4 * n,
    "pipelined_chain": lambda M, n: n >= 3 and M >= 4 * n,
    # beyond-paper bidirectional chain (full-duplex links)
    "bidir_chain": lambda M, n: n >= 4 and M >= 8 * n,
}

# per-op candidate sets for the non-bcast collectives (repro_torch.comm)
_OP_CANDIDATES: dict[str, dict[str, Callable[[int, int], bool]]] = {
    "reduce": {
        "binomial_reduce": lambda M, n: True,
        "pipelined_reduce_chain": lambda M, n: n >= 3 and M >= 4 * n,
    },
    "allreduce": {
        "reduce_then_bcast": lambda M, n: True,
        "fused_rsb": lambda M, n: n >= 2 and M >= 4 * n,
        "ring_allreduce": lambda M, n: n >= 3 and M >= 4 * n,
    },
    "allgather": {
        "ring_allgather": lambda M, n: True,
        "doubling_allgather": lambda M, n: _is_pow2(n),
    },
    "reduce_scatter": {
        "ring_reduce_scatter": lambda M, n: True,
    },
    "allgatherv": {
        "ring_allgatherv": lambda M, n: True,
        "doubling_allgatherv": lambda M, n: _is_pow2(n),
    },
    "alltoallv": {
        "pairwise_alltoallv": lambda M, n: True,
        "ring_alltoallv": lambda M, n: True,
    },
}


class Tuner:
    def __init__(
        self,
        hw: Hardware = H100_SXM,
        *,
        max_chunks: int = 64,
        knomial_k: int = 4,
        allow: Sequence[str] | None = None,
        table: dict | None = None,
    ):
        self.hw = hw
        self.max_chunks = max_chunks
        self.knomial_k = knomial_k
        self.allow = tuple(allow) if allow is not None else tuple(_CANDIDATES)
        # empirical table: {f"{n}:{bucket}": {"algo":..., "num_chunks":...}}
        self.table = dict(table or {})
        self._fingerprint: str | None = None

    # -- analytic path ------------------------------------------------------

    def _analytic(self, M: int, n: int, inter_pod: bool) -> Decision:
        B = self.hw.path_bw(inter_pod)
        best: tuple[float, str, int] | None = None
        for algo in self.allow:
            if algo not in _CANDIDATES or not _CANDIDATES[algo](M, n):
                continue
            if algo == "pipelined_chain":
                c_star = cost_model.optimal_chunk_bytes(M, n, self.hw, B)
                num_chunks = max(1, min(self.max_chunks, math.ceil(M / c_star)))
                c_eff = math.ceil(M / num_chunks)
                t = cost_model.t_pipelined_chain(M, n, self.hw, B, C=c_eff)
            elif algo == "bidir_chain":
                hops = (n - 1 + 1) // 2
                c_star = cost_model.optimal_chunk_bytes(M, hops + 1, self.hw, B)
                num_chunks = max(1, min(self.max_chunks, math.ceil(M / c_star)))
                t = cost_model.t_bidir_chain(M, n, self.hw, B, C=math.ceil(M / num_chunks))
            elif algo == "knomial":
                t = cost_model.t_knomial(M, n, self.hw, B, k=self.knomial_k)
                num_chunks = 1
            elif algo == "scatter_allgather":
                t = cost_model.t_scatter_allgather(M, n, self.hw, B)
                num_chunks = n
            else:
                t = cost_model.cost(algo, M, n, self.hw, inter_pod=inter_pod)
                num_chunks = 1
            if best is None or t < best[0]:
                best = (t, algo, num_chunks)
        assert best is not None, "no applicable algorithm (allow list too strict?)"
        t, algo, num_chunks = best
        return Decision(algo, num_chunks, math.ceil(M / num_chunks), t, "analytic")

    def _analytic_op(self, op: str, M: int, n: int, inter_pod: bool) -> Decision:
        """Analytic selection for the non-bcast collectives (repro_torch.comm)."""
        B = self.hw.path_bw(inter_pod)
        best: tuple[float, str, int] | None = None
        for algo, ok in _OP_CANDIDATES[op].items():
            if not ok(M, n):
                continue
            if algo == "pipelined_reduce_chain":
                c_star = cost_model.optimal_chunk_bytes(M, n, self.hw, B)
                num_chunks = max(1, min(self.max_chunks, math.ceil(M / c_star)))
                t = cost_model.t_pipelined_chain(M, n, self.hw, B, C=math.ceil(M / num_chunks))
            elif algo == "reduce_then_bcast":
                # barrier composite: reversed-binomial reduce + the tuned
                # bcast. Priced via select() — NOT _analytic — so empirical
                # bcast entries shape the price exactly as plan_collective
                # builds the inner schedule.
                bcast = self.select(M, n, op="bcast", inter_pod=inter_pod)
                t = cost_model.t_knomial(M, n, self.hw, B, k=2) + bcast.predicted_s
                num_chunks = bcast.num_chunks
            elif algo == "fused_rsb":
                c_star = cost_model.optimal_chunk_bytes_fused(M, n, self.hw, B)
                num_chunks = max(1, min(self.max_chunks, math.ceil(M / c_star)))
                t = cost_model.t_fused_rsb(M, n, self.hw, B, C=math.ceil(M / num_chunks))
            elif algo in ("ring_allreduce", "ring_allgather", "doubling_allgather", "ring_reduce_scatter"):
                t = cost_model.cost(algo, M, n, self.hw, inter_pod=inter_pod)
                num_chunks = n
            else:  # binomial_reduce and any whole-message mirror
                t = cost_model.cost(algo, M, n, self.hw, inter_pod=inter_pod)
                num_chunks = 1
            if best is None or t < best[0]:
                best = (t, algo, num_chunks)
        assert best is not None, f"no applicable {op} algorithm for (M={M}, n={n})"
        t, algo, num_chunks = best
        return Decision(algo, num_chunks, math.ceil(M / num_chunks), t, "analytic")

    def _analytic_ragged(self, op: str, M: int, n: int, inter_pod: bool,
                         sizes: Sequence[int] | None) -> Decision:
        """Analytic selection for the ragged ops. ``sizes`` is the row-count
        vector (per rank for allgatherv; per destination or per (src, dst)
        block for alltoallv); the cost forms are fed byte sizes so the
        max(sizes)-vs-sum(sizes) skew term prices each candidate."""
        B = self.hw.path_bw(inter_pod)
        total = sum(sizes) if sizes else 0
        if total <= 0:
            sizes, total = None, 0
        row_bytes = M / total if total else float(M)
        sizes_bytes = [s * row_bytes for s in sizes] if sizes is not None else None
        best: tuple[float, str] | None = None
        for algo, ok in _OP_CANDIDATES[op].items():
            if not ok(M, n):
                continue
            t = cost_model.cost(algo, M, n, self.hw, inter_pod=inter_pod,
                                sizes=sizes_bytes)
            if best is None or t < best[0]:
                best = (t, algo)
        assert best is not None, f"no applicable {op} algorithm for (M={M}, n={n})"
        t, algo = best
        # the schedule's chunk axis is the ragged row axis: num_chunks is
        # pinned by the size vector (sum of rows), never swept
        num_chunks = max(total, 1)
        return Decision(algo, num_chunks, math.ceil(M / num_chunks), t, "analytic")


    # -- empirical table ----------------------------------------------------

    @staticmethod
    def _bucket(M: int) -> int:
        return max(0, int(math.log2(max(M, 1))))

    @staticmethod
    def _flat_sizes(sizes):
        """Canonical flat tuple: alltoallv callers may hand the n x n nested
        block matrix straight to select."""
        if sizes is None:
            return None
        sizes = tuple(sizes)
        if sizes and isinstance(sizes[0], (list, tuple)):
            return tuple(int(v) for row in sizes for v in row)
        return tuple(int(s) for s in sizes)

    @staticmethod
    def _skew_bucket(sizes: Sequence[int] | None) -> int:
        """log2 bucket of max/mean — 0 for uniform (or unknown) sizes, up to
        log2(len) for a single hot rank. Ragged empirical keys carry it so a
        measurement under skew never overrides the uniform bucket."""
        if not sizes or sum(sizes) <= 0:
            return 0
        return max(0, int(round(math.log2(cost_model.skew_ratio(sizes)))))

    def _key(self, M: int, n: int, inter_pod: bool, op: str = "bcast",
             sizes: Sequence[int] | None = None) -> str:
        # bcast keeps the legacy key format so existing saved tables load
        base = f"{n}:{self._bucket(M)}:{int(inter_pod)}"
        if op == "bcast":
            return base
        if op in RAGGED_OPS:
            return f"{op}:{base}:s{self._skew_bucket(sizes)}"
        return f"{op}:{base}"

    def fingerprint(self) -> str:
        """Content hash of everything a tuned decision can depend on: the
        empirical table plus the tuner's configuration, so host-side plan
        caches (:func:`repro_torch.comm.plan.plan_cached`) keyed on it never
        share a plan between two tuners. Computed once: the port's tuner has
        no mutating methods."""
        if self._fingerprint is not None:
            return self._fingerprint
        payload = json.dumps(
            {
                "hw": self.hw.name,
                "max_chunks": self.max_chunks,
                "knomial_k": self.knomial_k,
                "allow": list(self.allow),
                "table": self.table,
            },
            sort_keys=True,
            default=repr,
        )
        self._fingerprint = hashlib.sha1(payload.encode()).hexdigest()
        return self._fingerprint

    # -- public -------------------------------------------------------------

    def select(self, M: int, n: int, *, op: str = "bcast", inter_pod: bool = False,
               sizes: Sequence[int] | None = None) -> Decision:
        """Tuned decision for one collective: op in :data:`OPS` (default
        'bcast' — the legacy single-op signature is unchanged). Empirical
        table entries are keyed per-op and override the analytic choice.

        Ragged ops (``allgatherv``/``alltoallv``) take the row-count vector
        via ``sizes``: the analytic path prices candidates with the
        skew-aware cost forms and the empirical key carries a skew bucket,
        so a table entry measured under one skew regime never decides for
        another."""
        if op not in OPS:
            raise ValueError(f"unknown collective op {op!r}; have {OPS}")
        if sizes is not None and op not in RAGGED_OPS:
            raise ValueError(f"sizes= is only meaningful for {RAGGED_OPS}, not {op!r}")
        sizes = self._flat_sizes(sizes)
        if n <= 1:
            return Decision("noop", 1, max(M, 1), 0.0, "analytic")
        hit = self.table.get(self._key(M, n, inter_pod, op, sizes))
        depth = hit.get("overlap_depth") if hit is not None else None
        depth = max(1, int(depth)) if depth is not None else None
        if hit is not None and "algo" in hit:
            if op in RAGGED_OPS:
                # the size vector pins the chunk axis: only the algorithm
                # choice (and executor routing) comes from the table
                k = max(sum(sizes), 1) if sizes else 1
            else:
                # Empirical entries are data, not code: a table recorded
                # with a larger max_chunks (or a corrupted num_chunks < 1)
                # must not flow into a Decision the executors can't honor —
                # clamp at hit time, exactly as Tuner.load clamps at read
                # time.
                k = min(max(int(hit["num_chunks"]), 1), self.max_chunks)
            return Decision(
                hit["algo"],
                k,
                math.ceil(M / k),
                float(hit["measured_s"]),
                "empirical",
                overlap_depth=depth,
                fused_path=hit.get("fused_path"),
                exec_path=hit.get("exec_path"),
                wire_format=hit.get("wire_format"),
            )
        # depth-only entries (record_overlap with no measurement yet) keep
        # the analytic pricing and only annotate the decision with the depth
        if op == "bcast":
            dec = self._analytic(M, n, inter_pod)
        elif op in RAGGED_OPS:
            dec = self._analytic_ragged(op, M, n, inter_pod, sizes)
        else:
            dec = self._analytic_op(op, M, n, inter_pod)
        return dataclasses.replace(dec, overlap_depth=depth) if depth is not None else dec


_DEFAULT: Tuner | None = None


def default_tuner() -> Tuner:
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = Tuner(H100_SXM)
    return _DEFAULT
