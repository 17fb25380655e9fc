"""The collective tuning framework (paper Sec. IV-B/IV-C, "MV2-GDR-Opt").

Selects an algorithm and chunk size per (op, message size, rank count,
path class), the way MVAPICH2-GDR's tuning tables do, from the analytic
cost models (Eqs. 1-6) on the target :class:`~.cost_model.Hardware`. An
optional empirical ``table`` overrides the analytic choice inside its
bucket. ``record``/``calibrate`` fill it from measurements and
``save``/``load`` persist it as JSON in the reference's format and keys, so
a table saved by either package loads into the other. ``OnlineTuner``
closes the loop online: an epsilon-greedy bandit over (algorithm x chunk
count x wire format) arms for one point, feeding its measurements back
through ``Tuner.record``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import random
from typing import Callable, Iterable, Sequence

from . import cost_model
from .cost_model import H100_SXM, Hardware

__all__ = ["Decision", "Tuner", "OnlineTuner", "TunerTableError", "default_tuner", "OPS",
           "RAGGED_OPS", "WIRE_FORMATS", "RECORD_DIMENSIONS"]


class TunerTableError(ValueError):
    """A persisted tuner table is unreadable or violates the schema.

    Subclasses ``ValueError`` so ``except ValueError`` callers keep working;
    the message names the offending file (and entry key, when one exists)."""


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
    streamed execution (``repro_torch.comm.overlap``); ``None`` means the
    table carries no depth for this point and the overlap planner falls
    back to the analytic :func:`cost_model.optimal_overlap_depth` sweep.

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


WIRE_FORMATS = ("bf16", "fp8", "int8")
_EXEC_PATHS = ("inkernel", "compiled", "unrolled")


def _dim_overlap_depth(v):
    return max(1, int(v))


def _dim_fused_path(v):
    return bool(v)


def _dim_exec_path(v):
    if v not in _EXEC_PATHS:
        raise ValueError(f"exec_path must be 'inkernel'|'compiled'|'unrolled', got {v!r}")
    return str(v)


def _dim_wire_format(v):
    if v not in WIRE_FORMATS:
        raise ValueError(f"wire_format must be one of {WIRE_FORMATS}, got {v!r}")
    return str(v)


# the optional per-point decision dimensions Tuner.record accepts through
# its ``extras`` dict: name -> validator/normalizer
RECORD_DIMENSIONS: dict[str, Callable] = {
    "overlap_depth": _dim_overlap_depth,
    "fused_path": _dim_fused_path,
    "exec_path": _dim_exec_path,
    "wire_format": _dim_wire_format,
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
        # mutation counter behind the memoized fingerprint (record,
        # record_overlap and record_stream bump it)
        self._version = 0
        self._fingerprint: tuple[int, str] | None = None

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
        share a plan between two tuners, or replay one built before a
        ``record``. Memoized on the mutation counter: change the table
        through ``record``/``record_overlap``/``record_stream``, not by
        writing ``self.table`` directly, or the memo goes stale."""
        if self._fingerprint is not None and self._fingerprint[0] == self._version:
            return self._fingerprint[1]
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
        fp = hashlib.sha1(payload.encode()).hexdigest()
        self._fingerprint = (self._version, fp)
        return fp

    def record(self, M: int, n: int, algo: str, num_chunks: int, measured_s: float, *,
               inter_pod: bool = False, op: str = "bcast",
               sizes: Sequence[int] | None = None, extras: dict | None = None) -> None:
        """Record one measured point. Optional decision dimensions ride in
        ``extras`` (:data:`RECORD_DIMENSIONS`: ``overlap_depth``,
        ``fused_path``, ``exec_path``, ``wire_format``); an unknown key or
        a bad value raises ``ValueError`` even when the measurement is
        discarded.

        Improvement-only: a slower measurement never displaces a faster one
        at the same key. A dimension left unset carries over from the
        previous entry only when that entry was for the same algorithm."""
        extras = dict(extras or {})
        unknown = set(extras) - set(RECORD_DIMENSIONS)
        if unknown:
            raise ValueError(f"unknown record dimension(s) {sorted(unknown)}; known "
                             f"dimensions are {sorted(RECORD_DIMENSIONS)}")
        extras = {k: RECORD_DIMENSIONS[k](v) for k, v in extras.items() if v is not None}
        key = self._key(M, n, inter_pod, op, self._flat_sizes(sizes))
        prev = self.table.get(key)
        # depth-only entries (record_overlap before any measurement) carry
        # no measured_s and never block a real measurement
        if prev is None or "measured_s" not in prev or measured_s < prev["measured_s"]:
            entry = {"algo": algo, "num_chunks": num_chunks, "measured_s": measured_s}
            for dim in RECORD_DIMENSIONS:
                val = extras.get(dim)
                if val is None and prev is not None and dim in prev \
                        and prev.get("algo") == algo:
                    val = prev[dim]
                if val is not None:
                    entry[dim] = val
            self.table[key] = entry
            self._version += 1

    def record_overlap(self, M: int, n: int, depth: int, *, inter_pod: bool = False,
                       op: str = "allreduce") -> None:
        """Attach a tuned in-flight bucket window to the (op, M, n) entry.
        With no measured entry there yet, a depth-only entry is stored:
        ``select`` still prices analytically and only annotates the
        Decision with the depth."""
        entry = self.table.setdefault(self._key(M, n, inter_pod, op), {})
        entry["overlap_depth"] = max(1, int(depth))
        self._version += 1

    def record_stream(self, name: str, *, overlap_depth: int | None = None,
                      priority: int | None = None) -> None:
        """Record a per-stream scheduling decision under ``stream:<name>``:
        an in-flight window and/or an arbitration priority. Structure
        choices, not timings: they survive ``allow_dryrun`` loads.
        Re-recording an unchanged decision leaves the fingerprint as it
        was."""
        key = f"stream:{name}"
        entry = dict(self.table.get(key, {}))
        if overlap_depth is not None:
            entry["overlap_depth"] = max(1, int(overlap_depth))
        if priority is not None:
            entry["priority"] = int(priority)
        if not entry or entry == self.table.get(key):
            return
        self.table[key] = entry
        self._version += 1

    def stream_decision(self, name: str) -> dict:
        """A copy of the ``stream:<name>`` entry (possibly empty)."""
        return dict(self.table.get(f"stream:{name}", {}))

    def calibrate(self, measure: Callable[[str, int, int, int], float], sizes: Iterable[int],
                  n: int, *, inter_pod: bool = False, op: str = "bcast") -> None:
        """Populate the table: ``measure(algo, M, n, num_chunks) -> seconds``
        for every applicable algorithm and its chunk-count options."""
        if op == "bcast":
            candidates = {a: _CANDIDATES[a] for a in self.allow if a in _CANDIDATES}
        else:
            candidates = _OP_CANDIDATES[op]
        for M in sizes:
            for algo, applicable in candidates.items():
                if not applicable(M, n):
                    continue
                if algo in ("pipelined_chain", "pipelined_reduce_chain", "fused_rsb"):
                    chunk_opts = sorted({max(1, min(self.max_chunks, math.ceil(M / c)))
                                         for c in (M, M // 4, M // 16, M // 64) if c and c > 0})
                elif algo in ("scatter_allgather", "ring_allreduce", "ring_allgather",
                              "doubling_allgather", "ring_reduce_scatter"):
                    chunk_opts = [n]
                elif algo == "reduce_then_bcast":
                    chunk_opts = [self.select(M, n, inter_pod=inter_pod).num_chunks]
                else:
                    chunk_opts = [1]
                for k in chunk_opts:
                    self.record(M, n, algo, k, measure(algo, M, n, k), inter_pod=inter_pod,
                                op=op)

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

    # -- persistence ---------------------------------------------------------

    def save(self, path: str, *, dryrun: bool = False) -> None:
        """Persist the table. ``dryrun=True`` brands the artifact as
        simulator-derived: :meth:`load` refuses to seed empirical decisions
        from it."""
        payload = {
            "hw": self.hw.name,
            "max_chunks": self.max_chunks,
            "knomial_k": self.knomial_k,
            "table": self.table,
        }
        if dryrun:
            payload["dryrun"] = True
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)

    @classmethod
    def load(cls, path: str, hw: Hardware = H100_SXM, *, allow_dryrun: bool = False) -> "Tuner":
        """Load a saved table, schema-checked entry by entry; a rotten table
        raises :class:`TunerTableError` here, not deep inside a step.
        ``num_chunks`` is clamped to the table's ``max_chunks`` at read
        time. A table branded ``dryrun`` raises unless ``allow_dryrun``;
        even then its measured entries are dropped, and only depth-only
        and ``stream:<name>`` entries (structure choices, not timings)
        remain."""
        try:
            with open(path) as f:
                payload = json.load(f)
        except json.JSONDecodeError as e:
            raise TunerTableError(
                f"{path}: corrupt or truncated JSON (line {e.lineno} col {e.colno}: "
                f"{e.msg}) — regenerate the table") from e
        except OSError as e:
            raise TunerTableError(f"{path}: unreadable tuner table: {e}") from e
        if not isinstance(payload, dict):
            raise TunerTableError(f"{path}: expected a JSON object with a 'table' field, "
                                  f"got {type(payload).__name__}")
        table = payload.get("table", {})
        if not isinstance(table, dict):
            raise TunerTableError(f"{path}: 'table' must be an object")
        max_chunks = payload.get("max_chunks", 64)
        for key, entry in table.items():
            _check_entry(path, key, entry)
            if "num_chunks" in entry:
                entry["num_chunks"] = min(entry["num_chunks"], max_chunks)
        if payload.get("dryrun"):
            if not allow_dryrun:
                raise TunerTableError(
                    f"{path}: table is branded dryrun (simulator stand-ins, not device "
                    "measurements) and cannot seed empirical tuner decisions; pass "
                    "allow_dryrun=True to schema-check it (measured entries are "
                    "dropped, depth-only entries kept)")
            table = {k: e for k, e in table.items()
                     if set(e) == {"overlap_depth"} or k.startswith("stream:")}
        return cls(hw, max_chunks=max_chunks, knomial_k=payload.get("knomial_k", 4),
                   table=table)


def _check_entry(path: str, key: str, entry) -> None:
    """The schema gate of :meth:`Tuner.load` for one table entry."""
    def bad(msg):
        return TunerTableError(f"{path}: entry {key!r} {msg}")

    if not isinstance(entry, dict):
        raise bad(f"must be an object, got {entry!r}")
    if "overlap_depth" in entry and (
            not isinstance(entry["overlap_depth"], int) or entry["overlap_depth"] < 1):
        raise bad("overlap_depth must be a positive int")
    if "fused_path" in entry and not isinstance(entry["fused_path"], bool):
        raise bad("fused_path must be a bool")
    if "exec_path" in entry and entry["exec_path"] not in _EXEC_PATHS:
        raise bad(f"exec_path must be 'inkernel'|'compiled'|'unrolled', "
                  f"got {entry['exec_path']!r}")
    if "wire_format" in entry and entry["wire_format"] not in WIRE_FORMATS:
        raise bad(f"wire_format must be one of {WIRE_FORMATS}, got {entry['wire_format']!r}")
    if key.startswith("stream:"):
        if not set(entry) <= {"overlap_depth", "priority"}:
            raise TunerTableError(f"{path}: stream entry {key!r} may only carry "
                                  f"overlap_depth/priority, got {sorted(entry)}")
        if "priority" in entry and not isinstance(entry["priority"], int):
            raise TunerTableError(f"{path}: stream entry {key!r} priority must be an int")
        return
    if set(entry) == {"overlap_depth"}:
        return  # depth-only entry (record_overlap, no measurement)
    if not {"algo", "num_chunks", "measured_s"} <= set(entry):
        raise bad(f"must have algo/num_chunks/measured_s, got {entry!r}")
    if entry["algo"] not in set(cost_model.ALGO_COSTS) | {"noop", "xla_psum", "xla_allgather"}:
        raise bad(f"has unknown algo {entry['algo']!r}")
    if not isinstance(entry["num_chunks"], int) or entry["num_chunks"] < 1:
        raise bad("num_chunks must be a positive int")
    if not isinstance(entry["measured_s"], (int, float)) or not math.isfinite(entry["measured_s"]):
        raise bad("measured_s must be finite")


class OnlineTuner:
    """Epsilon-greedy bandit exploration over (algo x num_chunks x
    wire_format) arms for ONE (op, M, n, inter_pod) point.

    :meth:`propose` usually returns the planned decision
    (:meth:`Tuner.select` — the table's best), but with probability
    ``epsilon`` (and always while an arm is untried) it swaps in an
    exploration arm; :meth:`observe` feeds the measured time back through
    :meth:`Tuner.record`, so an exploration that beats the incumbent lands
    in the table, changes the tuner's fingerprint, and with it the key of
    every cached plan for the point (``plan_cached`` keys on the
    fingerprint; see ``comm.cache_stats()``). ``record`` is
    improvement-only, so a bad exploration costs one step and changes
    nothing.

    Untried arms are visited first in a fixed order (sorted algorithms,
    then formats), so the best arm of a rigged landscape is found within
    ``len(arms)`` steps.
    """

    def __init__(
        self,
        tuner: Tuner,
        op: str,
        M: int,
        n: int,
        *,
        inter_pod: bool = False,
        arms: Sequence[tuple] | None = None,
        wire_formats: Sequence[str] = WIRE_FORMATS,
        epsilon: float = 0.25,
        seed: int = 0,
    ):
        if op not in OPS:
            raise ValueError(f"unknown collective op {op!r}; have {OPS}")
        if op in RAGGED_OPS:
            raise ValueError(
                f"online exploration over wire formats is scoped to the dense "
                f"ops, not {op!r} (compressed formats reject ragged chunking)"
            )
        self.tuner = tuner
        self.op, self.M, self.n, self.inter_pod = op, int(M), int(n), bool(inter_pod)
        self.epsilon = float(epsilon)
        self._rng = random.Random(seed)
        for fmt in wire_formats:
            _dim_wire_format(fmt)
        self.arms: list[tuple[str, int, str]] = (
            [self._norm_arm(a) for a in arms]
            if arms is not None
            else self._default_arms(tuple(wire_formats))
        )
        if not self.arms:
            raise ValueError(f"no applicable arms for {op!r} at (M={M}, n={n})")
        # per-arm statistics live here, not in the table: the table only
        # holds the best decision, the bandit needs every observation
        self._pulls = {arm: 0 for arm in self.arms}
        self._total_s = {arm: 0.0 for arm in self.arms}

    def _norm_arm(self, arm) -> tuple[str, int, str]:
        algo, num_chunks, fmt = arm
        return (str(algo), self._arm_chunks(algo) if num_chunks is None
                else int(num_chunks), _dim_wire_format(fmt))

    def _arm_chunks(self, algo: str) -> int:
        """Analytic chunk count for an arm (:meth:`Tuner.calibrate`'s
        per-algorithm logic, collapsed to the model optimum)."""
        M, n, t = self.M, self.n, self.tuner
        B = t.hw.path_bw(self.inter_pod)
        if algo in ("pipelined_chain", "pipelined_reduce_chain"):
            c = cost_model.optimal_chunk_bytes(M, n, t.hw, B)
        elif algo == "bidir_chain":
            c = cost_model.optimal_chunk_bytes(M, (n - 1 + 1) // 2 + 1, t.hw, B)
        elif algo == "fused_rsb":
            c = cost_model.optimal_chunk_bytes_fused(M, n, t.hw, B)
        elif algo in ("scatter_allgather", "ring_allreduce", "ring_allgather",
                      "doubling_allgather", "ring_reduce_scatter"):
            return n
        else:
            return 1
        return max(1, min(t.max_chunks, math.ceil(M / c)))

    def _default_arms(self, wire_formats: tuple[str, ...]) -> list:
        if self.op == "bcast":
            cands = {a: _CANDIDATES[a] for a in self.tuner.allow if a in _CANDIDATES}
        else:
            cands = _OP_CANDIDATES[self.op]
        return [
            (algo, self._arm_chunks(algo), fmt)
            for algo in sorted(cands)
            if cands[algo](self.M, self.n)
            for fmt in wire_formats
        ]

    def _decision(self, arm: tuple[str, int, str]) -> Decision:
        algo, k, fmt = arm
        predicted = cost_model.cost_wire(
            algo, self.M, self.n, self.tuner.hw,
            wire_format=fmt, inter_pod=self.inter_pod,
            **({"C": float(math.ceil(self.M / k))} if algo in (
                "pipelined_chain", "bidir_chain", "pipelined_reduce_chain",
                "fused_rsb") else {}),
        ) if algo in cost_model.ALGO_COSTS else float("nan")
        return Decision(algo, k, math.ceil(self.M / max(1, k)), predicted,
                        "explore", wire_format=fmt)

    def propose(self) -> Decision:
        """The decision to run THIS step: an untried arm first (fixed
        order), then an epsilon-random arm, else the planned decision."""
        for arm in self.arms:
            if self._pulls[arm] == 0:
                return self._decision(arm)
        if self._rng.random() < self.epsilon:
            return self._decision(self._rng.choice(self.arms))
        return self.tuner.select(self.M, self.n, op=self.op,
                                 inter_pod=self.inter_pod)

    def observe(self, decision: Decision, measured_s: float) -> None:
        """Feed one measured step back: bandit statistics here, the
        improvement-only table update (a new fingerprint on improvement)
        through :meth:`Tuner.record`."""
        arm = (decision.algo, int(decision.num_chunks),
               decision.wire_format or "bf16")
        if arm in self._pulls:
            self._pulls[arm] += 1
            self._total_s[arm] += float(measured_s)
        self.tuner.record(
            self.M, self.n, decision.algo, decision.num_chunks,
            float(measured_s), inter_pod=self.inter_pod, op=self.op,
            extras={"wire_format": decision.wire_format},
        )

    def step(self, measure: Callable[[Decision], float]) -> tuple[Decision, float]:
        """One explore-measure-record cycle; returns (decision, seconds)."""
        dec = self.propose()
        t = float(measure(dec))
        self.observe(dec, t)
        return dec, t

    def best_arm(self) -> tuple[str, int, str] | None:
        """Lowest mean measured time among tried arms (None before any)."""
        tried = [a for a in self.arms if self._pulls[a] > 0]
        if not tried:
            return None
        return min(tried, key=lambda a: self._total_s[a] / self._pulls[a])


_DEFAULT: Tuner | None = None


def default_tuner() -> Tuner:
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = Tuner(H100_SXM)
    return _DEFAULT
