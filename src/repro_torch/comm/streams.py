"""Multi-stream link scheduler: collectives as DAG-embedded stream entries
(DESIGN.md Sec. 13).

A production step runs several comm streams at once (gradient sync,
next-step weight prefetch, weight distribution) that contend for the same
links. Every in-flight collective is a dependency-tracked entry of one
link scheduler:

* :class:`StreamEntry` — a named stream carrying an ordered list of
  per-bucket :class:`~repro_torch.comm.plan.CollectivePlan` objects, its
  dispatch order and staging window, a priority, a link class and DAG
  edges (``after``) to the entries it must follow.
* :class:`StreamGraph` — the validated set of entries (unique names,
  resolvable acyclic ``after`` edges), the scheduler's starvation bound and
  the spec-level fingerprint ``plan_cached`` keys on.
* :func:`plan_streams` — host-side planning: one :class:`StreamSpec` per
  stream resolves to per-(axis, bucket) plans through ``plan_cached``, with
  depth and priority from the tuner's ``stream:*`` entries when the spec
  leaves them out.
* :func:`simulate_streams` and :func:`dispatch_schedule` — the contended
  timeline in network rounds through
  :func:`~repro_torch.core.cost_model.multi_stream_finish_times`, with
  per-stream accounting, the fairness and no-idle properties, the naive
  serialization baseline, and the bucket-level commit order.
* :func:`execute_stream_entry` / :func:`execute_streams` — the replay over
  rank-stacked trees (leaves ``(n, *shape)``): one entry in its own order,
  or several interleaved in the arbiter's commit order. Every bucket goes
  through ``apply_plan`` (so the compiled route launches the merge kernel
  and the in-kernel route ``rdma_replay``) and, with ``stage=True``,
  through the ``chunked_copy`` kernel first. The replay runs on the
  caller's CUDA stream in program order, as the reference leaves
  concurrency to its compiler.

``faults=`` (a :class:`~repro_torch.comm.faults.FaultSpec`) runs every
bucket's clock through the degraded ``timed_rounds``; dead ranks raise the
typed ``DeadRankError``, never a silent wrong answer.

The arbitration rule (one serial resource per link class): a transfer may
dispatch at ``max(link_free, min(ready))`` — the link never idles while
any transfer is ready. Highest priority wins the contended slot, except a
stream already passed over ``starvation_bound`` times is forced through.
A bucket occupies its link one round-quantum at a time, so a
high-priority stream waits at most one round, never a whole bucket.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
from typing import Any, Mapping, Sequence

from ..core import bucketing, cost_model
from ..core.bucketing import BucketSpec
from ..core.tree import tree_leaves
from ..core.tuner import Tuner, default_tuner
from ..kernels.chunked_copy import chunked_copy
from .api import _levels, apply_plan, level_replay
from .plan import CollectivePlan, plan_cached

__all__ = [
    "StreamSpec",
    "StreamEntry",
    "StreamGraph",
    "StreamGraphError",
    "graph_key",
    "plan_streams",
    "simulate_streams",
    "dispatch_schedule",
    "execute_streams",
    "execute_stream_entry",
]

# analytic depth sweep ceiling — every extra slot is a live staged bucket
# buffer in device memory (shared with the single-stream planner)
_MAX_DEPTH = 8

# scheduler default: a contended stream is never passed over more than this
# many times (plus S-2 for S-way contention) before it is forced through
_DEFAULT_STARVATION_BOUND = 4


def graph_key(payload: Any) -> str:
    """Stable fingerprint of a stream-graph SPEC (names, ops, priorities,
    DAG edges, bucket mixes, axes, depth requests). Computable BEFORE any
    plan resolves — this is the ``stream=`` component of the
    ``plan_cached`` key, so two different graph shapes can never share a
    cached per-bucket plan even when the (op, M, n) point coincides."""
    blob = json.dumps(payload, sort_keys=True, default=str)
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """Planning request for one stream (input to :func:`plan_streams`).

    ``tree`` is ONE rank's tree; only its leaves' shapes and dtypes are
    read (``torch.empty(shape, dtype=..., device="meta")`` leaves do).
    ``after`` names streams that must fully finish before this one's first
    bucket stages; ``link`` names the serial resource the stream occupies
    (streams on different links never contend; ``"ici"`` is the
    reference's name for the card-to-card link). ``priority`` and
    ``overlap_depth`` left ``None`` fall back to the tuner's
    ``stream:<name>`` entry, then (depth) to the per-op empirical and
    analytic tiers."""

    name: str
    tree: Any
    axes: tuple
    op: str = "allreduce"
    root: int = 0
    algo: str = "auto"
    priority: int | None = None
    after: tuple = ()
    overlap_depth: int | None = None
    compute_s: float = 0.0
    link: str = "ici"
    bucket_bytes: int = 4 << 20
    inter_pod_axes: tuple = ()
    reverse: bool = False
    spec: BucketSpec | None = None


@dataclasses.dataclass(frozen=True)
class StreamEntry:
    """A fully-resolved stream: bucket mix + per-(axis, bucket) plans +
    dispatch order + in-flight window + arbitration metadata."""

    name: str
    op: str
    spec: BucketSpec
    axes: tuple[str, ...]                         # sync order (hierarchy levels)
    plans: dict[str, tuple[CollectivePlan, ...]]  # per axis, one plan per bucket
    order: tuple[int, ...]                        # bucket dispatch order
    overlap_depth: int
    compute_s: float = 0.0
    depth_source: str = "manual"   # 'manual' | 'stream' | 'empirical' | 'analytic'
    priority: int = 0
    after: tuple[str, ...] = ()
    link: str = "ici"

    @property
    def num_buckets(self) -> int:
        return self.spec.num_buckets

    def bucket_comm_s(self) -> list[float]:
        """Per-bucket predicted collective time, summed over hierarchy
        levels, in DISPATCH order."""
        return [
            sum(self.plans[ax][k].predicted_s for ax in self.axes)
            for k in self.order
        ]

    def bucket_stage_s(self, hw: cost_model.Hardware | None = None) -> list[float]:
        """Per-bucket staging (pack / ``chunked_copy``) time in dispatch
        order: one HBM read + one HBM write of the bucket."""
        hw = hw or cost_model.H100_SXM
        sizes = self.spec.bucket_bytes()
        return [2.0 * sizes[k] / hw.hbm_bw for k in self.order]

    def bucket_rounds(self) -> list[int]:
        """Per-bucket network-round counts in dispatch order (summed over
        hierarchy levels; one-shot baselines count 1, noops 0; floored at
        1 so every bucket occupies its link for at least one quantum)."""
        out = []
        for k in self.order:
            r = 0
            for ax in self.axes:
                p = self.plans[ax][k]
                r += p.schedule.num_rounds if p.schedule is not None else (
                    0 if p.algo == "noop" else 1
                )
            out.append(max(r, 1))
        return out

    def bucket_times_s(self, hw: cost_model.Hardware | None = None, faults=None
                       ) -> tuple[list[float], list[float]]:
        """Per-bucket (healthy, clocked) schedule replay times in dispatch
        order. With ``faults`` the clocked column runs the degraded
        ``timed_rounds`` (dead ranks raise from the first bucket's replay);
        without, the two columns are identical."""
        hw = hw or cost_model.H100_SXM
        healthy, clocked = [], []
        for k in self.order:
            t0 = t = 0.0
            for ax in self.axes:
                p = self.plans[ax][k]
                if p.schedule is not None:
                    t0 += p.timed_rounds_s(hw)
                    if faults is not None:
                        t += p.timed_rounds_s(hw, faults=faults)
            healthy.append(t0)
            clocked.append(t if faults is not None else t0)
        return healthy, clocked

    def wire_bytes(self) -> int:
        """Total bytes on the wire — exactly the sum of the per-bucket plan
        accounting (arbitration reorders transfers, it never adds any)."""
        return sum(p.wire_bytes() for ax in self.axes for p in self.plans[ax])


class StreamGraphError(ValueError):
    """Malformed stream graph: duplicate names, dangling or cyclic edges."""


@dataclasses.dataclass(frozen=True)
class StreamGraph:
    """A validated DAG of :class:`StreamEntry` objects sharing the link
    scheduler.

    ``starvation_bound`` is the scheduler's aging threshold: a contended
    stream passed over that many times is forced through regardless of
    priority. ``key`` is the spec-level fingerprint from
    :func:`plan_streams` (``plan_cached`` keyed on it); content-derived
    when entries are constructed by hand."""

    entries: tuple[StreamEntry, ...]
    starvation_bound: int = _DEFAULT_STARVATION_BOUND
    key: str | None = None

    def __post_init__(self) -> None:
        names = [e.name for e in self.entries]
        if len(set(names)) != len(names):
            raise StreamGraphError(f"duplicate stream names: {names}")
        if int(self.starvation_bound) < 1:
            raise StreamGraphError("starvation_bound must be >= 1")
        known = set(names)
        for e in self.entries:
            for dep in e.after:
                if dep == e.name:
                    raise StreamGraphError(f"stream {e.name!r} is after itself")
                if dep not in known:
                    raise StreamGraphError(
                        f"stream {e.name!r} is after unknown stream {dep!r}"
                    )
        self.topo_order()  # raises on cycles

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(e.name for e in self.entries)

    def entry(self, name: str) -> StreamEntry:
        for e in self.entries:
            if e.name == name:
                return e
        raise KeyError(name)

    def topo_order(self) -> tuple[int, ...]:
        """Entry indices in a dependency-respecting order (stable: ties
        keep declaration order). Raises :class:`StreamGraphError` on a
        cycle — this is the validation pass."""
        idx = {e.name: i for i, e in enumerate(self.entries)}
        deps = {i: {idx[d] for d in e.after} for i, e in enumerate(self.entries)}
        out: list[int] = []
        done: set[int] = set()
        while len(out) < len(self.entries):
            progressed = False
            for i in range(len(self.entries)):
                if i in done or deps[i] - done:
                    continue
                out.append(i)
                done.add(i)
                progressed = True
            if not progressed:
                cyc = [self.entries[i].name for i in range(len(self.entries))
                       if i not in done]
                raise StreamGraphError(f"cycle in 'after' edges through {cyc}")
        return tuple(out)

    def fairness_bound(self) -> int:
        """The scheduler's hard starvation guarantee: no stream is passed
        over more than this many consecutive contended dispatches (the
        configured bound, plus S-2 when S starved streams must drain one
        at a time — exact for pairwise contention)."""
        return int(self.starvation_bound) + max(0, len(self.entries) - 2)

    def wire_bytes(self) -> int:
        return sum(e.wire_bytes() for e in self.entries)

    def fingerprint(self) -> str:
        if self.key is not None:
            return self.key
        payload = {
            "starvation_bound": int(self.starvation_bound),
            "entries": [
                {
                    "name": e.name, "op": e.op, "axes": list(e.axes),
                    "order": list(e.order), "depth": e.overlap_depth,
                    "priority": e.priority, "after": list(e.after),
                    "link": e.link, "compute_s": e.compute_s,
                    "plans": {
                        ax: [(p.decision.algo, p.decision.num_chunks, p.M,
                              p.n, p.root, p.inter_pod) for p in ps]
                        for ax, ps in sorted(e.plans.items())
                    },
                }
                for e in self.entries
            ],
        }
        return graph_key(payload)


# ---------------------------------------------------------------------------
# planning
# ---------------------------------------------------------------------------


def _resolve_depth(spec: StreamSpec, entry_plans: Mapping, bspec: BucketSpec,
                   order: tuple[int, ...], axes: Sequence, tuner: Tuner,
                   compute_s: float) -> tuple[int, str]:
    """Depth precedence: explicit > tuner ``stream:<name>`` entry > tuned
    per-op depth at the largest bucket > analytic sweep. The sweep prices
    staging on the tuner's hardware (the reference's tuner and its staging
    price both default to the same profile)."""
    if spec.overlap_depth is not None:
        return max(1, int(spec.overlap_depth)), "manual"
    tuned = tuner.stream_decision(spec.name).get("overlap_depth")
    if tuned is not None:
        return max(1, int(tuned)), "stream"
    sizes = bspec.bucket_bytes()
    if sizes:
        k_big = max(range(len(sizes)), key=lambda k: sizes[k])
        for ax, _n in axes:
            d = entry_plans[ax][k_big].decision.overlap_depth
            if d is not None:
                return d, "empirical"
    probe = StreamEntry(
        spec.name, spec.op, bspec, tuple(a for a, _ in axes), dict(entry_plans),
        order, 1, compute_s, "analytic",
    )
    depth = cost_model.optimal_overlap_depth(
        probe.bucket_comm_s(), compute_s,
        stage_s=probe.bucket_stage_s(tuner.hw), max_depth=_MAX_DEPTH,
    )
    return depth, "analytic"


def plan_streams(
    specs: Sequence[StreamSpec],
    *,
    tuner: Tuner | None = None,
    starvation_bound: int = _DEFAULT_STARVATION_BOUND,
) -> StreamGraph:
    """Resolve a :class:`StreamGraph` from per-stream :class:`StreamSpec`s.

    Every stream's per-bucket plans go through ``plan_cached``, keyed
    additionally on the graph's spec-level fingerprint, so plans resolved
    for one graph shape never leak into another. Priorities fall back to
    the tuner's ``stream:<name>`` entries (see :meth:`Tuner.record_stream`),
    depth to the stream > empirical > analytic tiers."""
    t = tuner or default_tuner()
    specs = tuple(specs)
    bspecs = [
        s.spec if s.spec is not None else bucketing.plan_buckets(s.tree, s.bucket_bytes)
        for s in specs
    ]
    gkey = graph_key({
        "starvation_bound": int(starvation_bound),
        "streams": [
            {
                "name": s.name, "op": s.op, "root": s.root, "algo": s.algo,
                "priority": s.priority, "after": list(s.after),
                "overlap_depth": s.overlap_depth, "compute_s": s.compute_s,
                "link": s.link, "axes": [[a, int(n)] for a, n in s.axes],
                "inter_pod_axes": sorted(str(a) for a in s.inter_pod_axes),
                "reverse": bool(s.reverse),
                "buckets": list(b.bucket_bytes()),
            }
            for s, b in zip(specs, bspecs)
        ],
    })
    entries = []
    for s, bspec in zip(specs, bspecs):
        inter = tuple(s.inter_pod_axes)
        plans: dict[str, tuple[CollectivePlan, ...]] = {}
        for ax, n in s.axes:
            plans[ax] = tuple(
                plan_cached(
                    s.op, max(M, 1), n, root=s.root, algo=s.algo, tuner=t,
                    inter_pod=(ax in inter), stream=gkey,
                )
                for M in bspec.bucket_bytes()
            )
        idx = range(bspec.num_buckets)
        order = tuple(reversed(idx)) if s.reverse else tuple(idx)
        depth, source = _resolve_depth(s, plans, bspec, order, s.axes, t, s.compute_s)
        priority = s.priority
        if priority is None:
            priority = t.stream_decision(s.name).get("priority", 0)
        entries.append(StreamEntry(
            name=s.name, op=s.op, spec=bspec,
            axes=tuple(a for a, _ in s.axes), plans=plans, order=order,
            overlap_depth=depth, compute_s=s.compute_s, depth_source=source,
            priority=int(priority), after=tuple(s.after), link=s.link,
        ))
    return StreamGraph(tuple(entries), starvation_bound=int(starvation_bound),
                       key=gkey)


# ---------------------------------------------------------------------------
# round-accurate contention simulator
# ---------------------------------------------------------------------------


def _discretize(graph: StreamGraph, hw: cost_model.Hardware,
                faults=None) -> tuple[list[dict], dict]:
    """Shared discretization for the simulator and the dispatch schedule:
    one GLOBAL mean round duration (all streams share the links, so rounds
    must be commensurable), per-stream staging/compute round counts, comm
    expanded into unit round-quanta (the preemption points)."""
    idx = {e.name: i for i, e in enumerate(graph.entries)}
    rounds = [e.bucket_rounds() for e in graph.entries]
    times = [e.bucket_times_s(hw, faults=faults) for e in graph.entries]
    healthy, clocked = [h for h, _c in times], [c for _h, c in times]
    total_rounds = sum(sum(r) for r in rounds)
    total_time = sum(sum(c) for c in clocked)
    mean_round_s = (total_time / total_rounds) if total_rounds else hw.ts
    mean_round_s = max(mean_round_s, hw.ts)
    demands = []
    info = {"mean_round_s": mean_round_s, "rounds": rounds,
            "healthy_s": sum(sum(h) for h in healthy), "clocked_s": total_time,
            "stage_rounds": [], "per_bucket_compute": []}
    for i, e in enumerate(graph.entries):
        K = len(rounds[i])
        stage_rounds = [int(round(s / mean_round_s)) for s in e.bucket_stage_s(hw)]
        per_bucket_compute = max(
            1, int(round(e.compute_s / max(K, 1) / mean_round_s))
        ) if K else 0
        info["stage_rounds"].append(stage_rounds)
        info["per_bucket_compute"].append(per_bucket_compute)
        demands.append({
            "avail": [(k + 1) * per_bucket_compute for k in range(K)],
            "stage": stage_rounds,
            "comm": [[1] * r for r in rounds[i]],
            "depth": e.overlap_depth,
            "priority": e.priority,
            "link": e.link,
            "after": tuple(idx[d] for d in e.after),
        })
    return demands, info


def _chained(demands: list[dict], graph: StreamGraph) -> list[dict]:
    """The naive-serialization baseline: the SAME demands with chain
    ``after`` edges along a topological order — stream i+1 may not start
    until stream i fully drains. Running it through the same scheduler
    (rather than summing spans by hand) keeps the two numbers exactly
    comparable."""
    topo = graph.topo_order()
    out = [dict(d) for d in demands]
    for pos in range(1, len(topo)):
        prev, cur = topo[pos - 1], topo[pos]
        out[cur]["after"] = tuple(set(out[cur]["after"]) | {prev})
    return out


def simulate_streams(graph: StreamGraph, hw: cost_model.Hardware | None = None,
                     faults=None) -> dict:
    """Discrete-round replay of the contended multi-stream timeline.

    Time is discretized into network rounds (one global mean round
    duration — all streams share the links). Every bucket occupies its
    stream's link for its schedule's round count, one unit quantum at a
    time (round-boundary preemption points); staging and compute gate
    availability exactly as in the single-stream simulator, and ``after``
    edges hold a stream back until its upstream fully drains.

    Returns span/idle/wire accounting for the arbitrated schedule AND for
    naive serialization of the same entries (chain edges, same
    scheduler), plus the two scheduler properties in checkable form:

    * fairness — ``max_skips`` never exceeds :meth:`StreamGraph.fairness_bound`;
    * no-idle — ``idle_while_ready_rounds`` is 0: every dispatch starts at
      ``max(link_free, min_ready)``, recomputed here from the trace.

    With ``faults`` (a :class:`~repro_torch.comm.faults.FaultSpec`) every
    bucket's clock runs the degraded ``timed_rounds``, the round structure
    untouched: ``comm_s_healthy``, ``comm_s_faulty``, ``fault_slowdown`` and
    ``fault_fingerprint`` quantify the degradation, and dead ranks raise
    ``DeadRankError``."""
    hw = hw or cost_model.H100_SXM
    demands, info = _discretize(graph, hw, faults=faults)
    trace: list[dict] = []
    ends = cost_model.multi_stream_finish_times(
        demands, starvation_bound=graph.starvation_bound, trace=trace)
    naive_ends = cost_model.multi_stream_finish_times(
        _chained(demands, graph), starvation_bound=graph.starvation_bound)
    multi_span = max((e[-1] for e in ends if e), default=0)
    naive_span = max((e[-1] for e in naive_ends if e), default=0)

    idle_while_ready = 0
    max_skips = 0
    link_busy: dict[str, int] = {}
    link_span: dict[str, int] = {}
    waits = [0] * len(graph.entries)
    for rec in trace:
        idle_while_ready += max(0, rec["start"] - max(rec["link_free"], rec["min_ready"]))
        max_skips = max(max_skips, rec["skips"])
        link_busy[rec["link"]] = link_busy.get(rec["link"], 0) + (rec["end"] - rec["start"])
        link_span[rec["link"]] = max(link_span.get(rec["link"], 0), rec["end"])
        if rec["quantum"] == 0:
            waits[rec["stream"]] += rec["start"] - rec["ready"]

    streams_out = {}
    for i, e in enumerate(graph.entries):
        comm_rounds = sum(info["rounds"][i])
        finish = ends[i][-1] if ends[i] else 0
        streams_out[e.name] = {
            "num_buckets": len(info["rounds"][i]),
            "priority": e.priority,
            "depth": e.overlap_depth,
            "link": e.link,
            "after": list(e.after),
            "comm_rounds": comm_rounds,
            "stage_rounds": sum(info["stage_rounds"][i]),
            "compute_rounds": len(info["rounds"][i]) * info["per_bucket_compute"][i],
            "finish_round": finish,
            "naive_finish_round": naive_ends[i][-1] if naive_ends[i] else 0,
            "wait_rounds": waits[i],
            "idle_rounds": finish - comm_rounds,
            "wire_bytes": e.wire_bytes(),
        }

    out = {
        "num_streams": len(graph.entries),
        "starvation_bound": int(graph.starvation_bound),
        "fairness_bound": graph.fairness_bound(),
        "mean_round_s": info["mean_round_s"],
        "multi_span_rounds": multi_span,
        "naive_span_rounds": naive_span,
        "comm_rounds": sum(sum(r) for r in info["rounds"]),
        "wire_bytes": graph.wire_bytes(),
        "max_skips": max_skips,
        "idle_while_ready_rounds": idle_while_ready,
        "links": {
            ln: {
                "busy_rounds": link_busy[ln],
                "span_rounds": link_span[ln],
                "idle_rounds": link_span[ln] - link_busy[ln],
            }
            for ln in sorted(link_busy)
        },
        "streams": streams_out,
    }
    if faults is not None:
        healthy, faulty = info["healthy_s"], info["clocked_s"]
        out["comm_s_healthy"] = healthy
        out["comm_s_faulty"] = faulty
        out["fault_slowdown"] = faulty / healthy if healthy > 0 else 1.0
        out["fault_fingerprint"] = faults.fingerprint()
    return out


def dispatch_schedule(
    graph: StreamGraph, hw: cost_model.Hardware | None = None
) -> list[tuple[str, int]]:
    """Bucket-level dispatch order: ``(stream name, bucket index)`` pairs
    in the arbiter's commit order (the first round-quantum of each
    bucket). This is the interleave :func:`execute_streams` replays —
    per stream, buckets appear exactly in that stream's ``order``."""
    hw = hw or cost_model.H100_SXM
    demands, _ = _discretize(graph, hw)
    trace: list[dict] = []
    cost_model.multi_stream_finish_times(
        demands, starvation_bound=graph.starvation_bound, trace=trace)
    sched = []
    for rec in trace:
        if rec["quantum"] == 0:
            e = graph.entries[rec["stream"]]
            sched.append((e.name, e.order[rec["bucket"]]))
    return sched


# ---------------------------------------------------------------------------
# execution on rank-stacked trees
# ---------------------------------------------------------------------------


class _Replay:
    """One entry's replay over the rank-stacked ``tree``, one bucket a
    :meth:`step`, in the entry's order with its staging window kept ahead.

    Each bucket's result is written back into the bucket when the
    collectives returned another buffer (a staged copy, or the zero-padded
    copy of a bucket that does not divide into the schedule's chunks), and
    the copy is dropped before the next bucket runs; :meth:`finish` writes
    every bucket of several leaves (a concatenated copy of them) back into
    its leaves. So ``tree`` is updated in place and keeps its own layout,
    and at most ``overlap_depth`` staged buckets and one padded bucket are
    held beside it."""

    def __init__(self, entry: StreamEntry, tree: Any, *, stage: bool, fused: bool,
                 compiled: bool | None, mesh=None, inkernel: bool | None = None):
        _levels(entry.axes, mesh)
        self.entry, self.tree, self.mesh = entry, tree, mesh
        self.stage, self.fused, self.compiled, self.inkernel = stage, fused, compiled, inkernel
        self.buckets = bucketing.pack_buckets(tree, entry.spec)
        self.order = [k for k in entry.order if self.buckets[k].numel()]
        self.staged: dict[int, Any] = {}
        self.pos = 0

    def _stage(self, k: int) -> None:
        b = self.buckets[k]
        if self.stage:
            b = chunked_copy(b.reshape(-1)).view(b.shape)
        self.staged[k] = b

    def step(self, k: int) -> None:
        """Replay bucket ``k``, the next one of the entry's order."""
        i = self.pos
        assert self.order[i] == k, (self.entry.name, k, self.order, i)
        for j in self.order[i : i + max(1, self.entry.overlap_depth)]:
            if j not in self.staged:   # keep the window staged ahead
                self._stage(j)
        b = self.staged.pop(k)
        for ax in self.entry.axes:
            b = level_replay(b, ax, functools.partial(
                apply_plan, self.entry.plans[ax][k], fused=self.fused,
                compiled=self.compiled, inkernel=self.inkernel), mesh=self.mesh)
        if b.data_ptr() != self.buckets[k].data_ptr():
            self.buckets[k].copy_(b)
        del b
        self.pos += 1

    def finish(self) -> Any:
        assert self.pos == len(self.order), (self.entry.name, self.pos, self.order)
        out = bucketing.unpack_buckets(self.buckets, self.entry.spec)
        for leaf, res in zip(tree_leaves(self.tree), tree_leaves(out)):
            if res.data_ptr() != leaf.data_ptr():
                leaf.copy_(res)
        return self.tree


def execute_stream_entry(
    entry: StreamEntry,
    tree: Any,
    *,
    stage: bool = False,
    stage_chunk: int = 64 * 1024,
    fused: bool = True,
    compiled: bool | None = None,
    mesh=None,
    inkernel: bool | None = None,
) -> Any:
    """Replay ONE stream entry over a rank-stacked tree (leaves
    ``(n, *shape)``) and return the tree, updated in place. Each bucket
    runs the entry's levels in order, each level's plan on every group of
    ranks along its axis (``comm.api.level_replay``); an entry of more than
    one level needs the ``mesh`` the leaves are stacked over. With ``stage``
    every bucket is first copied through the ``chunked_copy`` kernel; the
    collectives update the copy, which is then written back.
    ``stage_chunk`` is accepted and ignored: in the reference it is the
    staging copy's chunk, and the port's copy moves 32 KiB tiles whatever
    the chunk (``chunked_copy(chunk_elems=)``). ``fused`` and ``compiled``
    route each bucket's replay as :func:`apply_plan`'s do (``fused=False``:
    the unrolled replay), and ``inkernel`` as :func:`apply_plan`'s does.
    Consumers whose streams run at different points
    of a step (grad sync inside it, weight prefetch after the update: the
    DAG edge realized by program order) call this per entry."""
    run = _Replay(entry, tree, stage=stage, fused=fused, compiled=compiled, mesh=mesh,
                  inkernel=inkernel)
    for k in run.order:
        run.step(k)
    return run.finish()


def execute_streams(
    graph: StreamGraph,
    trees: Mapping[str, Any],
    *,
    hw: cost_model.Hardware | None = None,
    stage: bool = False,
    stage_chunk: int = 64 * 1024,
    fused: bool = True,
    compiled: bool | None = None,
    mesh=None,
    inkernel: bool | None = None,
) -> dict[str, Any]:
    """Replay every stream of ``graph`` over its rank-stacked tree
    (``trees`` maps stream name -> tree), interleaving bucket dispatches in
    the arbiter's commit order (:func:`dispatch_schedule`, on ``hw``).
    Per-bucket math is identical to the per-entry path — only the
    cross-stream interleave differs. Returns the trees, each updated in
    place. ``stage_chunk``, ``mesh`` and ``inkernel`` as
    :func:`execute_stream_entry`'s."""
    missing = set(graph.names) - set(trees)
    if missing:
        raise KeyError(f"execute_streams: no tree for streams {sorted(missing)}")
    if len(graph.entries) == 1:
        e = graph.entries[0]
        return {e.name: execute_stream_entry(
            e, trees[e.name], stage=stage, stage_chunk=stage_chunk,
            fused=fused, compiled=compiled, mesh=mesh, inkernel=inkernel)}

    runs = {e.name: _Replay(e, trees[e.name], stage=stage, fused=fused, compiled=compiled,
                            mesh=mesh, inkernel=inkernel)
            for e in graph.entries}
    for name, k in dispatch_schedule(graph, hw):
        if runs[name].buckets[k].numel():
            runs[name].step(k)
    return {name: run.finish() for name, run in runs.items()}
