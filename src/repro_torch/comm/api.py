"""Collective entry points on the emulated mesh.

Every function takes a rank-stacked value ``x`` of shape ``(n, *shape)``
(row ``r`` is rank ``r``'s buffer — what each rank passes inside the
reference's ``shard_map``), resolves a :class:`CollectivePlan` on the host
and replays it with the executors of :mod:`.executors`. The per-rank
payload ``M`` is one row's bytes, so the plans are the reference's plans.

The executors update the communicated buffer in place. Where the flat
buffer divides into the schedule's chunks and ``x`` is contiguous, that
buffer is ``x`` itself, so the caller's tensor holds the result; always use
the returned value. A compressed plan is the exception: it runs on an f32
copy of ``x`` (the reference's cast to the f32 wire domain), so ``x`` is
left as it was — the error-feedback update reads it after the sync.

:func:`pallgather` and :func:`preduce_scatter` change the shape:
``(n, *shard)`` → ``(n, n, *shard)``, and ``(n, *shape)`` → each rank's
flat shard ``(n, ceil(size / n))``.

``*_tree`` variants communicate a rank-stacked pytree through same-dtype
buckets (:mod:`repro_torch.core.bucketing`).
"""
from __future__ import annotations

import functools
from typing import Any, Sequence

import torch

from ..core import algorithms, bucketing
from ..core.tree import tree_map
from ..core.tuner import Tuner
from ..kernels.chunked_copy import chunked_copy
from .compress import CompressedWire, normalize_wire_format
from .executors import execute_collective, execute_compiled, execute_inkernel
from .plan import ONE_SHOT, CollectivePlan, plan_cached

__all__ = [
    "apply_plan",
    "pbcast",
    "preduce",
    "pallreduce",
    "pallgather",
    "preduce_scatter",
    "pbcast_tree",
    "pallreduce_tree",
    "hierarchical_allreduce_axes",
]

# unrolled-executor round budget before the auto policy switches to the
# compiled replay (the reference's policy, kept so both packages route every
# plan to the same executor). Zero-waste lowerings (the ring family,
# ring_allreduce included — per-round combine flags let both its phases
# share one fully-active class) switch much earlier: compiled then
# strictly dominates on both program size and wire bytes, so only the very
# smallest rings stay on the exact unrolled replay.
_MAX_UNROLLED_ROUNDS = 256
_MIN_COMPILED_ROUNDS_ZERO_WASTE = 8


def _use_compiled(plan: CollectivePlan, *, fused: bool, compiled: bool | None) -> bool:
    """Executor routing: an explicit ``compiled`` wins; then a tuned
    ``Decision.fused_path`` flag; then the round-count/zero-waste policy.
    ``fused=False`` forces the exact unrolled replay (the parity baseline).
    """
    if compiled is not None:
        return compiled
    if not fused:
        return False
    if plan.decision.fused_path is not None:
        return plan.decision.fused_path
    lowered = plan.lowered()
    if lowered is None or lowered.num_rounds == 0:
        return False
    if lowered.zero_waste:
        return lowered.num_rounds >= _MIN_COMPILED_ROUNDS_ZERO_WASTE
    return lowered.num_rounds > _MAX_UNROLLED_ROUNDS


_EXECUTORS = {
    "inkernel": execute_inkernel,
    "compiled": execute_compiled,
    "unrolled": execute_collective,
}


def _resolve_exec_path(
    plan: CollectivePlan,
    *,
    fused: bool = True,
    compiled: bool | None = None,
    inkernel: bool | None = None,
) -> str:
    """Three-tier executor routing: an explicit ``inkernel=`` flag wins;
    then a tuned ``Decision.exec_path``; then the compiled/unrolled policy
    (:func:`_use_compiled` — which itself honors an explicit ``compiled=``
    and ``Decision.fused_path``). Returns 'inkernel'|'compiled'|'unrolled'.

    The auto policy never picks inkernel on its own: the in-kernel executor
    enters only through the explicit flag or a tuned table entry.
    ``inkernel=False`` vetoes a tuned 'inkernel' without disturbing a tuned
    'compiled'/'unrolled'; an explicit ``compiled=`` bypasses the tuned tier
    entirely (it is a stronger, caller-level pin).

    Compressed wire formats veto the in-kernel path: the persistent kernel
    moves raw buffer blocks and has no quantize seam, so an explicit
    ``inkernel=True`` on a compressed plan raises, and a tuned 'inkernel'
    entry silently falls through to the compiled/unrolled policy (a stale
    table row must not disable compression).
    """
    compressed = plan.wire_format.compressed
    if inkernel:
        if compressed:
            raise ValueError(
                "the in-kernel executor does not support compressed wire "
                f"formats (plan wire_format={plan.wire_format.value!r}); "
                "use the compiled or unrolled executor"
            )
        return "inkernel"
    if compiled is None and fused:
        tuned = plan.decision.exec_path
        if tuned == "inkernel" and inkernel is None and not compressed:
            return "inkernel"
        if tuned in ("compiled", "unrolled"):
            return tuned
    return "compiled" if _use_compiled(plan, fused=fused, compiled=compiled) else "unrolled"


# Reduce-family combiners the comm layer understands. The schedule
# executors combine by sum only, and zero pad tails are only the identity
# for sum, so max/min take the one-shot reducers over the rank axis (the
# reference's pmax/pmin) and never grow a pad tail.
_COMBINERS = ("sum", "max", "min")
_ONE_SHOT_REDUCERS = {"max": torch.amax, "min": torch.amin}


def _check_combiner(combiner: str, op: str) -> None:
    if combiner not in _COMBINERS:
        raise ValueError(f"unknown combiner {combiner!r} for {op}; have {_COMBINERS}")


def _one_shot_reduce(x: torch.Tensor, combiner: str, algo: str, wire_format,
                     algos=("auto",)) -> torch.Tensor:
    """Every rank's row of the rank-stacked ``x`` combined by ``combiner``
    (max/min), on every row."""
    fmt = normalize_wire_format(wire_format)
    if fmt.compressed:
        raise ValueError(f"wire_format={fmt.value!r} supports the 'sum' combiner only "
                         "(non-sum combiners take the one-shots)")
    if algo not in algos:
        raise ValueError(f"combiner {combiner!r} supports algo in {algos} only, not {algo!r}")
    return _ONE_SHOT_REDUCERS[combiner](x, dim=0, keepdim=True).expand_as(x).clone()


def _chunked(flat: torch.Tensor, k: int, *, combiner: str | None = None,
             dtype: torch.dtype | None = None):
    """Pad + reshape a rank-stacked flat buffer ``(n, size)`` to
    ``(n, k, ceil(size/k))``. ``k`` is honored even when it exceeds the
    element count (tiny buffers pad up), because the schedule's chunk count
    is load-bearing for the executor. Zero padding is the identity for SUM
    only, so any other declared combiner refuses a pad tail. With ``dtype``
    the result is always a new buffer of that dtype (one cast copy, pad
    included); otherwise it is ``flat`` itself unless a pad tail forces a
    copy."""
    n, size = flat.shape
    k = max(1, k)
    chunk_elems = max(1, -(-size // k))
    pad = k * chunk_elems - size
    if pad and combiner is not None and combiner != "sum":
        raise ValueError(
            f"zero pad is only the identity for the 'sum' combiner, got {combiner!r}"
        )
    if dtype is not None:
        out = torch.empty((n, k * chunk_elems), dtype=dtype, device=flat.device)
        out[:, :size] = flat
        out[:, size:] = 0
        flat = out
    elif pad:
        flat = torch.cat([flat, flat.new_zeros((n, pad))], dim=1)
    return flat.reshape(n, k, chunk_elems), pad


def _unchunked(buf: torch.Tensor, pad: int, shape) -> torch.Tensor:
    out = buf.reshape(buf.shape[0], -1)
    if pad:
        out = out[:, : out.shape[1] - pad]
    return out.reshape(shape)


def _one_shot(plan: CollectivePlan, x: torch.Tensor) -> torch.Tensor:
    """The one-shot baselines as plain tensor ops over the rank axis (the
    reference lowers them to native XLA collectives); the bcast forms are
    :mod:`repro_torch.core.algorithms`' ``xla_*_bcast``."""
    if plan.op == "bcast":
        fn = (algorithms.xla_psum_bcast if plan.algo == "xla_psum"
              else algorithms.xla_allgather_bcast)
        return fn(x, root=plan.root)
    return algorithms._psum(x) if plan.algo == "xla_psum" else algorithms._all_gather(x)


def apply_plan(
    plan: CollectivePlan,
    x: torch.Tensor,
    *,
    fused: bool = True,
    compiled: bool | None = None,
    inkernel: bool | None = None,
) -> torch.Tensor:
    """Execute a pre-built :class:`CollectivePlan` on the rank-stacked ``x``
    — exactly the schedule the plan carries, no re-deciding.

    bcast/reduce/allreduce take and return ``(n, *shape)``; allgather takes
    the per-rank shards ``(n, *shard)`` and returns ``(n, n, *shard)``;
    reduce_scatter takes ``(n, *shape)`` and returns each rank's flat shard
    ``(n, ceil(size / n))``. Executor routing follows
    :func:`_resolve_exec_path`."""
    if x.shape[0] != plan.n:
        raise ValueError(f"value has {x.shape[0]} rank rows, plan is for n={plan.n}")
    if plan.algo == "noop":
        return x if plan.op != "allgather" else x[:, None]
    if plan.algo in ONE_SHOT:
        return _one_shot(plan, x)
    if plan.op not in ("bcast", "reduce", "allreduce", "allgather", "reduce_scatter"):
        raise NotImplementedError(f"ragged op {plan.op!r} is not ported yet: "
                                  'ROADMAP item "Ragged collectives and MoE"')
    sched = plan.schedule
    run = _EXECUTORS[_resolve_exec_path(plan, fused=fused, compiled=compiled,
                                        inkernel=inkernel)]
    wire_dtype = None
    if plan.wire_format.compressed:
        # the inkernel path is vetoed above; both remaining executors take
        # the wire seam, on an f32 copy of x (the reference's cast); the
        # result comes back in x's dtype
        run = functools.partial(run, wire=CompressedWire(plan.wire_format))
        wire_dtype = torch.float32
    n = plan.n
    flat = x.reshape(n, -1)
    ranks = torch.arange(n, device=x.device)
    if plan.op == "allgather":
        buf = torch.zeros((n, n, flat.shape[1]), dtype=wire_dtype or x.dtype, device=x.device)
        buf[ranks, ranks] = flat.to(buf.dtype)
        return run(sched, buf).reshape((n, n) + tuple(x.shape[1:])).to(x.dtype)
    if plan.op == "reduce_scatter":
        buf, _pad = _chunked(flat, n, combiner="sum", dtype=wire_dtype)
        return run(sched, buf)[ranks, ranks].to(x.dtype)
    combiner = "sum" if plan.op in ("reduce", "allreduce") else None
    buf, pad = _chunked(flat, sched.num_chunks, combiner=combiner, dtype=wire_dtype)
    return _unchunked(run(sched, buf), pad, x.shape).to(x.dtype)


def pbcast(
    x: torch.Tensor,
    *,
    root: int = 0,
    algo: str = "auto",
    num_chunks: int | None = None,
    tuner: Tuner | None = None,
    inter_pod: bool = False,
    fused: bool = True,
    compiled: bool | None = None,
    inkernel: bool | None = None,
    wire_format: str | None = None,
) -> torch.Tensor:
    """Broadcast row ``root`` of the rank-stacked ``x`` to every row (every
    rank passes a same-shape buffer and receives the root's).

    ``wire_format`` ('bf16'|'fp8'|'int8', default the full-precision
    passthrough) compresses every hop; compressed payloads travel in the f32
    wire domain (``M`` counts 4 bytes per element) and the result comes back
    in ``x``'s dtype."""
    n = x.shape[0]
    if n == 1:
        return x
    _check_one_shot(algo, wire_format)
    plan = plan_cached(
        "bcast", _payload_bytes(x, wire_format), n, root=root, algo=algo,
        num_chunks=num_chunks, tuner=tuner, inter_pod=inter_pod, wire_format=wire_format,
    )
    return apply_plan(plan, x, fused=fused, compiled=compiled, inkernel=inkernel)


def _payload_bytes(x: torch.Tensor, wire_format) -> int:
    """One rank's bytes ``M``: f32 (4 per element) under a compressed wire."""
    return x[0].numel() * (4 if normalize_wire_format(wire_format).compressed
                           else x.element_size())


def _check_one_shot(algo: str, wire_format) -> None:
    fmt = normalize_wire_format(wire_format)
    if algo in ONE_SHOT and fmt.compressed:
        raise ValueError(f"wire_format={fmt.value!r} requires a schedule-backed algo; "
                         f"the one-shot {algo!r} has no compression seam")


def preduce(
    x: torch.Tensor,
    *,
    root: int = 0,
    algo: str = "auto",
    num_chunks: int | None = None,
    tuner: Tuner | None = None,
    inter_pod: bool = False,
    combiner: str = "sum",
    compiled: bool | None = None,
    inkernel: bool | None = None,
    wire_format: str | None = None,
) -> torch.Tensor:
    """Reduce-to-root (``combiner``: sum by default) over the rank axis of
    ``x``. Non-root rows hold partial sums by design (MPI_Reduce
    semantics): only row ``root`` is meaningful. max/min take the one-shot
    reducer, which gives every row the result."""
    _check_combiner(combiner, "preduce")
    n = x.shape[0]
    if n == 1:
        return x
    if combiner != "sum":
        return _one_shot_reduce(x, combiner, algo, wire_format)
    plan = plan_cached("reduce", _payload_bytes(x, wire_format), n, root=root, algo=algo,
                       num_chunks=num_chunks, tuner=tuner, inter_pod=inter_pod,
                       wire_format=wire_format)
    return apply_plan(plan, x, compiled=compiled, inkernel=inkernel)


def pallreduce(
    x: torch.Tensor,
    *,
    algo: str = "auto",
    num_chunks: int | None = None,
    tuner: Tuner | None = None,
    inter_pod: bool = False,
    fused: bool = True,
    combiner: str = "sum",
    compiled: bool | None = None,
    inkernel: bool | None = None,
    wire_format: str | None = None,
) -> torch.Tensor:
    """All-reduce (``combiner``: sum by default) over the rank axis of
    ``x`` through the tuned plan layer. ``algo``: 'auto',
    'reduce_then_bcast', 'fused_rsb', 'ring_allreduce', or the one-shot
    'xla_psum'; max/min take the one-shot reducer. ``wire_format``
    compresses every hop (combine arithmetic stays f32)."""
    _check_combiner(combiner, "pallreduce")
    n = x.shape[0]
    if n == 1:
        return x
    if combiner != "sum":
        return _one_shot_reduce(x, combiner, algo, wire_format, ("auto", "xla_psum"))
    _check_one_shot(algo, wire_format)
    plan = plan_cached("allreduce", _payload_bytes(x, wire_format), n, algo=algo,
                       num_chunks=num_chunks, tuner=tuner, inter_pod=inter_pod,
                       wire_format=wire_format)
    return apply_plan(plan, x, fused=fused, compiled=compiled, inkernel=inkernel)


def pallgather(
    x: torch.Tensor,
    *,
    algo: str = "auto",
    tuner: Tuner | None = None,
    inter_pod: bool = False,
    compiled: bool | None = None,
    inkernel: bool | None = None,
    wire_format: str | None = None,
) -> torch.Tensor:
    """All-gather the per-rank shards ``x`` ``(n, *shard)``: every row of
    the result ``(n, n, *shard)`` holds all ranks' shards stacked (the
    ``lax.all_gather(axis=0)`` convention on each rank). ``algo``: 'auto',
    'ring_allgather', 'doubling_allgather' (power-of-two n), or the
    one-shot 'xla_allgather'."""
    n = x.shape[0]
    if n == 1:
        return x[:, None]
    _check_one_shot(algo, wire_format)
    # the full gathered payload; a compressed wire ships f32
    M = n * _payload_bytes(x, wire_format)
    plan = plan_cached("allgather", M, n, algo=algo, tuner=tuner, inter_pod=inter_pod,
                       wire_format=wire_format)
    return apply_plan(plan, x, compiled=compiled, inkernel=inkernel)


def preduce_scatter(
    x: torch.Tensor,
    *,
    algo: str = "auto",
    tuner: Tuner | None = None,
    inter_pod: bool = False,
    combiner: str = "sum",
    compiled: bool | None = None,
    inkernel: bool | None = None,
    wire_format: str | None = None,
) -> torch.Tensor:
    """Reduce-scatter (``combiner``: sum by default): every rank
    contributes its full buffer and receives its rank-indexed shard of the
    combined flat result, ``(n, ceil(size / n))`` (zero-padded tail on the
    last shard). max/min combine first through the one-shot reducer, then
    shard, so the pad tail is appended after the combine."""
    _check_combiner(combiner, "preduce_scatter")
    n = x.shape[0]
    flat = x.reshape(n, -1)
    if n == 1:
        return flat
    if combiner != "sum":
        full = _one_shot_reduce(flat, combiner, algo, wire_format)
        buf, _pad = _chunked(full, n)
        ranks = torch.arange(n, device=x.device)
        return buf[ranks, ranks]
    plan = plan_cached("reduce_scatter", _payload_bytes(x, wire_format), n, algo=algo,
                       tuner=tuner, inter_pod=inter_pod, wire_format=wire_format)
    if plan.algo == "noop":
        return flat
    return apply_plan(plan, x, compiled=compiled, inkernel=inkernel)


def _check_one_axis(axes: Sequence) -> tuple:
    axes = tuple(axes)
    if len(axes) > 1:
        raise NotImplementedError(
            f"a hierarchical collective over {axes}: the emulated mesh has one data "
            'axis; multi-level meshes are ROADMAP item "Serving remainder and '
            'hierarchical meshes"')
    return axes


def _tree_collective(op_fn, tree, *, bucket_bytes, stage, **kw):
    spec = bucketing.plan_buckets(_rank_view(tree), bucket_bytes)
    out = []
    for b in bucketing.pack_buckets(tree, spec):
        if b.shape[-1]:
            if stage:
                b = chunked_copy(b.reshape(-1)).view(b.shape)
            b = op_fn(b, **kw)
        out.append(b)
    return bucketing.unpack_buckets(out, spec)


def _rank_view(tree):
    """One rank's leaves (row 0): the per-rank shapes buckets are planned on."""
    return tree_map(lambda t: t[0], tree)


def pbcast_tree(
    tree: Any,
    *,
    root: int = 0,
    algo: str = "auto",
    tuner: Tuner | None = None,
    bucket_bytes: int = 4 << 20,
    inter_pod: bool = False,
    stage: bool = False,
    stage_chunk: int = 64 * 1024,
) -> Any:
    """Broadcast a rank-stacked pytree via same-dtype buckets, each tuned
    independently (``inter_pod`` prices every bucket on the inter-pod
    path). ``stage=True`` first copies each non-empty packed bucket through
    the ``chunked_copy`` kernel (the paper's pipelined staging copy, Sec.
    IV-C), one launch a bucket; ``stage_chunk``, the reference's chunk of
    that copy, is accepted and ignored, as ``chunked_copy(chunk_elems=)``
    ignores it."""
    return _tree_collective(pbcast, tree, bucket_bytes=bucket_bytes, stage=stage, root=root,
                            algo=algo, tuner=tuner, inter_pod=inter_pod)


def pallreduce_tree(
    tree: Any,
    axes: Sequence,
    *,
    algo: str = "auto",
    tuner: Tuner | None = None,
    bucket_bytes: int = 4 << 20,
    inter_pod_axes: Sequence = (),
    stage: bool = False,
    stage_chunk: int = 64 * 1024,
    compiled: bool | None = None,
    wire_format: str | None = None,
) -> Any:
    """Bucketed all-reduce of a rank-stacked pytree over the mesh axes
    ``axes`` (:func:`hierarchical_allreduce_axes` order). The emulated mesh
    has one data axis, so ``axes`` names at most one; ``wire_format``
    applies to every bucket. ``stage`` and ``stage_chunk`` act as in
    :func:`pbcast_tree`."""
    axes = _check_one_axis(axes)
    if not axes:
        return tree
    return _tree_collective(
        pallreduce, tree, bucket_bytes=bucket_bytes, stage=stage, algo=algo, tuner=tuner,
        inter_pod=axes[0] in tuple(inter_pod_axes), compiled=compiled, wire_format=wire_format,
    )


def hierarchical_allreduce_axes(mesh) -> tuple:
    """Axis order for hierarchical allreduce: intra-pod data axes first,
    then the inter-pod level (the reverse of ``topology.bcast_axes``)."""
    from ..dist import topology

    return tuple(reversed(topology.bcast_axes(mesh)))
