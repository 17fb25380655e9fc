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
flat shard ``(n, ceil(size / n))``. The ragged :func:`pallgatherv` and
:func:`palltoallv` move rows of variable count per rank (see each).

``*_tree`` variants communicate a rank-stacked pytree through same-dtype
buckets (:mod:`repro_torch.core.bucketing`).
"""
from __future__ import annotations

import functools
import math
import time
from typing import Any, Sequence

import numpy as np
import torch

from ..core import algorithms, bucketing
from ..core.tree import tree_map
from ..core.tuner import Tuner
from ..kernels.chunked_copy import chunked_copy
from .compress import CompressedWire, normalize_wire_format
from .executors import execute_collective, execute_compiled, execute_inkernel
from .faults import FallbackExhaustedError, FaultError
from .plan import ONE_SHOT, CollectivePlan, plan_cached
from .resilience import FallbackEvent, FallbackPolicy
from .schedules import alltoallv_matrix

__all__ = [
    "apply_plan",
    "apply_plan_resilient",
    "pbcast",
    "preduce",
    "pallreduce",
    "pallgather",
    "pallgatherv",
    "palltoallv",
    "preduce_scatter",
    "pbcast_tree",
    "pallreduce_tree",
    "hierarchical_allreduce_axes",
    "level_replay",
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


class ExecutorRefusal(ValueError):
    """An executor declining a plan before it launches anything: the
    in-kernel executor's veto of a compressed wire, and on the card the
    plain tensor-op stages of :func:`apply_plan_resilient`. It is the one
    failure on which the chain degrades a CUDA replay (a ``ValueError``, as
    the veto has always been)."""


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
            raise ExecutorRefusal(
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


# ---------------------------------------------------------------------------
# ragged layout tables (host-side numpy, lifted to device index tensors once
# per call)
#
# The ragged schedules move rows of one global (total_rows, elems) frame
# whose layout is fixed by the size vector: allgatherv concatenates the
# per-rank segments in rank order; alltoallv lays the n^2 blocks out
# row-major by (src, dst). The entry points scatter each rank's rows into
# its row of the rank-stacked frame (n, total_rows, elems), replay the
# schedule, and gather each rank's result back out.
# ---------------------------------------------------------------------------


def _gatherv_tables(sizes, n: int):
    """allgatherv scatter layout: global row ``g`` is owned by rank
    ``src_of[g]`` and lives at row ``loc[g]`` of that rank's local shard."""
    sz = np.asarray(sizes, dtype=np.int64)
    off = np.concatenate([[0], np.cumsum(sz)])
    src_of = np.repeat(np.arange(n, dtype=np.int64), sz)
    loc = np.arange(int(off[-1]), dtype=np.int64) - off[src_of]
    return src_of, loc


def _a2av_tables(m: np.ndarray, n: int, *, in_padded: bool, out_padded: bool,
                 in_rows: int):
    """alltoallv scatter/gather layout for block matrix ``m`` (rows rank s
    sends to rank d). Returns host arrays:

    - ``src_of[g]``/``loc[g]``: global row ``g`` (row-major (s, d) blocks)
      is owned by rank ``src_of[g]`` at local row ``loc[g]``. For compact
      inputs ``loc`` indexes the destination-major concatenation; for padded
      inputs it indexes the flattened ``(n, in_rows)`` block layout.
    - ``gidx``/``gvalid``: per-rank output gather table. Row ``i`` of rank
      r's output is global row ``gidx[r, i]`` where ``gvalid[r, i]``, zero
      elsewhere. Compact outputs are the source-major concatenation (width
      ``max_r recv_r``); padded outputs are ``(n, bmax)`` blocks with each
      incoming block at a valid prefix (``bmax = m.max()``).
    """
    total = int(m.sum())
    boff = np.concatenate([[0], np.cumsum(m.reshape(-1))])
    bmax = int(m.max())
    recv = m.sum(axis=0)
    in_off = np.concatenate([np.zeros((n, 1), np.int64), np.cumsum(m, axis=1)], axis=1)
    src_of = np.repeat(np.arange(n * n, dtype=np.int64) // n, m.reshape(-1))
    loc = np.zeros(total, dtype=np.int64)
    for s in range(n):
        for d in range(n):
            b = s * n + d
            j = np.arange(int(m[s, d]), dtype=np.int64)
            loc[boff[b]:boff[b + 1]] = (d * in_rows + j) if in_padded else (in_off[s, d] + j)
    out_rows = n * bmax if out_padded else max(int(recv.max()), 1)
    gidx = np.zeros((n, out_rows), dtype=np.int64)
    gvalid = np.zeros((n, out_rows), dtype=bool)
    for r in range(n):
        pos = 0
        for s in range(n):
            b = s * n + r
            h = int(m[s, r])
            lo = s * bmax if out_padded else pos
            gidx[r, lo:lo + h] = np.arange(boff[b], boff[b] + h)
            gvalid[r, lo:lo + h] = True
            pos += h
    return src_of, loc, gidx, gvalid, bmax


def _ragged_scatter(x2d: torch.Tensor, src_of, loc) -> torch.Tensor:
    """The rank-stacked global frame ``(n, total_rows, elems)``: each rank's
    own rows in place, zeros elsewhere (the executors' pre-condition for
    ragged ops). ``x2d`` is ``(n, local_rows, elems)``; one ``index_put_``."""
    n, _rows, elems = x2d.shape
    total = len(src_of)
    frame = torch.zeros((n, total, elems), dtype=x2d.dtype, device=x2d.device)
    src = torch.from_numpy(src_of).to(x2d.device)
    rows = torch.arange(total, device=x2d.device)
    frame.index_put_((src, rows), x2d[src, torch.from_numpy(loc).to(x2d.device)])
    return frame


def _run_allgatherv(plan: CollectivePlan, x: torch.Tensor, run) -> torch.Tensor:
    n, total = plan.n, sum(plan.sizes)
    src_of, loc = _gatherv_tables(plan.sizes, n)
    frame = _ragged_scatter(x.reshape(n, x.shape[1], -1), src_of, loc)
    return run(plan.schedule, frame).reshape((n, total) + tuple(x.shape[2:]))


def _run_alltoallv(plan: CollectivePlan, x: torch.Tensor, run, *, in_padded: bool,
                   out_padded: bool) -> torch.Tensor:
    n = plan.n
    m = np.asarray(plan.sizes, dtype=np.int64).reshape(n, n)
    elem = tuple(x.shape[3:]) if in_padded else tuple(x.shape[2:])
    if in_padded and x.shape[1] != n:
        raise ValueError(f"in_padded alltoallv expects a (n={n}, bmax, ...) "
                         f"block layout, got leading dim {x.shape[1]}")
    in_rows = x.shape[2] if in_padded else x.shape[1]
    src_of, loc, gidx, gvalid, bmax = _a2av_tables(
        m, n, in_padded=in_padded, out_padded=out_padded, in_rows=int(in_rows))
    need = bmax if in_padded else int(m.sum(axis=1).max())
    if in_rows < need:
        raise ValueError(
            f"alltoallv input has {in_rows} rows per "
            f"{'block' if in_padded else 'rank'}, size matrix needs {need}")
    x3 = x.reshape(n, -1, math.prod(elem) if elem else 1)
    out = run(plan.schedule, _ragged_scatter(x3, src_of, loc))
    # each rank's rows out of the frame, then the frame goes; no second copy
    ranks = torch.arange(n, device=x.device)[:, None]
    picked = out[ranks, torch.from_numpy(gidx).to(x.device)]
    del out
    picked.masked_fill_(~torch.from_numpy(gvalid).to(x.device)[..., None], 0)
    if out_padded:
        return picked.reshape((n, n, bmax) + elem)
    return picked.reshape((n, picked.shape[1]) + elem)


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
    ``(n, ceil(size / n))``. The ragged ops use the compact conventions:
    allgatherv takes the valid-prefix row shards ``(n, rows, *elem)`` and
    returns the ``(n, sum(sizes), *elem)`` concatenation; alltoallv takes
    the destination-major compact rows and returns the source-major compact
    rows (use :func:`palltoallv` for the padded block layouts). Executor
    routing follows :func:`_resolve_exec_path`."""
    if x.shape[0] != plan.n:
        raise ValueError(f"value has {x.shape[0]} rank rows, plan is for n={plan.n}")
    if plan.algo == "noop":
        if plan.op in ("allgatherv", "alltoallv"):
            # n == 1: the rank's valid prefix IS the result (alltoallv's
            # 1x1 block matrix degenerates to the same slice)
            return x[:, : plan.sizes[0]]
        return x if plan.op != "allgather" else x[:, None]
    if plan.algo in ONE_SHOT:
        return _one_shot(plan, x)
    sched = plan.schedule
    run = _EXECUTORS[_resolve_exec_path(plan, fused=fused, compiled=compiled,
                                        inkernel=inkernel)]
    # the ragged ops move rows; their plans never compress (plan_collective)
    if plan.op == "allgatherv":
        return _run_allgatherv(plan, x, run)
    if plan.op == "alltoallv":
        return _run_alltoallv(plan, x, run, in_padded=False, out_padded=False)
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


def _one_shot_fallback(plan: CollectivePlan, x: torch.Tensor) -> torch.Tensor:
    """Terminal fallback stage: the plan's op as plain tensor ops over the
    rank axis (the reference's single native XLA collective), bypassing
    the schedule executors. Returns :func:`apply_plan`'s shapes. The ragged
    ops have no one-shot (variable per-rank shapes): they raise, and the
    chain reports them as exhausted."""
    op = plan.op
    if op == "bcast":
        return algorithms.xla_psum_bcast(x, root=plan.root)
    if op in ("reduce", "allreduce"):
        return algorithms._psum(x)
    if op == "allgather":
        return algorithms._all_gather(x)
    if op == "reduce_scatter":
        n = x.shape[0]
        buf, _pad = _chunked(algorithms._psum(x.reshape(n, -1)), n, combiner="sum")
        ranks = torch.arange(n, device=x.device)
        return buf[ranks, ranks]
    raise RuntimeError(f"no one-shot collective implements ragged op {op!r}")


def _card_stream(x):
    """The current CUDA stream of ``x``'s device, or None for a host buffer
    (or the reference's shape-only placeholder)."""
    if isinstance(x, torch.Tensor) and x.is_cuda:
        return torch.cuda.current_stream(x.device)
    return None


def apply_plan_resilient(
    plan: CollectivePlan,
    x: torch.Tensor,
    *,
    policy=None,
    watchdog=None,
    fused: bool = True,
    on_event=None,
) -> torch.Tensor:
    """:func:`apply_plan` behind a typed fallback chain.

    Walks ``policy.chain`` (default inkernel -> compiled -> unrolled ->
    one-shot, :data:`~.resilience.DEFAULT_CHAIN`) with per-stage retries
    and exponential backoff; the first stage that completes wins. Each stage
    pins its executor (``inkernel=True`` for the head; ``inkernel=False``
    and an explicit ``compiled`` below it, so a tuned ``exec_path`` cannot
    route a degraded stage back onto the executor that just failed).
    Typed :class:`~.faults.FaultError`\\ s propagate at once (they are
    diagnoses with recovery actions, not transient failures); on the host
    any other exception burns a retry and then degrades the chain (on the
    card only a typed refusal does, below). A completed
    attempt slower than ``policy.timeout_s`` still returns its result but
    is flagged a straggler, to ``watchdog`` (which can land it in
    ``Tuner.record``) and to ``on_event``. All stages failing raises
    :class:`~.faults.FallbackExhaustedError` naming every cause.

    Adaptations to the card and to executors that update their buffer in
    place:

    * every attempt runs on its own copy of ``x`` (made before its clock
      starts), so ``x`` is left as it was and an attempt that fails midway
      never hands a half-replayed buffer to the next stage;
    * when ``x`` is on CUDA, each attempt ends with a synchronize of the
      current stream inside the ``try``: ``elapsed_s``, the ``timeout_s``
      test and ``Watchdog.observe`` see the replay's time, not the time to
      enqueue it, and an error CUDA reports asynchronously is raised in the
      stage that caused it;
    * when ``x`` is on CUDA, the chain degrades only on an executor's typed
      :class:`ExecutorRefusal` (the in-kernel veto of a compressed wire),
      which burns retries as any failure does on the host. Any other
      exception (a kernel that does not build or launch, a device error)
      propagates at once, as a ``FaultError`` does, so a kernel failure is
      never served by a plain version. For the same reason the plain
      tensor-op stages, ``'unrolled'`` on an uncompressed wire and the
      one-shot ``'xla'``, refuse a CUDA buffer: on the card the chain is
      served by the kernel stages or ends in ``FallbackExhaustedError``.
      On the host every stage runs and every exception degrades, as in the
      reference.

    The reference's contract holds either way: a result bit-identical to
    the oracle or a typed error, never a silent wrong answer. The chain is
    opt-in, as in the reference: no trainer, engine or entry point routes
    through it."""
    policy = policy or FallbackPolicy()
    stream = _card_stream(x)
    causes: list[str] = []

    def sync() -> None:
        if stream is not None:
            stream.synchronize()

    for stage in policy.chain:
        delay = policy.backoff_s
        plain = stage == "xla" or (stage == "unrolled" and not plan.wire_format.compressed)
        for attempt in range(policy.max_retries + 1):
            t0 = time.perf_counter()
            try:
                if stream is not None and plain:
                    raise ExecutorRefusal(
                        f"the {stage!r} stage replays with plain tensor ops; on the card "
                        "the chain is served by a kernel stage only")
                arg = x.clone() if isinstance(x, torch.Tensor) else x
                sync()
                t0 = time.perf_counter()
                if stage == "xla":
                    out = _one_shot_fallback(plan, arg)
                else:
                    out = apply_plan(
                        plan, arg, fused=fused,
                        compiled=None if stage == "inkernel" else stage == "compiled",
                        inkernel=stage == "inkernel",
                    )
                sync()
            except FaultError:
                raise
            except Exception as e:  # noqa: BLE001 — the chain is the handler
                if stream is not None and not isinstance(e, ExecutorRefusal):
                    raise
                dt = time.perf_counter() - t0
                arg = None  # the failed attempt's copy goes before the next is made
                causes.append(f"{stage}[{attempt}]: {type(e).__name__}: {e}")
                if on_event is not None:
                    on_event(FallbackEvent(stage, attempt, "error", dt, repr(e)))
                if attempt < policy.max_retries:
                    time.sleep(delay)
                    delay *= policy.backoff_mult
                continue
            dt = time.perf_counter() - t0
            straggled = policy.timeout_s is not None and dt > policy.timeout_s
            if on_event is not None:
                on_event(FallbackEvent(stage, attempt, "straggler" if straggled else "ok", dt))
            if watchdog is not None:
                watchdog.observe(plan, dt)
            return out
    raise FallbackExhaustedError(
        f"every fallback stage failed for {plan.op}/{plan.algo} "
        f"(M={plan.M}, n={plan.n}): " + "; ".join(causes)
    )


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


# ---------------------------------------------------------------------------
# ragged collectives (allgatherv / alltoallv — MPI_Allgatherv/MPI_Alltoallv
# analogues on the schedule IR; the MoE expert-dispatch transport)
# ---------------------------------------------------------------------------


def pallgatherv(
    x: torch.Tensor,
    *,
    sizes: Sequence[int],
    algo: str = "auto",
    tuner: Tuner | None = None,
    inter_pod: bool = False,
    fused: bool = True,
    compiled: bool | None = None,
    inkernel: bool | None = None,
) -> torch.Tensor:
    """Ragged all-gather: rank ``r`` contributes the first ``sizes[r]`` rows
    of its row ``x[r]`` (rows beyond the valid prefix are ignored) and every
    rank receives the ``(sum(sizes), *elem)`` concatenation in rank order.

    ``x`` is ``(n, rows, *elem)`` with ``rows >= max(sizes)``; the result
    is ``(n, sum(sizes), *elem)``. Zero-sized ranks are fine — they
    contribute nothing but still receive the full result. ``algo``:
    'auto', 'ring_allgatherv', or 'doubling_allgatherv' (power-of-two n);
    'auto' routes through the skew-aware tuner (``Tuner.select(...,
    sizes=)``).
    """
    n = x.shape[0]
    sz = tuple(int(s) for s in sizes)
    if len(sz) != n:
        raise ValueError(f"allgatherv sizes has {len(sz)} entries for axis size {n}")
    if any(s < 0 for s in sz) or sum(sz) == 0:
        raise ValueError(f"allgatherv sizes must be non-negative and non-empty: {sz}")
    if x.dim() < 2 or x.shape[1] < max(sz):
        raise ValueError(
            f"allgatherv input has {x.shape[1] if x.dim() > 1 else 0} rows, "
            f"size vector needs max(sizes)={max(sz)}")
    total = sum(sz)
    if n == 1:
        return x[:, : sz[0]]
    elems = math.prod(x.shape[2:])
    if elems == 0:
        return x.new_zeros((n, total) + tuple(x.shape[2:]))
    M = total * elems * x.element_size()
    plan = plan_cached("allgatherv", M, n, algo=algo, tuner=tuner, inter_pod=inter_pod,
                       sizes=sz)
    return apply_plan(plan, x, fused=fused, compiled=compiled, inkernel=inkernel)


def palltoallv(
    x: torch.Tensor,
    *,
    sizes,
    algo: str = "auto",
    tuner: Tuner | None = None,
    inter_pod: bool = False,
    in_padded: bool = False,
    out_padded: bool = False,
    fused: bool = True,
    compiled: bool | None = None,
    inkernel: bool | None = None,
) -> torch.Tensor:
    """Ragged all-to-all: ``sizes`` gives the block matrix ``m[s][d]`` (rows
    rank ``s`` sends to rank ``d``) as an n x n nested sequence, a flat
    row-major n^2 vector, or a length-n per-destination vector (every source
    sends the same counts). Rank ``r`` sends block ``m[r][d]`` to each
    ``d`` and receives block ``m[s][r]`` from each ``s``.

    Layouts, rank-stacked (row ``r`` of each is rank ``r``'s):

    - compact in (default): ``x`` is ``(n, rows, *elem)``, each rank's
      destination-major concatenation — its first ``sum_d m[r][d]`` rows are
      the blocks for d=0..n-1 back-to-back; ``rows >= max_r sum_d m[r][d]``.
    - padded in (``in_padded=True``): ``x`` is ``(n, n, bmax_in, *elem)``
      with rank r's block for destination ``d`` at ``x[r, d, :m[r][d]]``.
    - compact out (default): ``(n, max_r sum_s m[s][r], *elem)``, each
      rank's source-major concatenation, zero beyond its valid prefix.
    - padded out (``out_padded=True``): ``(n, n, max(m), *elem)`` with the
      block from source ``s`` at ``out[r, s, :m[s][r]]``, zeros elsewhere.

    The padded layouts keep per-rank shapes uniform when block heights vary
    per rank — the MoE expert-dispatch contract. ``algo``: 'auto',
    'pairwise_alltoallv', or 'ring_alltoallv' (store-and-forward).
    """
    n = x.shape[0]
    m = alltoallv_matrix(sizes, n)
    flat = tuple(v for row in m for v in row)
    total = sum(flat)
    if total == 0:
        raise ValueError("alltoallv size matrix is all zeros")
    elem = tuple(x.shape[3:]) if in_padded else tuple(x.shape[2:])
    elems = math.prod(elem)
    if n == 1:
        c = m[0][0]
        if in_padded:
            return x[:, :, :c] if out_padded else x[:, 0, :c]
        return x[:, :c][:, None] if out_padded else x[:, :c]
    if elems == 0:
        bmax = max(flat)
        rmax = max(sum(m[s][r] for s in range(n)) for r in range(n))
        shape = ((n, n, bmax) + elem) if out_padded else ((n, rmax) + elem)
        return x.new_zeros(shape)
    M = total * elems * x.element_size()
    plan = plan_cached("alltoallv", M, n, algo=algo, tuner=tuner, inter_pod=inter_pod,
                       sizes=flat)
    run = _EXECUTORS[_resolve_exec_path(plan, fused=fused, compiled=compiled,
                                        inkernel=inkernel)]
    return _run_alltoallv(plan, x, run, in_padded=in_padded, out_padded=out_padded)


def _levels(axes: Sequence, mesh, x: torch.Tensor | None = None) -> tuple:
    """``axes`` as a tuple, checked against ``mesh``: every axis must be one
    of the mesh's, and a value stacked over it must have ``mesh.size`` rank
    rows. Without a mesh the rank rows are one axis, so ``axes`` may name
    at most one."""
    axes = tuple(axes)
    if mesh is None:
        if len(axes) > 1:
            raise ValueError(f"a collective over the axes {axes} needs the mesh (mesh=) "
                             "to lay its ranks out")
        return axes
    missing = [a for a in axes if a not in tuple(mesh.axis_names)]
    if missing:
        raise ValueError(f"mesh has no axis {missing[0]!r}: {tuple(mesh.axis_names)}")
    if x is not None and x.shape[0] != mesh.size:
        raise ValueError(f"value has {x.shape[0]} rank rows, the mesh {mesh.size} ranks")
    return axes


def level_replay(x: torch.Tensor, axis, fn, *, mesh=None, out=None) -> torch.Tensor:
    """One level of a multi-level collective: ``fn`` (a one-axis collective
    of a rank-stacked ``(axis_size, *shape)`` value, such as
    ``functools.partial(apply_plan, plan)``) run on every group of ranks
    along ``axis`` of the ``mesh``-stacked ``x`` ``(mesh.size, *shape)``.

    A group is the ranks whose coordinates on the other axes agree: what
    one device's ``shard_map`` body sees of the axis in the reference. Each
    group replays on its own ``(axis_size, *shape)`` frame, so every sum is
    taken in the reference's order and each plan's message size is one
    rank's row. The groups of the innermost axis are runs of consecutive
    rows, and their frames are views of ``x``; the groups of an outer axis
    are strided (rows ``d, d + D, ...`` for the pod axis of a ('pod',
    'data') mesh), so each is gathered into a contiguous frame (one copy of
    its rows) and its result scattered back (a second copy): the kernels
    see the frames a one-axis mesh gives them, and one group's frame is the
    only buffer the level adds. A level of one rank is ``x`` itself.

    Without ``mesh`` (or on a one-axis mesh) the rank rows are the one
    axis and this is ``fn(x)``. Otherwise, when ``fn`` updates its frame in
    place, the result is ``x`` so updated; when it returns new buffers (a
    compressed wire, a padded buffer), every group's result is written
    into ``out`` (default a new tensor, ``x`` left as it was; pass ``out=x``
    when ``x`` may be overwritten), which is returned. A result whose rows
    differ in shape from ``x``'s (an all-gather's ``(A, A, *shape)``) is
    written into a new ``(mesh.size, A, *shape)`` tensor (or ``out`` of
    that shape): row ``r`` what rank ``r``'s group handed it."""
    if mesh is None or len(tuple(mesh.axis_names)) == 1:
        return fn(x)
    names, shape = tuple(mesh.axis_names), tuple(mesh.devices.shape)
    _levels((axis,), mesh, x)
    i = names.index(axis)
    A, outer, inner = shape[i], math.prod(shape[:i]), math.prod(shape[i + 1:])
    if A == 1:
        return x
    x = x.contiguous()
    rest = tuple(x.shape[1:])
    view = x.view(outer, A, inner, -1)
    dst = None  # the result, once the first group tells in place from new
    for o in range(outer):
        for j in range(inner):
            src = view[o, :, j]
            frame = src if inner == 1 else src.contiguous()
            res = fn(frame.view((A,) + rest))
            fresh = res.data_ptr() != frame.data_ptr()
            if dst is None:
                shape_out = (x.shape[0],) + tuple(res.shape[1:]) if fresh else x.shape
                dst = view if not fresh else (
                    x.new_empty(shape_out) if out is None else out).view(outer, A, inner, -1)
            target = dst[o, :, j]
            if fresh:
                target.copy_(res.reshape(A, -1))
            elif target.data_ptr() != frame.data_ptr():
                target.copy_(frame)
            del res, frame
    return dst.view(shape_out)


def _tree_collective(op_fn, tree, *, bucket_bytes, stage, levels, mesh, **kw):
    """``op_fn(bucket, **kw, **level_kw)`` over every non-empty bucket of the
    rank-stacked ``tree``, one level after another: ``levels`` holds each
    level's ``(axis, level_kw)`` (axis ``None``: the rank rows as one
    axis)."""
    spec = bucketing.plan_buckets(_rank_view(tree), bucket_bytes)
    out = []
    for b in bucketing.pack_buckets(tree, spec):
        if b.shape[-1]:
            if stage:
                b = chunked_copy(b.reshape(-1)).view(b.shape)
            for ax, lkw in levels:
                b = level_replay(b, ax, functools.partial(op_fn, **kw, **lkw), mesh=mesh)
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
    axis: str | None = None,
    mesh=None,
) -> Any:
    """Broadcast a rank-stacked pytree via same-dtype buckets, each tuned
    independently (``inter_pod`` prices every bucket on the inter-pod
    path). ``stage=True`` first copies each non-empty packed bucket through
    the ``chunked_copy`` kernel (the paper's pipelined staging copy, Sec.
    IV-C), one launch a bucket; ``stage_chunk``, the reference's chunk of
    that copy, is accepted and ignored, as ``chunked_copy(chunk_elems=)``
    ignores it. On a multi-axis ``mesh`` the broadcast runs over its
    ``axis`` (the reference's ``axis_name``), every group of ranks along it
    from its own root (:func:`level_replay`)."""
    if mesh is not None and len(tuple(mesh.axis_names)) > 1 and axis is None:
        raise ValueError("pbcast_tree on a multi-axis mesh needs the axis (axis=)")
    _levels(() if axis is None else (axis,), mesh)
    return _tree_collective(pbcast, tree, bucket_bytes=bucket_bytes, stage=stage,
                            levels=((axis, {}),), mesh=mesh, root=root, algo=algo,
                            tuner=tuner, inter_pod=inter_pod)


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
    mesh=None,
    inkernel: bool | None = None,
) -> Any:
    """Bucketed all-reduce of a rank-stacked pytree over the mesh axes
    ``axes``, one level after another in the given order
    (:func:`hierarchical_allreduce_axes` gives the intra-pod-first one);
    an axis named in ``inter_pod_axes`` is priced with the inter-pod
    constants. The tree is packed into buckets once and every level runs
    over the packed buffers, each on every group of ranks along its axis
    (:func:`level_replay`). Over more than one axis the leaves are stacked
    over ``mesh``'s ranks and ``mesh`` is required. ``wire_format`` applies
    to every bucket at every level; ``stage`` and ``stage_chunk`` act as in
    :func:`pbcast_tree`; ``compiled`` and ``inkernel`` route every level's
    replay as :func:`apply_plan`'s do."""
    axes = _levels(axes, mesh)
    if not axes:
        return tree
    inter = tuple(inter_pod_axes)
    levels = tuple((ax, {"inter_pod": ax in inter}) for ax in axes)
    return _tree_collective(
        pallreduce, tree, bucket_bytes=bucket_bytes, stage=stage, levels=levels, mesh=mesh,
        algo=algo, tuner=tuner, compiled=compiled, inkernel=inkernel, wire_format=wire_format,
    )


def hierarchical_allreduce_axes(mesh) -> tuple:
    """Axis order for hierarchical allreduce: intra-pod data axes first,
    then the inter-pod level (the reverse of ``topology.bcast_axes``)."""
    from ..dist import topology

    return tuple(reversed(topology.bcast_axes(mesh)))
