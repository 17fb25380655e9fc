"""Collective entry points on the emulated mesh.

Every function takes a rank-stacked value ``x`` of shape ``(n, *shape)``
(row ``r`` is rank ``r``'s buffer — what each rank passes inside the
reference's ``shard_map``), resolves a :class:`CollectivePlan` on the host
and replays it with the executors of :mod:`.executors`. The per-rank
payload ``M`` is one row's bytes, so the plans are the reference's plans.

The executors update the communicated buffer in place. Where the flat
buffer divides into the schedule's chunks and ``x`` is contiguous, that
buffer is ``x`` itself, so the caller's tensor holds the result; always use
the returned value.
"""
from __future__ import annotations

import torch

from ..core.tuner import Tuner
from .compress import normalize_wire_format
from .executors import execute_collective, execute_compiled, execute_inkernel
from .plan import ONE_SHOT, CollectivePlan, plan_cached

__all__ = ["apply_plan", "pbcast"]

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


def _chunked(flat: torch.Tensor, k: int, *, combiner: str | None = None):
    """Pad + reshape a rank-stacked flat buffer ``(n, size)`` to
    ``(n, k, ceil(size/k))``. ``k`` is honored even when it exceeds the
    element count (tiny buffers pad up), because the schedule's chunk count
    is load-bearing for the executor. Zero padding is the identity for SUM
    only, so any other declared combiner refuses a pad tail."""
    n, size = flat.shape
    k = max(1, k)
    chunk_elems = max(1, -(-size // k))
    pad = k * chunk_elems - size
    if pad:
        if combiner is not None and combiner != "sum":
            raise ValueError(
                f"zero pad is only the identity for the 'sum' combiner, got {combiner!r}"
            )
        flat = torch.cat([flat, flat.new_zeros((n, pad))], dim=1)
    return flat.reshape(n, k, chunk_elems), pad


def _unchunked(buf: torch.Tensor, pad: int, shape) -> torch.Tensor:
    out = buf.reshape(buf.shape[0], -1)
    if pad:
        out = out[:, : out.shape[1] - pad]
    return out.reshape(shape)


def _one_shot(plan: CollectivePlan, x: torch.Tensor) -> torch.Tensor:
    """The one-shot baselines as plain tensor ops over the rank axis (the
    reference lowers them to native XLA collectives)."""
    n = x.shape[0]
    if plan.algo == "xla_psum":
        if plan.op == "bcast":  # mask non-root contributions, then sum
            keep = (torch.arange(n, device=x.device) == plan.root).reshape(
                (n,) + (1,) * (x.dim() - 1))
            x = torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=x.device))
        return x.sum(0, keepdim=True).expand_as(x).clone()
    if plan.op == "bcast":  # xla_allgather: gather, select the root's slice
        return x[plan.root:plan.root + 1].expand_as(x).clone()
    return x.unsqueeze(0).expand((n,) + tuple(x.shape)).clone()


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
    if plan.wire_format.compressed:
        raise NotImplementedError(
            f"wire format {plan.wire_format.value!r} needs the quantize kernels, "
            "not ported yet: ROADMAP B.5"
        )
    if plan.op not in ("bcast", "reduce", "allreduce", "allgather", "reduce_scatter"):
        raise NotImplementedError(f"ragged op {plan.op!r} is not ported yet: ROADMAP A.8")
    sched = plan.schedule
    run = _EXECUTORS[_resolve_exec_path(plan, fused=fused, compiled=compiled,
                                        inkernel=inkernel)]
    n = plan.n
    flat = x.reshape(n, -1)
    ranks = torch.arange(n, device=x.device)
    if plan.op == "allgather":
        buf = flat.new_zeros((n, n, flat.shape[1]))
        buf[ranks, ranks] = flat
        return run(sched, buf).reshape((n, n) + tuple(x.shape[1:]))
    if plan.op == "reduce_scatter":
        buf, _pad = _chunked(flat, n, combiner="sum")
        return run(sched, buf)[ranks, ranks]
    combiner = "sum" if plan.op in ("reduce", "allreduce") else None
    buf, pad = _chunked(flat, sched.num_chunks, combiner=combiner)
    return _unchunked(run(sched, buf), pad, x.shape)


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
    rank passes a same-shape buffer and receives the root's)."""
    n = x.shape[0]
    if n == 1:
        return x
    fmt = normalize_wire_format(wire_format)
    M = x[0].numel() * (4 if fmt.compressed else x.element_size())
    plan = plan_cached(
        "bcast", M, n, root=root, algo=algo, num_chunks=num_chunks,
        tuner=tuner, inter_pod=inter_pod, wire_format=wire_format,
    )
    return apply_plan(plan, x, fused=fused, compiled=compiled, inkernel=inkernel)
