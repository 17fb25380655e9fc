"""Resilient execution policy: fallback chains, retries, and a straggler
watchdog.

The execution side of the fault subsystem (`comm.faults` is the *model*
side): :func:`comm.api.apply_plan_resilient` walks a typed fallback chain —
in-kernel executor -> compiled executor -> unrolled executor -> one-shot —
under the retry/timeout/backoff policy defined here, and a :class:`Watchdog` compares
observed timings against the plan's cost-model expectation to flag
stragglers into ``Tuner.record`` (which bumps the tuner fingerprint and so
invalidates cached plans, closing the observe -> retune loop).

Semantics worth stating precisely:

  * only *unexpected* exceptions advance the chain (a kernel that fails to
    build or launch, a CUDA error the stage's synchronize surfaces, an
    executor assertion). A typed
    :class:`~.faults.FaultError` propagates immediately — it already names
    the recovery action (replan / restore / widen the budget) and retrying
    the same plan would reproduce it.
  * a stage that *completes* but blows the policy timeout still returns its
    (correct) result; it is recorded as a straggler, not a failure —
    discarding a correct collective because it was slow would turn a
    performance fault into a data loss.
  * when every stage fails, :class:`~.faults.FallbackExhaustedError` carries
    the per-stage causes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

from ..core.tuner import Tuner
from .faults import FallbackExhaustedError  # noqa: F401  (re-export for callers)
from .plan import CollectivePlan

__all__ = [
    "FallbackPolicy",
    "FallbackEvent",
    "StragglerReport",
    "Watchdog",
]

# fallback stages, strongest first: the in-kernel executor (one
# device-initiated launch a schedule, ``rdma_replay``), the compiled
# executor (the ``fused_combine`` merge a round), the unrolled schedule
# executor, then the one-shot. The last stage keeps the reference's name
# "xla", so a policy valid there is valid here: in the port it is the plain
# tensor-op form of ``comm.api._one_shot`` over the rank axis
DEFAULT_CHAIN = ("inkernel", "compiled", "unrolled", "xla")


@dataclasses.dataclass(frozen=True)
class FallbackPolicy:
    """Retry/timeout/backoff policy driving the fallback chain.

    ``max_retries`` retries *per stage* (so a transient trace failure gets a
    second chance before the chain degrades), with ``backoff_s`` sleep
    growing by ``backoff_mult`` between attempts. ``timeout_s`` is the
    straggler threshold for a completed attempt (None = use only the
    watchdog's relative threshold)."""

    chain: tuple[str, ...] = DEFAULT_CHAIN
    max_retries: int = 1
    timeout_s: float | None = None
    backoff_s: float = 0.05
    backoff_mult: float = 2.0

    def __post_init__(self):
        unknown = set(self.chain) - set(DEFAULT_CHAIN)
        if unknown:
            raise ValueError(f"unknown fallback stages {sorted(unknown)}; have {DEFAULT_CHAIN}")
        if not self.chain:
            raise ValueError("fallback chain must name at least one stage")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")


@dataclasses.dataclass
class FallbackEvent:
    """One attempt in the chain, for logs and tests."""

    stage: str
    attempt: int
    outcome: str  # 'ok' | 'error' | 'straggler'
    elapsed_s: float
    error: str | None = None


@dataclasses.dataclass(frozen=True)
class StragglerReport:
    op: str
    algo: str
    M: int
    n: int
    measured_s: float
    expected_s: float

    @property
    def factor(self) -> float:
        return self.measured_s / self.expected_s if self.expected_s > 0 else math.inf


class Watchdog:
    """Compares observed collective timings against cost-model expectations.

    A measurement slower than ``straggler_factor`` x the plan's expectation
    (``decision.predicted_s``, falling back to the round-accurate simulator
    clock when the prediction is NaN — one-shot baselines) is flagged: the
    report is kept on :attr:`reports` and, when a tuner is attached, the
    observation lands via ``Tuner.record`` so the next planning pass sees
    the real link behavior and ``plan_cached`` keys move off the stale
    fingerprint.
    """

    def __init__(self, tuner: Optional[Tuner] = None, *, straggler_factor: float = 3.0,
                 on_straggler: Optional[Callable[[StragglerReport], None]] = None):
        if straggler_factor <= 1.0:
            raise ValueError("straggler_factor must be > 1")
        self.tuner = tuner
        self.straggler_factor = float(straggler_factor)
        self.on_straggler = on_straggler
        self.reports: list[StragglerReport] = []

    def expected_s(self, plan: CollectivePlan) -> float:
        """The plan's ``predicted_s``, or its round-accurate simulator clock
        (``plan.timed_rounds_s()``) where the prediction is NaN or not
        positive."""
        exp = plan.predicted_s
        if not math.isfinite(exp) or exp <= 0.0:
            exp = plan.timed_rounds_s()
        return exp

    def observe(self, plan: CollectivePlan, measured_s: float) -> StragglerReport | None:
        """Feed one measurement; returns the report if it was a straggler."""
        exp = self.expected_s(plan)
        if exp <= 0.0 or measured_s <= self.straggler_factor * exp:
            return None
        rep = StragglerReport(
            op=plan.op, algo=plan.algo, M=plan.M, n=plan.n,
            measured_s=float(measured_s), expected_s=exp,
        )
        self.reports.append(rep)
        if self.tuner is not None:
            self.tuner.record(
                plan.M, plan.n, plan.algo, plan.num_chunks, float(measured_s),
                op=plan.op, inter_pod=plan.inter_pod, sizes=plan.sizes,
            )
        if self.on_straggler is not None:
            self.on_straggler(rep)
        return rep
