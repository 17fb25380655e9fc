"""Deterministic, seeded fault-injection layer for the collective runtime.

Everything here is host-side and pure: a :class:`FaultSpec` describes which
faults a replay should experience (slow links, stalled rounds, transient
drops, dead ranks) and every consequence of it is a deterministic function of
``(spec, schedule)`` — the same spec replayed twice produces the same
retries, the same timings, and the same typed errors.

The correctness contract of the whole fault subsystem lives in one sentence:
under every injected fault class, a replay either converges bit-identically
to the fault-free oracle or raises a typed :class:`FaultError` naming the
failure and the recovery action — never a silent wrong answer.

  * slow links / stalled rounds only stretch the simulated clock
    (``timed_rounds``); values are untouched;
  * transient drops are link-layer retransmits *within* the round — the
    payload that finally lands is the round-start snapshot, so values are
    bit-identical, and a drop streak exceeding the retry budget raises
    :class:`TransientDropError`;
  * a dead rank can neither send nor receive: any schedule that routes a
    transfer through it raises :class:`DeadRankError` pointing at
    degraded-mesh replanning (``comm.plan.plan_degraded``).

This module is a leaf: it imports only the stdlib and numpy, so
``core.simulator`` can consume specs by duck-typing (the spec raises its own
typed errors) without a core -> comm import cycle. It is the reference's
``comm/faults.py`` unchanged in behaviour: the retry streaks are drawn from
the same seeds and both fingerprints hash the same json payloads, so a spec
or a health report has the same fingerprint in both packages.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json

import numpy as np

__all__ = [
    "FaultError",
    "DeadRankError",
    "TransientDropError",
    "FallbackExhaustedError",
    "WeightSyncError",
    "FaultSpec",
    "MeshHealth",
]


class FaultError(RuntimeError):
    """Base of the typed fault taxonomy.

    Deliberately NOT retryable by the fallback chain: a FaultError carries a
    diagnosis and a recovery action (replan, restore, widen the retry
    budget), so retrying the same plan would just reproduce it.
    """


class DeadRankError(FaultError):
    """A schedule routes traffic through a rank reported dead."""


class TransientDropError(FaultError):
    """A link dropped the same transfer more times than the retry budget."""


class FallbackExhaustedError(FaultError):
    """Every stage of the resilient fallback chain failed."""


class WeightSyncError(FaultError):
    """Serving weight distribution failed; weights were drained to disk."""


def _norm_links(links) -> tuple[tuple[tuple[int, int], float], ...]:
    """Normalize a {(src, dst): factor} mapping or pair-iterable into a
    sorted, hashable tuple of ((src, dst), factor)."""
    items = links.items() if isinstance(links, dict) else links
    out = []
    for (src, dst), factor in items:
        factor = float(factor)
        if factor < 1.0:
            raise ValueError(f"link slowdown factor must be >= 1, got {factor} for {(src, dst)}")
        out.append(((int(src), int(dst)), factor))
    return tuple(sorted(out))


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """A deterministic fault scenario.

    ``link_slowdown``
        ((src, dst), factor) pairs; the link's effective bandwidth is
        divided by ``factor`` (>= 1) in ``timed_rounds``.
    ``stalled_rounds`` / ``stall_s``
        round indices that pause the whole mesh for ``stall_s`` seconds
        (e.g. a host preemption between rounds).
    ``drop_prob`` / ``max_drop_retries``
        per-transfer probability that a send is dropped and retransmitted;
        retransmit streaks are drawn from a generator seeded by
        ``(seed, round, src, dst)`` so they are independent of replay
        order. A streak longer than ``max_drop_retries`` raises
        :class:`TransientDropError`.
    ``dead_ranks``
        ranks that are gone; touching one raises :class:`DeadRankError`.
    """

    seed: int = 0
    link_slowdown: tuple[tuple[tuple[int, int], float], ...] = ()
    stalled_rounds: tuple[int, ...] = ()
    stall_s: float = 1e-3
    drop_prob: float = 0.0
    max_drop_retries: int = 3
    dead_ranks: tuple[int, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "link_slowdown", _norm_links(self.link_slowdown))
        object.__setattr__(
            self, "stalled_rounds", tuple(sorted({int(r) for r in self.stalled_rounds}))
        )
        object.__setattr__(
            self, "dead_ranks", tuple(sorted({int(r) for r in self.dead_ranks}))
        )
        if not 0.0 <= self.drop_prob < 1.0:
            raise ValueError(f"drop_prob must be in [0, 1), got {self.drop_prob}")
        if self.max_drop_retries < 0:
            raise ValueError("max_drop_retries must be >= 0")

    # -- clock effects ----------------------------------------------------
    def slowdown(self, src: int, dst: int) -> float:
        """Bandwidth-division factor for one directed link (1.0 = healthy)."""
        for (s, d), factor in self.link_slowdown:
            if (s, d) == (src, dst):
                return factor
        return 1.0

    @property
    def retry_factor(self) -> float:
        """Expected wire-traffic inflation from retransmits: a transfer is
        sent 1/(1-p) times in expectation under per-send drop prob p."""
        return 1.0 / (1.0 - self.drop_prob) if self.drop_prob > 0.0 else 1.0

    # -- value effects ----------------------------------------------------
    def check_alive(self, schedule) -> None:
        """Raise :class:`DeadRankError` if the schedule routes any transfer
        through a dead rank. Called by the simulator before replay."""
        dead = set(self.dead_ranks)
        if not dead:
            return
        for ridx, rnd in enumerate(schedule.rounds):
            for t in rnd.transfers:
                for r in (t.src, t.dst):
                    if r in dead:
                        raise DeadRankError(
                            f"{schedule.name}: round {ridx} routes {t.src}->{t.dst} "
                            f"through dead rank {r}; rebuild the schedule on the "
                            f"surviving ranks (comm.plan.plan_degraded) or restore "
                            f"from checkpoint if rank {r} held unreplicated state"
                        )

    def check_alive_pairs(self, pairs, context: str = "lowered schedule") -> None:
        """Dead-rank check over raw (src, dst) pairs (lowered-schedule path,
        where the round structure has been compiled away)."""
        dead = set(self.dead_ranks)
        if not dead:
            return
        for src, dst in pairs:
            for r in (src, dst):
                if r in dead:
                    raise DeadRankError(
                        f"{context}: lane routes {src}->{dst} through dead rank {r}; "
                        f"rebuild the schedule on the surviving ranks "
                        f"(comm.plan.plan_degraded)"
                    )

    def retries(self, round_idx: int, src: int, dst: int, tag: int = 0) -> int:
        """Number of retransmits the (round, link) transfer suffers before
        landing. Deterministic in (seed, round, src, dst, tag); raises
        :class:`TransientDropError` when the streak exceeds the budget."""
        if self.drop_prob <= 0.0:
            return 0
        rng = np.random.default_rng((self.seed, 0xFA17, round_idx, src, dst, tag))
        k = 0
        while rng.random() < self.drop_prob:
            k += 1
            if k > self.max_drop_retries:
                raise TransientDropError(
                    f"round {round_idx}: link {src}->{dst} dropped the same transfer "
                    f"{k} times (budget {self.max_drop_retries}); treat the link as "
                    f"down and replan with a slow-link/dead-rank health report"
                )
        return k

    # -- identity ---------------------------------------------------------
    @property
    def healthy(self) -> bool:
        return (
            not self.link_slowdown
            and not self.stalled_rounds
            and self.drop_prob == 0.0
            and not self.dead_ranks
        )

    def fingerprint(self) -> str:
        """Stable content hash — composes into plan-cache keys."""
        payload = json.dumps(dataclasses.astuple(self), sort_keys=True)
        return hashlib.sha256(payload.encode()).hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class MeshHealth:
    """What the runtime currently believes about an n-rank mesh.

    This is the *report* side of the fault model: a FaultSpec injects faults
    into a replay, a MeshHealth summarizes observed faults for the planner.
    ``plan_cached`` keys on :meth:`fingerprint` so a health transition can
    never serve a plan built for the pre-fault mesh.
    """

    n: int
    dead_ranks: tuple[int, ...] = ()
    slow_links: tuple[tuple[tuple[int, int], float], ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "dead_ranks", tuple(sorted({int(r) for r in self.dead_ranks})))
        object.__setattr__(self, "slow_links", _norm_links(self.slow_links))
        for r in self.dead_ranks:
            if not 0 <= r < self.n:
                raise ValueError(f"dead rank {r} outside mesh of {self.n}")

    @classmethod
    def from_fault_spec(cls, n: int, spec: FaultSpec) -> "MeshHealth":
        return cls(n=n, dead_ranks=spec.dead_ranks, slow_links=spec.link_slowdown)

    @property
    def healthy(self) -> bool:
        return not self.dead_ranks and not self.slow_links

    def survivors(self) -> tuple[int, ...]:
        dead = set(self.dead_ranks)
        return tuple(r for r in range(self.n) if r not in dead)

    def surviving_slow_links(self) -> tuple[tuple[tuple[int, int], float], ...]:
        """Slow links whose both endpoints survive — the ones that still
        price into a degraded plan after dead ranks are dropped."""
        dead = set(self.dead_ranks)
        return tuple(
            ((s, d), f) for (s, d), f in self.slow_links if s not in dead and d not in dead
        )

    def fingerprint(self) -> str:
        payload = json.dumps([self.n, self.dead_ranks, self.slow_links], sort_keys=True)
        return hashlib.sha256(payload.encode()).hexdigest()[:16]
