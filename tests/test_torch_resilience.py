"""The port's degraded-mesh replanning, fallback chain, watchdog, degraded
training and drain-on-failure distribution against the reference's, on
the CPU.

``plan_degraded`` over the reference's pinned ops x n in {3, 4, 8} with one
dead rank (survivors, schedules, lowered tables, ``predicted_s``, wire
bytes, ragged sizes), its typed errors and the slow-link re-pricing, and a
degraded plan run on the survivors' rows; ``plan_cached(health=)``; the
chain with both packages' ``apply_plan`` patched with the same failures
(the ``(stage, attempt, outcome)`` sequences and the causes named), and
unpatched (an int8 plan degrades to the compiled stage); the watchdog's
loop into ``Tuner.record`` and the plan cache; the degraded trainer against
the reference's single-device steps on the survivors' rows; and the drain.
The reference's tuners price on its v5e profile; the port is handed the
same constants (``Hardware(**asdict(TPU_V5E))``).
"""
from __future__ import annotations

import dataclasses
import math
import os

import jax
import numpy as np
import pytest
import torch

import repro.comm.api as japi
import repro.comm.plan as jplan
import repro.core.schedules as js
from repro.comm import faults as jf
from repro.comm import resilience as jres
from repro.configs import get_config as jget_config
from repro.configs.base import RunConfig as JRunConfig
from repro.core import cost_model as jcm
from repro.core.tuner import Tuner as JTuner
from repro.data.pipeline import batches as jbatches
from repro.launch.mesh import make_local_mesh
from repro.train import checkpoint as jckpt
from repro.train.train_step import make_train_step as jmake_train_step
from repro.train.trainer import Trainer as JTrainer
from repro_torch.comm import api as tapi
from repro_torch.comm import faults as tf
from repro_torch.comm import plan as tplan
from repro_torch.comm import resilience as tres
from repro_torch.comm import streams as tstreams
from repro_torch.configs import RunConfig, get_config
from repro_torch.core import cost_model as tcm
from repro_torch.core import schedules as ts
from repro_torch.core.tree import tree_leaves
from repro_torch.core.tuner import Tuner as TTuner
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import Model
from repro_torch.serve import Engine, distribute_weights, distribution_stream_graph
from repro_torch.train import checkpoint as tckpt
from repro_torch.train.trainer import Trainer

# one intra-op thread: the suite runs in several worker processes at once, and
# the spinning OpenMP threads of each would contend for the same cores
torch.set_num_threads(1)

V5E = tcm.Hardware(**dataclasses.asdict(jcm.TPU_V5E))
# the reference's own pinned algorithms (tests/test_resilience.py)
PINNED = {
    "bcast": "pipelined_chain",
    "reduce": "pipelined_reduce_chain",
    "allreduce": "ring_allreduce",
    "allgather": "ring_allgather",
    "reduce_scatter": "ring_reduce_scatter",
    "allgatherv": "ring_allgatherv",
    "alltoallv": "pairwise_alltoallv",
}
DEAD = 1


def _sizes(op, n, rng):
    if op == "allgatherv":
        return tuple(int(rng.integers(1, 5)) for _ in range(n))
    if op == "alltoallv":
        return tuple(int(rng.integers(1, 4)) for _ in range(n * n))
    return None


def _dec(d) -> dict:
    return {k: "nan" if isinstance(v, float) and math.isnan(v) else v
            for k, v in dataclasses.asdict(d).items()}


def _sched_key(s):
    return (s.name, s.n, s.root, s.num_chunks, s.kind, s.sizes,
            [[dataclasses.astuple(t) for t in r.transfers] for r in s.rounds])


def _lowered_key(lw):
    classes = [(c.perm, c.block, c.combine.tobytes(), c.send_start.tobytes(),
                c.recv_start.tobytes(), c.lo.tobytes(), c.hi.tobytes()) for c in lw.classes]
    return (lw.name, lw.kind, lw.n, lw.num_chunks, classes)


def _plan_key(p, lower):
    return {"op": p.op, "M": p.M, "n": p.n, "root": p.root, "survivors": p.survivors,
            "sizes": p.sizes, "decision": _dec(p.decision), "wire": p.wire_bytes(),
            "schedule": _sched_key(p.schedule), "lowered": _lowered_key(lower(p.schedule))}


# --------------------------------------------------------------------------
# degraded replanning
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n", [3, 4, 8])
@pytest.mark.parametrize("op,algo", sorted(PINNED.items()))
def test_plan_degraded_equals_reference(op, algo, n):
    sizes = _sizes(op, n, np.random.default_rng((5, n)))
    M = (1 << 14) if sizes is None else 512 * sum(sizes)
    got = tplan.plan_degraded(op, M, n, tf.MeshHealth(n=n, dead_ranks=(DEAD,)), algo=algo,
                              sizes=sizes, tuner=TTuner(V5E))
    want = jplan.plan_degraded(op, M, n, jf.MeshHealth(n=n, dead_ranks=(DEAD,)), algo=algo,
                               sizes=sizes, tuner=JTuner(jcm.TPU_V5E))
    assert got.survivors == tuple(r for r in range(n) if r != DEAD)
    assert _plan_key(got, ts.lower_schedule) == _plan_key(want, js.lower_schedule)
    assert math.isfinite(got.predicted_s)
    assert got.wire_bytes() == tplan.expected_wire_bytes(op, got.algo, got.M, got.n,
                                                         got.num_chunks, sizes=got.sizes)


@pytest.mark.parametrize("op", ["allreduce", "bcast", "allgather", "reduce_scatter"])
def test_auto_degraded_plans_and_slow_links_equal_reference(op):
    """The tuner's own choice on the shrunk mesh, and the slow-link-only
    re-pricing (same schedule, ``+degraded``, a higher ``predicted_s``)."""
    for health in ({"n": 4, "dead_ranks": (2,)},
                   {"n": 4, "dead_ranks": (3,), "slow_links": {(0, 1): 4.0, (3, 0): 9.0}},
                   {"n": 8, "slow_links": {(0, 1): 8.0}}):
        got = tplan.plan_degraded(op, 1 << 22, health["n"], tf.MeshHealth(**health),
                                  root=1, tuner=TTuner(V5E))
        want = jplan.plan_degraded(op, 1 << 22, health["n"], jf.MeshHealth(**health),
                                   root=1, tuner=JTuner(jcm.TPU_V5E))
        assert _plan_key(got, ts.lower_schedule) == _plan_key(want, js.lower_schedule)
        if "dead_ranks" not in health:
            base = tplan.plan_collective(op, 1 << 22, health["n"], root=1, tuner=TTuner(V5E))
            assert got.survivors is None
            assert _sched_key(got.schedule) == _sched_key(base.schedule)
            assert got.decision.source.endswith("+degraded")
            assert got.predicted_s > base.predicted_s


def test_degraded_errors_are_typed():
    for op in ("bcast", "reduce"):
        with pytest.raises(tf.DeadRankError, match="checkpoint"):
            tplan.plan_degraded(op, 1 << 12, 4, tf.MeshHealth(n=4, dead_ranks=(0,)),
                                algo=PINNED[op])
    plan = tplan.plan_degraded("allreduce", 1 << 12, 4, tf.MeshHealth(n=4, dead_ranks=(0,)))
    assert plan.n == 3 and plan.survivors == (1, 2, 3) and plan.root == 0
    with pytest.raises(tf.DeadRankError):
        tplan.plan_degraded("allreduce", 1 << 12, 2, tf.MeshHealth(n=2, dead_ranks=(0, 1)))
    with pytest.raises(ValueError, match="health report is for n=4"):
        tplan.plan_degraded("allreduce", 1 << 12, 8, tf.MeshHealth(n=4, dead_ranks=(0,)))
    healthy = tplan.plan_degraded("allreduce", 1 << 12, 4, tf.MeshHealth(n=4))
    assert healthy.n == 4 and healthy.survivors is None


@pytest.mark.parametrize("compiled", [False, True])
def test_degraded_plan_runs_on_the_survivors_rows(compiled):
    """The caller's convention: ``apply_plan(plan, x[survivors])`` written
    back into those rows. The dead rank's row is untouched, bit for bit; a
    bcast from physical rank 2 with rank 1 dead runs from logical root 1."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 1003)).astype(np.float32))
    health = tf.MeshHealth(n=4, dead_ranks=(DEAD,))
    for op, root in (("allreduce", 0), ("bcast", 2)):
        plan = tplan.plan_degraded(op, x[0].numel() * 4, 4, health, root=root)
        assert plan.n == 3 and plan.survivors == (0, 2, 3)
        rows = list(plan.survivors)
        y = x.clone()
        y[rows] = tapi.apply_plan(plan, x[rows].clone(), compiled=compiled)
        assert torch.equal(y[DEAD], x[DEAD])
        if op == "bcast":
            assert plan.root == 1
            assert all(torch.equal(y[r], x[2]) for r in rows)
        else:
            want = x[rows].double().sum(0)
            for r in rows:
                np.testing.assert_allclose(y[r].double().numpy(), want.numpy(), rtol=1e-5,
                                           atol=1e-5)


def test_plan_cached_keys_on_health():
    kw = dict(op="allreduce", M=1 << 16, n=8, algo="ring_allreduce")
    healthy = tplan.plan_cached(**kw)
    assert tplan.plan_cached(**kw) is healthy
    ok = tplan.plan_cached(**kw, health=tf.MeshHealth(n=8))
    assert ok.n == 8 and ok.survivors is None
    degraded = tplan.plan_cached(**kw, health=tf.MeshHealth(n=8, dead_ranks=(3,)))
    assert degraded is not healthy and degraded.n == 7
    assert degraded.survivors == (0, 1, 2, 4, 5, 6, 7)
    misses = tplan.cache_stats()["misses"]
    assert tplan.plan_cached(**kw, health=tf.MeshHealth(n=8, dead_ranks=(3,))) is degraded
    assert tplan.cache_stats()["misses"] == misses
    other = tplan.plan_cached(**kw, health=tf.MeshHealth(n=8, dead_ranks=(5,)))
    assert other is not degraded and other.survivors == (0, 1, 2, 3, 4, 6, 7)
    assert tplan.plan_cached(**kw) is healthy


# --------------------------------------------------------------------------
# the fallback chain against the reference's
# --------------------------------------------------------------------------


def _fail_all(stage, kind):
    raise RuntimeError("no fabric")


def _fail_inkernel(stage, kind):
    if stage == "inkernel":
        raise RuntimeError("no in-kernel dma engine")
    return f"{stage}-result"


def _dead(stage, kind):
    raise kind.DeadRankError("rank 2 is gone; replan")


def _slow(stage, kind):
    import time

    time.sleep(0.002)
    return f"{stage}-result"


SCENARIOS = {"fail_all": (_fail_all, {"max_retries": 1}),
             "fail_inkernel": (_fail_inkernel, {"max_retries": 0, "timeout_s": 1e-9}),
             "dead_rank": (_dead, {"max_retries": 3}),
             "slow": (_slow, {"timeout_s": 1e-4}),
             "one_shot_only": (_fail_all, {"chain": ("xla",), "max_retries": 2})}


def _run_chain(pkg_api, pkg_res, kind, plan, scenario, monkeypatch, x):
    behave, kw = SCENARIOS[scenario]
    calls, events = [], []

    def stage_of(compiled, inkernel):
        return "inkernel" if inkernel else ("compiled" if compiled else "unrolled")

    def apply(plan, x, *args, fused=True, compiled=None, inkernel=None):
        calls.append((stage_of(compiled, inkernel), compiled, inkernel))
        return behave(calls[-1][0], kind)

    def one_shot(plan, x, *args):
        calls.append(("xla", None, None))
        return behave("xla", kind)

    monkeypatch.setattr(pkg_api, "apply_plan", apply)
    monkeypatch.setattr(pkg_api, "_one_shot_fallback", one_shot)
    args = (plan, x) if pkg_api is tapi else (plan, x, "data")
    try:
        out = pkg_api.apply_plan_resilient(*args, policy=pkg_res.FallbackPolicy(
            backoff_s=0.0, **kw), on_event=events.append)
    except kind.FaultError as e:
        out = (type(e).__name__, str(e))
    return out, calls, [(e.stage, e.attempt, e.outcome, e.error) for e in events]


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_fallback_chain_matches_reference(scenario, monkeypatch):
    """The same failures injected into both packages' executors: the same
    result, the same pinned executor calls, the same ``(stage, attempt,
    outcome)`` events and the same causes in ``FallbackExhaustedError``."""
    x = torch.zeros(4, 8)
    got = _run_chain(tapi, tres, tf, tplan.plan_collective(
        "allreduce", 1 << 12, 4, algo="ring_allreduce"), scenario, monkeypatch, x)
    want = _run_chain(japi, jres, jf, jplan.plan_collective(
        "allreduce", 1 << 12, 4, algo="ring_allreduce"), scenario, monkeypatch, None)
    assert got == want
    out, calls, events = got
    if scenario == "fail_all":
        assert out[0] == "FallbackExhaustedError"
        for stage in ("inkernel[1]", "compiled[0]", "unrolled[1]", "xla[0]"):
            assert stage in out[1]
        assert len(events) == 8 and {e[2] for e in events} == {"error"}
    elif scenario == "dead_rank":
        assert out[0] == "DeadRankError" and len(calls) == 1
    elif scenario == "fail_inkernel":
        assert [e[:3] for e in events] == [("inkernel", 0, "error"),
                                           ("compiled", 0, "straggler")]
        assert calls[1] == ("compiled", True, False)
    elif scenario == "slow":
        assert out == "inkernel-result" and [e[2] for e in events] == ["straggler"]
    assert torch.equal(x, torch.zeros(4, 8))


def test_policy_validation_matches_reference():
    for kw, match in (({"chain": ("compiled", "warp")}, "unknown fallback stages"),
                      ({"chain": ()}, "at least one stage"), ({"max_retries": -1}, "max_retries")):
        for pkg in (tres, jres):
            with pytest.raises(ValueError, match=match):
                pkg.FallbackPolicy(**kw)
    assert tres.DEFAULT_CHAIN == jres.DEFAULT_CHAIN
    assert dataclasses.astuple(tres.FallbackPolicy()) == dataclasses.astuple(jres.FallbackPolicy())


def test_int8_plan_degrades_to_the_compiled_stage_unpatched():
    """Nothing injected: the in-kernel executor's veto of a compressed
    plan burns the head stage's attempt and its retry, and the compiled
    stage serves a result bit-equal to ``apply_plan(compiled=True)``; the
    caller's buffer is left as it was."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((4, 3000)).astype(np.float32))
    keep = x.clone()
    plan = tplan.plan_collective("allreduce", x[0].numel() * 4, 4, wire_format="int8")
    events = []
    out = tapi.apply_plan_resilient(plan, x, policy=tres.FallbackPolicy(backoff_s=0.0),
                                    on_event=events.append)
    assert [(e.stage, e.attempt, e.outcome) for e in events] == [
        ("inkernel", 0, "error"), ("inkernel", 1, "error"), ("compiled", 0, "ok")]
    assert "compressed wire" in events[0].error
    assert torch.equal(out, tapi.apply_plan(plan, keep.clone(), compiled=True))
    assert torch.equal(x, keep)
    bf16 = tplan.plan_collective("allreduce", x[0].numel() * 4, 4)
    events.clear()
    out = tapi.apply_plan_resilient(bf16, x, on_event=events.append)
    assert [(e.stage, e.outcome) for e in events] == [("inkernel", "ok")]
    assert torch.equal(out, tapi.apply_plan(bf16, keep.clone(), compiled=True))


class _FakeStream:
    def synchronize(self):
        pass


def test_chain_on_the_card_degrades_only_on_a_typed_refusal(monkeypatch):
    """A buffer on the card (the stream lookup patched, so the host runs
    the card's branch): a kernel stage that fails to build or launch
    propagates at once instead of degrading, the plain stages refuse, and
    only the in-kernel veto of a compressed wire moves the chain on, to
    the compiled stage, bit-equal to ``apply_plan(compiled=True)``. The
    same kernel failure on the host degrades as in the reference."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 3000)).astype(np.float32))
    keep = x.clone()
    bf16 = tplan.plan_collective("allreduce", x[0].numel() * 4, 4)
    plan8 = tplan.plan_collective("allreduce", x[0].numel() * 4, 4, wire_format="int8")
    want8 = tapi.apply_plan(plan8, keep.clone(), compiled=True)
    want = tapi.apply_plan(bf16, keep.clone(), compiled=True)
    policy = tres.FallbackPolicy(backoff_s=0.0)
    calls = []

    def broken(name):
        def run(*args, **kw):
            calls.append(name)
            raise RuntimeError(f"{name} kernel did not build")
        return run

    monkeypatch.setitem(tapi._EXECUTORS, "inkernel", broken("inkernel"))
    events = []
    out = tapi.apply_plan_resilient(bf16, x, policy=policy, on_event=events.append)
    assert [(e.stage, e.outcome) for e in events] == [
        ("inkernel", "error"), ("inkernel", "error"), ("compiled", "ok")]
    assert torch.equal(out, want)

    monkeypatch.setattr(tapi, "_card_stream", lambda x: _FakeStream())
    events.clear()
    calls.clear()
    with pytest.raises(RuntimeError, match="inkernel kernel did not build"):
        tapi.apply_plan_resilient(bf16, x, policy=policy, on_event=events.append)
    assert calls == ["inkernel"] and events == []
    out = tapi.apply_plan_resilient(plan8, x, policy=policy, on_event=events.append)
    assert [(e.stage, e.attempt, e.outcome) for e in events] == [
        ("inkernel", 0, "error"), ("inkernel", 1, "error"), ("compiled", 0, "ok")]
    assert calls == ["inkernel"] and torch.equal(out, want8)
    monkeypatch.setitem(tapi._EXECUTORS, "compiled", broken("compiled"))
    with pytest.raises(RuntimeError, match="compiled kernel did not build"):
        tapi.apply_plan_resilient(plan8, x, policy=policy)
    monkeypatch.setitem(tapi._EXECUTORS, "unrolled", broken("unrolled"))
    monkeypatch.setattr(tapi, "_one_shot_fallback", broken("xla"))
    calls.clear()
    with pytest.raises(tf.FallbackExhaustedError, match="plain tensor ops") as ei:
        tapi.apply_plan_resilient(bf16, x, policy=tres.FallbackPolicy(
            chain=("unrolled", "xla"), backoff_s=0.0))
    assert calls == [] and "unrolled[1]" in str(ei.value) and "xla[1]" in str(ei.value)
    assert torch.equal(x, keep)


@pytest.mark.parametrize("op", ["bcast", "allreduce", "allgather", "reduce_scatter",
                                "allgatherv"])
def test_one_shot_stage_returns_apply_plans_shapes(op):
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((4, 6, 5)).astype(np.float32))
    sizes = (6, 2, 0, 3) if op == "allgatherv" else None
    plan = tplan.plan_collective(op, (4 if op == "allgather" else 1) * x[0].numel() * 4, 4,
                                 root=2, sizes=sizes)
    policy = tres.FallbackPolicy(chain=("xla",), backoff_s=0.0)
    if sizes is not None:
        with pytest.raises(tf.FallbackExhaustedError, match="ragged op"):
            tapi.apply_plan_resilient(plan, x, policy=policy)
        return
    got = tapi.apply_plan_resilient(plan, x, policy=policy)
    want = tapi.apply_plan(plan, x.clone(), compiled=True)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# the watchdog
# --------------------------------------------------------------------------


def test_watchdog_records_stragglers_and_moves_the_plan_cache():
    tuner = TTuner(V5E)
    wd = tres.Watchdog(tuner, straggler_factor=3.0)
    plan = tplan.plan_cached("allreduce", 1 << 16, 8, algo="ring_allreduce", tuner=tuner)
    jplan_ = jplan.plan_collective("allreduce", 1 << 16, 8, algo="ring_allreduce",
                                   tuner=JTuner(jcm.TPU_V5E))
    exp = wd.expected_s(plan)
    assert exp == jres.Watchdog().expected_s(jplan_) and exp > 0
    fp0 = tuner.fingerprint()
    assert wd.observe(plan, exp) is None and tuner.fingerprint() == fp0
    rep = wd.observe(plan, exp * 10)
    assert rep is not None and rep.factor == pytest.approx(10.0) and wd.reports == [rep]
    assert tuner.fingerprint() != fp0
    misses = tplan.cache_stats()["misses"]
    tplan.plan_cached("allreduce", 1 << 16, 8, algo="ring_allreduce", tuner=tuner)
    assert tplan.cache_stats()["misses"] == misses + 1
    one_shot = tplan.plan_collective("allreduce", 1 << 16, 8, algo="xla_psum")
    assert math.isnan(one_shot.predicted_s) and wd.expected_s(one_shot) == 0.0
    seen = []
    assert tres.Watchdog(straggler_factor=2.0, on_straggler=seen.append).observe(
        plan, exp * 5) is not None and len(seen) == 1
    with pytest.raises(ValueError, match="straggler_factor"):
        tres.Watchdog(straggler_factor=1.0)


# --------------------------------------------------------------------------
# degraded training
# --------------------------------------------------------------------------

ARCH = "minitron-8b-smoke"
BATCH, SEQ, STEPS = 8, 16, 3
RUN = dict(total_steps=STEPS, warmup_steps=0, learning_rate=1e-3, seed=7,
           sync_mode="tuned_allreduce")


def test_degraded_trainer_tracks_reference_steps_on_the_survivors_rows(tmp_path, capsys):
    """4 emulated ranks, rank 1 dead: the port's trainer (any sync mode
    falls back to the survivors' mean) against the reference's
    single-device steps on the batch with rank 1's rows removed, from the
    same initial state (the reference's own npz checkpoint)."""
    jcfg = dataclasses.replace(jget_config(ARCH), dtype="float32")
    jtr = JTrainer(jcfg, JRunConfig(**dict(RUN, sync_mode="grad_allreduce")),
                   mesh=make_local_mesh(1))
    params, opt = jtr.init_state()
    ckpt = str(tmp_path)
    jckpt.save_checkpoint(ckpt, 0, params)
    jckpt.save_checkpoint(os.path.join(ckpt, "opt"), 0, opt)
    step = jax.jit(jmake_train_step(jtr.model, jtr.run, jtr.optimizer, jtr.lr_fn))
    it = jbatches(jtr.source, jcfg, batch=BATCH, seq=SEQ)
    keep = np.array([r for r in range(BATCH) if r // (BATCH // 4) != DEAD])
    ref, ref_norms = [], []
    for _ in range(STEPS):
        b = {k: v[keep] for k, v in next(it).items()}
        params, opt, out = step(params, opt, b)
        ref.append(float(out["loss"]))
        ref_norms.append(float(out["grad_norm"]))
    tr = Trainer(dataclasses.replace(get_config(ARCH), dtype="float32"), RunConfig(**RUN),
                 mesh=make_mesh(4, device="cpu"), ckpt_dir=ckpt, device="cpu",
                 health=tf.MeshHealth(n=4, dead_ranks=(DEAD,)))
    assert "falls back to psum-over-survivors" in capsys.readouterr().out
    _, _, hist = tr.train(batch=BATCH, seq=SEQ, steps=STEPS, log_every=1)
    losses = [h["loss"] for h in hist]
    assert max(abs(a - b) for a, b in zip(losses, ref)) <= 1e-4, (losses, ref)
    # the grad norm sees the divisor (AdamW's update hardly does): dividing
    # the survivors' sum by n = 4 instead of 3 would be off by a quarter.
    # Step 0's is within f32 summation order; the later steps' parameters
    # have drifted by the losses' 1e-4
    norms = [h["grad_norm"] for h in hist]
    rel = [abs(a - b) / b for a, b in zip(norms, ref_norms)]
    assert rel[0] <= 1e-5 and max(rel) <= 1e-4, (norms, ref_norms)
    with pytest.raises(tf.DeadRankError):
        Trainer(get_config(ARCH), RunConfig(**RUN), mesh=make_mesh(2, device="cpu"),
                device="cpu", health=tf.MeshHealth(n=2, dead_ranks=(0, 1)))
    with pytest.raises(ValueError, match="health report is for n=3"):
        Trainer(get_config(ARCH), RunConfig(**RUN), mesh=make_mesh(4, device="cpu"),
                device="cpu", health=tf.MeshHealth(n=3, dead_ranks=(0,)))


def test_slow_links_only_leave_the_trainers_step_alone():
    run = RunConfig(**RUN)
    tr = Trainer(get_config(ARCH), run, mesh=make_mesh(4, device="cpu"), device="cpu",
                 health=tf.MeshHealth(n=4, slow_links={(0, 1): 4.0}))
    assert tr._step_fn.__qualname__.startswith("_make_comm_sync_step")


# --------------------------------------------------------------------------
# drain on failure
# --------------------------------------------------------------------------


def _stacked(n=3):
    rng = np.random.RandomState(0)
    tree = {"w": torch.from_numpy(rng.randn(n, 3000).astype(np.float32)),
            "b": torch.from_numpy(rng.randn(n, 50, 7).astype(np.float32)).to(torch.bfloat16)}
    for leaf in tree.values():
        leaf[1:] = float("nan")
    return tree


def _fail_on_call(monkeypatch, k: int):
    real, calls = tstreams.apply_plan, []

    def flaky(*a, **kw):
        calls.append(1)
        if len(calls) == k:
            raise RuntimeError("fabric lost a device mid-broadcast")
        return real(*a, **kw)

    monkeypatch.setattr(tstreams, "apply_plan", flaky)
    return calls


def test_drain_restores_the_roots_weights_bit_for_bit(tmp_path, monkeypatch):
    stacked = _stacked()
    root = {k: v[0].clone() for k, v in stacked.items()}
    calls = _fail_on_call(monkeypatch, 2)
    with pytest.raises(tf.WeightSyncError, match="drained") as ei:
        distribute_weights(stacked, make_mesh(3, device="cpu"), bucket_bytes=4096,
                           double_buffer=True, drain_dir=str(tmp_path / "drain"))
    assert isinstance(ei.value.__cause__, RuntimeError) and len(calls) == 2
    assert tckpt.latest_step(str(tmp_path / "drain")) == 0
    back = tckpt.restore_checkpoint(str(tmp_path / "drain"), 0, root)
    for k in root:
        assert back[k].dtype == root[k].dtype
        assert torch.equal(back[k].view(torch.int16 if k == "b" else torch.int32),
                           root[k].view(torch.int16 if k == "b" else torch.int32))
    # without a failure the drain writes nothing and the replicas are the root's
    monkeypatch.undo()
    out = distribute_weights(_stacked(), make_mesh(3, device="cpu"), bucket_bytes=4096,
                             drain_dir=str(tmp_path / "clean"))
    assert not os.path.exists(tmp_path / "clean")
    assert all(torch.equal(out["w"][r], root["w"]) for r in range(3))


def test_drain_graph_and_engine_pass_the_drain_through(tmp_path, monkeypatch):
    stacked = _stacked()
    mesh = make_mesh(3, device="cpu")
    graph, _spec, _plans = distribution_stream_graph(stacked, mesh, bucket_bytes=4096,
                                                     drain=True)
    plain, _spec, _plans = distribution_stream_graph(stacked, mesh, bucket_bytes=4096)
    assert graph.names == ("ckpt_drain", "distribute") and plain.names == ("distribute",)
    drain, dist = graph.entries
    assert dist.after == ("ckpt_drain",) and (drain.priority, drain.link) == (2, "host")
    assert drain.plans == {} and drain.wire_bytes() == 0 and graph.key != plain.key
    assert [graph.names[i] for i in graph.topo_order()] == ["ckpt_drain", "distribute"]
    cfg = dataclasses.replace(get_config(ARCH), dtype="float32")
    params = Model(cfg).init(0, device="cpu")
    _fail_on_call(monkeypatch, 1)
    with pytest.raises(tf.WeightSyncError, match="drained"):
        Engine(cfg, params, mesh=make_mesh(2, device="cpu"), distribute=True,
               drain_dir=str(tmp_path), device="cpu")
    back = tckpt.restore_checkpoint(str(tmp_path), 0, params)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back), tree_leaves(params)))
    monkeypatch.undo()
    engine = Engine(cfg, params, mesh=make_mesh(2, device="cpu"), distribute=True,
                    drain_dir=str(tmp_path / "unused"), device="cpu")
    assert all(torch.equal(a[1], b) for a, b in zip(tree_leaves(engine.params),
                                                      tree_leaves(params)))
