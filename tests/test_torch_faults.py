"""The port's fault model and fault-aware clocks against the reference's, on
the CPU.

``FaultSpec``/``MeshHealth`` validation, normalisation and fingerprints;
the ``retries`` streaks over a grid of seeds, rounds and links (and the
point where ``TransientDropError`` is raised); ``simulate_collective`` and
``simulate_lowered`` under clock and drop faults (values bit-identical to
the fault-free replay, ``report`` dicts equal to the reference's, dead
ranks raising ``DeadRankError`` on both replays); ``timed_rounds``,
``CollectivePlan.timed_rounds_s``, ``cost_degraded`` and
``degraded_bandwidth``; and the stream and overlap clocks under faults.
Every comparison is exact: the host-side forms run the same arithmetic.
The reference's tuners price on its v5e profile; the port is handed the
same constants (``Hardware(**asdict(TPU_V5E))``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import repro.comm.faults as jf
import repro.comm.schedules as jcs
import repro.core.schedules as js
import repro.core.simulator as jsim
from repro.comm import overlap as jov
from repro.comm import plan as jplan
from repro.comm import streams as jst
from repro.core import cost_model as jcm
from repro.core.tuner import Tuner as JTuner
from repro_torch.comm import faults as tf
from repro_torch.comm import overlap as tov
from repro_torch.comm import plan as tplan
from repro_torch.comm import schedules as tcs
from repro_torch.comm import streams as tst
from repro_torch.core import cost_model as tcm
from repro_torch.core import schedules as ts
from repro_torch.core import simulator as tsim
from repro_torch.core.tuner import Tuner as TTuner

# one intra-op thread: the suite runs in several worker processes at once, and
# the spinning OpenMP threads of each would contend for the same cores
torch.set_num_threads(1)

V5E = tcm.Hardware(**dataclasses.asdict(jcm.TPU_V5E))

SPECS = [
    {},
    {"seed": 3, "link_slowdown": {(2, 0): 4.0, (0, 1): 2.5}},
    {"link_slowdown": [((1, 2), 3), ((0, 3), 1)], "stalled_rounds": (4, 1, 1, 0),
     "stall_s": 2e-3},
    {"seed": 11, "drop_prob": 0.3, "max_drop_retries": 6, "dead_ranks": (3, 1, 3)},
    {"drop_prob": 0.05, "max_drop_retries": 0},
]
HEALTH = [
    {"n": 4},
    {"n": 4, "dead_ranks": (1,)},
    {"n": 8, "dead_ranks": (5, 2, 5), "slow_links": {(0, 1): 4.0, (2, 3): 2.0, (3, 2): 1.5}},
    {"n": 3, "slow_links": [((2, 0), 8)]},
]


def _both(cls_name: str, kw: dict):
    return getattr(tf, cls_name)(**kw), getattr(jf, cls_name)(**kw)


# --------------------------------------------------------------------------
# the fault model
# --------------------------------------------------------------------------


@pytest.mark.parametrize("i", range(len(SPECS)))
def test_fault_spec_normalises_and_fingerprints_as_the_reference(i):
    port, ref = _both("FaultSpec", SPECS[i])
    assert dataclasses.astuple(port) == dataclasses.astuple(ref)
    assert port.fingerprint() == ref.fingerprint()
    assert port.healthy == ref.healthy and port.retry_factor == ref.retry_factor
    for link in ((0, 1), (2, 0), (1, 2), (3, 3)):
        assert port.slowdown(*link) == ref.slowdown(*link)


@pytest.mark.parametrize("i", range(len(HEALTH)))
def test_mesh_health_normalises_and_fingerprints_as_the_reference(i):
    port, ref = _both("MeshHealth", HEALTH[i])
    assert dataclasses.astuple(port) == dataclasses.astuple(ref)
    assert port.fingerprint() == ref.fingerprint()
    assert port.healthy == ref.healthy
    assert port.survivors() == ref.survivors()
    assert port.surviving_slow_links() == ref.surviving_slow_links()
    spec = SPECS[3]
    assert (dataclasses.astuple(tf.MeshHealth.from_fault_spec(4, tf.FaultSpec(**spec)))
            == dataclasses.astuple(jf.MeshHealth.from_fault_spec(4, jf.FaultSpec(**spec))))


@pytest.mark.parametrize("cls_name,kw,match", [
    ("FaultSpec", {"drop_prob": 1.0}, "drop_prob"),
    ("FaultSpec", {"drop_prob": -0.1}, "drop_prob"),
    ("FaultSpec", {"max_drop_retries": -1}, "max_drop_retries"),
    ("FaultSpec", {"link_slowdown": {(0, 1): 0.5}}, "factor must be >= 1"),
    ("MeshHealth", {"n": 4, "dead_ranks": (4,)}, "outside mesh"),
    ("MeshHealth", {"n": 2, "slow_links": {(0, 1): 0.9}}, "factor must be >= 1"),
])
def test_fault_model_validation_matches_reference(cls_name, kw, match):
    for pkg in (tf, jf):
        with pytest.raises(ValueError, match=match):
            getattr(pkg, cls_name)(**kw)


def _streak(spec, *args):
    try:
        return spec.retries(*args)
    except Exception as e:  # noqa: BLE001 — the error is part of what is compared
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
def test_retry_streaks_equal_the_reference(seed):
    """The same streaks from the same seeded generator, and the
    ``TransientDropError`` at the same (round, link, tag)."""
    kw = {"seed": seed, "drop_prob": 0.45, "max_drop_retries": 3}
    port, ref = _both("FaultSpec", kw)
    got, want, raised = [], [], 0
    for rnd in range(12):
        for src in range(4):
            for dst in range(4):
                for tag in (0, 2):
                    got.append(_streak(port, rnd, src, dst, tag))
                    want.append(_streak(ref, rnd, src, dst, tag))
                    raised += isinstance(want[-1], tuple)
    assert got == want
    assert raised and raised < len(want)  # both outcomes occur on the grid
    assert {g[0] for g in got if isinstance(g, tuple)} == {"TransientDropError"}
    assert tf.FaultSpec().retries(3, 0, 1) == 0


def test_error_taxonomy_matches_reference():
    for name in ("DeadRankError", "TransientDropError", "FallbackExhaustedError",
                 "WeightSyncError"):
        assert issubclass(getattr(tf, name), tf.FaultError)
        assert [c.__name__ for c in getattr(tf, name).__mro__] \
            == [c.__name__ for c in getattr(jf, name).__mro__]
    assert tf.__all__ == jf.__all__


# --------------------------------------------------------------------------
# the simulators
# --------------------------------------------------------------------------

SCHEDS = [("bcast", "pipelined_chain", 4, 5), ("bcast", "binomial", 8, 1),
          ("allreduce", "ring_allreduce", 4, 4), ("allreduce", "fused_rsb", 4, 3),
          ("reduce", "pipelined_reduce_chain", 3, 4), ("allgather", "ring_allgather", 4, 4),
          ("reduce_scatter", "ring_reduce_scatter", 3, 3)]
CLOCK_FAULTS = {"seed": 5, "link_slowdown": {(0, 1): 3.0, (2, 3): 1.5},
                "stalled_rounds": (0, 2, 50), "stall_s": 1e-4,
                "drop_prob": 0.2, "max_drop_retries": 12}


def _pair(op, algo, n, K):
    if op == "bcast":
        kw = {"num_chunks": K} if algo == "pipelined_chain" else {}
        return ts.build(algo, n, 1, **kw), js.build(algo, n, 1, **kw)
    return (tcs.build_op(op, algo, n, 0, num_chunks=K),
            jcs.build_op(op, algo, n, 0, num_chunks=K))


def _data(n, K, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((K, 3)) for _ in range(n)]


@pytest.mark.parametrize("op,algo,n,K", SCHEDS)
def test_simulators_under_clock_faults_match_reference(op, algo, n, K):
    """Clock and drop faults change no value: both replays are
    bit-identical to the fault-free ones, and the ``report``s (retries,
    stalled rounds) are the reference's."""
    port_s, ref_s = _pair(op, algo, n, K)
    data = _data(n, port_s.num_chunks)
    port_f, ref_f = _both("FaultSpec", CLOCK_FAULTS)
    clean = tsim.simulate_collective(port_s, data)
    for sim, jsimf, ps, rs in (
            (tsim.simulate_collective, jsim.simulate_collective, port_s, ref_s),
            (tsim.simulate_lowered, jsim.simulate_lowered,
             ts.lower_schedule(port_s), js.lower_schedule(ref_s))):
        got_rep, want_rep = {}, {}
        got = sim(ps, data, faults=port_f, report=got_rep)
        want = jsimf(rs, data, faults=ref_f, report=want_rep)
        for g, w, c in zip(got, want, clean):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, c)
        assert got_rep == want_rep
        assert got_rep["stalled_rounds"] >= 1  # round 0 stalls; round 50 is never reached
        assert sim(ps, data, report=got_rep) is not None and got_rep == {
            "retries": 0, "stalled_rounds": 0}


@pytest.mark.parametrize("op,algo,n,K", SCHEDS)
def test_dead_rank_raises_on_both_replays(op, algo, n, K):
    port_s, ref_s = _pair(op, algo, n, K)
    data = _data(n, port_s.num_chunks)
    spec = tf.FaultSpec(dead_ranks=(n - 1,))
    for replay, sched in ((tsim.simulate_collective, port_s),
                          (tsim.simulate_lowered, ts.lower_schedule(port_s))):
        with pytest.raises(tf.DeadRankError, match="plan_degraded"):
            replay(sched, data, faults=spec)
    with pytest.raises(tf.DeadRankError):
        tsim.timed_rounds(port_s, 1024, 1e-6, 1e9, faults=spec)


@pytest.mark.parametrize("op,algo,n,K", SCHEDS)
def test_timed_rounds_and_plan_clock_equal_reference(op, algo, n, K):
    port_s, ref_s = _pair(op, algo, n, K)
    for kw in ({}, CLOCK_FAULTS, {"link_slowdown": {(1, 0): 7.0}}):
        pf, rf = _both("FaultSpec", kw) if kw else (None, None)
        assert (tsim.timed_rounds(port_s, 4096, 2e-6, 5e9, faults=pf)
                == jsim.timed_rounds(ref_s, 4096, 2e-6, 5e9, faults=rf))
    pp = tplan.plan_collective(op, 1 << 20, n, algo=algo, tuner=TTuner(V5E))
    jp = jplan.plan_collective(op, 1 << 20, n, algo=algo, tuner=JTuner(jcm.TPU_V5E))
    pf, rf = _both("FaultSpec", CLOCK_FAULTS)
    assert pp.timed_rounds_s(V5E, faults=pf) == jp.timed_rounds_s(jcm.TPU_V5E, faults=rf)
    assert pp.timed_rounds_s(V5E, faults=pf) > pp.timed_rounds_s(V5E)


@pytest.mark.parametrize("algo", sorted(jcm.ALGO_COSTS))
def test_cost_degraded_equals_reference(algo):
    kw = {}
    if algo in ("pipelined_chain", "bidir_chain", "pipelined_reduce_chain", "fused_rsb"):
        kw = {"C": 65536.0}
    elif algo == "reduce_then_bcast":
        kw = {"t_bcast": 1e-4}
    elif algo.endswith("v"):
        kw = {"sizes": [4096.0, 0.0, 8192.0, 1024.0]}
    for slow in ((), (((0, 1), 4.0),), {(2, 3): 2.0, (1, 0): 3.5}):
        for inter_pod in (False, True):
            got = tcm.cost_degraded(algo, 1 << 22, 4, V5E, inter_pod=inter_pod,
                                    slow_links=slow, **kw)
            want = jcm.cost_degraded(algo, 1 << 22, 4, jcm.TPU_V5E, inter_pod=inter_pod,
                                     slow_links=slow, **kw)
            assert got == want, (algo, slow, inter_pod)
        assert tcm.degraded_bandwidth(5e10, slow) == jcm.degraded_bandwidth(5e10, slow)
    assert tcm.cost_degraded(algo, 1 << 22, 4, V5E, **kw) == tcm.cost(algo, 1 << 22, 4, V5E,
                                                                       **kw)


# --------------------------------------------------------------------------
# the stream and overlap clocks
# --------------------------------------------------------------------------

MIX = [65536, 65536, 4096, 4096, 512, 512]
FAULT_KEYS = ("comm_s_healthy", "comm_s_faulty", "fault_slowdown", "fault_fingerprint")


def _jtree(leaves):
    import jax

    return {f"l{i}": jax.ShapeDtypeStruct((e,), np.float32) for i, e in enumerate(leaves)}


def _ttree(leaves):
    return {f"l{i}": torch.empty((e,), dtype=torch.float32, device="meta")
            for i, e in enumerate(leaves)}


def _graphs():
    def specs(pkg, tree):
        S = pkg.StreamSpec
        return [S(name="grad_sync", tree=tree(MIX), axes=(("data", 4),), op="allreduce",
                  priority=1, compute_s=1e-3, bucket_bytes=64 << 10, reverse=True),
                S(name="weight_prefetch", tree=tree(MIX), axes=(("data", 4),), op="bcast",
                  priority=0, after=("grad_sync",), bucket_bytes=64 << 10)]

    return (tst.plan_streams(specs(tst, _ttree), tuner=TTuner(V5E)),
            jst.plan_streams(specs(jst, _jtree), tuner=JTuner(jcm.TPU_V5E)))


@pytest.mark.parametrize("kw", [CLOCK_FAULTS, {"link_slowdown": {(0, 1): 4.0}}, {}])
def test_stream_and_overlap_clocks_under_faults_match_reference(kw):
    port_g, ref_g = _graphs()
    pf, rf = _both("FaultSpec", kw)
    got = tst.simulate_streams(port_g, V5E, faults=pf)
    want = jst.simulate_streams(ref_g, jcm.TPU_V5E, faults=rf)
    assert got == want
    assert set(FAULT_KEYS) <= set(got)
    assert got["fault_fingerprint"] == rf.fingerprint()
    assert (got["fault_slowdown"] > 1.0) == bool(kw)
    for pe, je in zip(port_g.entries, ref_g.entries):
        assert pe.bucket_times_s(V5E, faults=pf) == je.bucket_times_s(jcm.TPU_V5E, faults=rf)
    oplan_kw = dict(bucket_bytes=64 << 10, compute_s=1e-3)
    port_o = tov.plan_overlap(_ttree(MIX), [("data", 4)], tuner=TTuner(V5E), **oplan_kw)
    ref_o = jov.plan_overlap(_jtree(MIX), [("data", 4)], tuner=JTuner(jcm.TPU_V5E), **oplan_kw)
    got = tov.simulate_overlap(port_o, V5E, faults=pf)
    assert got == jov.simulate_overlap(ref_o, jcm.TPU_V5E, faults=rf)
    assert set(FAULT_KEYS) <= set(got)
    assert "comm_s_healthy" not in tov.simulate_overlap(port_o, V5E)


def test_stream_clock_raises_on_a_dead_rank():
    port_g, _ = _graphs()
    with pytest.raises(tf.DeadRankError):
        tst.simulate_streams(port_g, V5E, faults=tf.FaultSpec(dead_ranks=(2,)))
