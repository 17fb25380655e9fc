"""The port's wire-format and link-class cost forms and its ``OnlineTuner``
against the reference's, on the CPU.

``cost_wire`` over every algorithm, wire format and path class, with and
without a chunk size; ``calibrate_link_classes`` on planted constants and
its rejections; ``cost_link_class``; ``calibrate_t_launch`` on the
reference's committed compile table (read as test data) and its rejection;
``worst_link_factor``; ``CPU_SIM``. Then the ``OnlineTuner``: the same
decisions, tables and fingerprints step by step on a rigged landscape, the
same arms, the refusal of ragged ops, and the plan-cache invalidation the
reference's test holds. Every comparison is exact: both packages run the
same float arithmetic in the same order. The reference prices on its v5e
profile, so the port is handed the same constants
(``Hardware(**asdict(TPU_V5E))``).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os

import pytest
import torch

from repro.core import cost_model as jcm
from repro.core.tuner import OnlineTuner as JOnline
from repro.core.tuner import Tuner as JTuner
from repro_torch import comm
from repro_torch.comm.compress import WireFormat
from repro_torch.core import cost_model as tcm
from repro_torch.core.tuner import OPS, RAGGED_OPS, OnlineTuner, Tuner

# one intra-op thread: the suite runs in several worker processes at once, and
# the spinning OpenMP threads of each would contend for the same cores
torch.set_num_threads(1)

V5E = tcm.Hardware(**dataclasses.asdict(jcm.TPU_V5E))
GRID = ((1 << 10, 4), (12345, 3), (3 << 18, 8), (1 << 26, 16))
FORMATS = (None, "bf16", "fp8", "int8")
ROOT = os.path.join(os.path.dirname(__file__), "..")


def _outcome(fn):
    """``fn()``'s value, or the name of what it raised (NaN compared by
    its repr)."""
    try:
        v = fn()
    except Exception as e:  # noqa: BLE001 — both packages must raise alike
        return ("raise", type(e).__name__)
    return ("nan",) if isinstance(v, float) and math.isnan(v) else v


# --------------------------------------------------------------------------
# the cost forms
# --------------------------------------------------------------------------


@pytest.mark.parametrize("algo", sorted(jcm.ALGO_COSTS))
def test_cost_wire_equals_reference(algo):
    for M, n in GRID:
        for fmt in FORMATS:
            for inter_pod in (False, True):
                for kw in ({}, {"C": float(math.ceil(M / 7))}):
                    want = _outcome(lambda: jcm.cost_wire(
                        algo, M, n, jcm.TPU_V5E, wire_format=fmt, inter_pod=inter_pod, **kw))
                    got = _outcome(lambda: tcm.cost_wire(
                        algo, M, n, V5E, wire_format=fmt, inter_pod=inter_pod, **kw))
                    assert got == want, (algo, M, n, fmt, inter_pod, kw)
    assert tcm.cost_wire(algo, 1 << 20, 4, V5E) == tcm.cost(algo, 1 << 20, 4, V5E)


def test_cost_wire_refuses_an_unknown_format():
    for cm, hw in ((jcm, jcm.TPU_V5E), (tcm, V5E)):
        with pytest.raises(ValueError, match="unknown wire format"):
            cm.cost_wire("ring_allreduce", 1 << 20, 4, hw, wire_format="int4")
    assert tcm.WIRE_PAYLOAD_FRACTION == jcm.WIRE_PAYLOAD_FRACTION
    assert tcm._QUANTIZE_HBM_PASSES == jcm._QUANTIZE_HBM_PASSES


def _samples(seed: int) -> dict:
    """Planted (bytes, seconds) samples of three link classes, one of them
    noisy."""
    rng = torch.Generator().manual_seed(seed)
    noise = (torch.rand(6, generator=rng) * 1e-7).tolist()
    sizes = [1 << k for k in (10, 13, 16, 19, 22, 25)]
    return {"nvlink": [(b, 2e-6 + b / 4.5e11) for b in sizes[:3]],
            "rail0:up": [(b, 7e-6 + b / 5e10) for b in sizes],
            "rail0:down": [(b, 7e-6 + b / 2.5e10 + e) for b, e in zip(sizes, noise)]}


def test_calibrate_link_classes_equals_reference():
    samples = _samples(0)
    want = jcm.calibrate_link_classes(samples)
    got = tcm.calibrate_link_classes(samples)
    assert {k: dataclasses.asdict(v) for k, v in got.items()} == \
        {k: dataclasses.asdict(v) for k, v in want.items()}
    assert math.isclose(got["rail0:up"].bw, 5e10, rel_tol=1e-9)
    assert math.isclose(got["rail0:up"].ts, 7e-6, rel_tol=1e-6)
    for name, link in got.items():
        for algo in ("ring_allreduce", "pipelined_chain", "binomial", "fused_rsb"):
            for M, n in GRID:
                kw = {"C": float(M // 4)} if algo in ("pipelined_chain", "fused_rsb") else {}
                assert tcm.cost_link_class(algo, M, n, link, V5E, **kw) == \
                    jcm.cost_link_class(algo, M, n, want[name], jcm.TPU_V5E, **kw), (name, algo)


@pytest.mark.parametrize("samples", [
    {"one": [(1024, 1e-3)]},                             # one sample
    {"same": [(1024, 1e-3), (1024, 2e-3)]},              # one size
    {"flat": [(1024, 1e-3), (1 << 20, 1e-3)]},           # flat: no bandwidth
    {"down": [(1024, 2e-3), (1 << 20, 1e-3)]},           # negative slope
])
def test_calibrate_link_classes_refuses_as_reference(samples):
    for cm in (jcm, tcm):
        with pytest.raises(ValueError, match="link class"):
            cm.calibrate_link_classes(samples)


def test_calibrate_t_launch_equals_reference_on_the_committed_table():
    with open(os.path.join(ROOT, "experiments", "compile_table.json")) as f:
        table = json.load(f)
    assert tcm.calibrate_t_launch(table) == jcm.calibrate_t_launch(table)
    group = {k: e for k, e in table.items() if k.startswith("n8/bcast/")}
    assert tcm.calibrate_t_launch(group) == jcm.calibrate_t_launch(group)
    flat = {"n8/bcast/chain/K4": {"num_rounds": 4, "unrolled_lower_s": 0.1},
            "n8/bcast/chain": {"num_rounds": 5, "unrolled_lower_s": 0.2}}
    for cm in (jcm, tcm):
        with pytest.raises(ValueError, match="no multi-K group"):
            cm.calibrate_t_launch(flat)


def test_worst_link_factor_and_cpu_sim_equal_reference():
    for report in ({}, (), {(0, 1): 2.5, (2, 3): 0.5}, [((0, 1), 0.5)],
                   [((0, 1), 3), ((1, 2), 4.5)], {(1, 0): 1.0}):
        assert tcm.worst_link_factor(report) == jcm.worst_link_factor(report), report
    assert dataclasses.asdict(tcm.CPU_SIM) == dataclasses.asdict(jcm.CPU_SIM)


# --------------------------------------------------------------------------
# the OnlineTuner
# --------------------------------------------------------------------------


def _landscape(d) -> float:
    """A rigged, deterministic time for every arm: compressed formats and
    more chunks cost less, with a term per algorithm so that some
    observations improve on the table and others do not."""
    algo_term = sum(ord(c) for c in d.algo) % 7
    fmt_term = {"bf16": 3.0, "fp8": 1.5, "int8": 1.0}[d.wire_format or "bf16"]
    return 1e-4 * (1 + algo_term + fmt_term + 8.0 / d.num_chunks)


def _decision(d) -> tuple:
    return (d.algo, d.num_chunks, d.chunk_bytes, _outcome(lambda: d.predicted_s), d.source,
            d.wire_format)


@pytest.mark.parametrize("op,M,n,epsilon,seed", [
    ("allreduce", 64 << 20, 4, 0.25, 0),
    ("allreduce", 1 << 20, 8, 0.5, 3),
    ("bcast", 3 << 22, 8, 0.4, 1),
    ("reduce", 1 << 16, 4, 0.6, 2),
])
def test_online_tuner_steps_equal_reference(tmp_path, op, M, n, epsilon, seed):
    """Step by step, the same decision, the same saved table and the same
    fingerprint."""
    jt, tt = JTuner(jcm.TPU_V5E), Tuner(V5E)
    jo = JOnline(jt, op, M, n, epsilon=epsilon, seed=seed)
    to = OnlineTuner(tt, op, M, n, epsilon=epsilon, seed=seed)
    assert to.arms == jo.arms
    for step in range(3 * len(to.arms)):
        jd, js = jo.step(_landscape)
        td, ts = to.step(_landscape)
        assert _decision(td) == _decision(jd), step
        assert ts == js
        jt.save(str(tmp_path / "j.json"))
        tt.save(str(tmp_path / "t.json"))
        assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text(), step
        assert tt.fingerprint() == jt.fingerprint(), step
    assert to.best_arm() == jo.best_arm()


@pytest.mark.parametrize("op", [o for o in OPS if o not in RAGGED_OPS])
def test_online_tuner_arms_equal_reference(op):
    for M, n in ((1 << 10, 3), (1 << 20, 4), (48 << 20, 16)):
        for fmts in (("bf16", "fp8", "int8"), ("int8",)):
            jo = JOnline(JTuner(jcm.TPU_V5E), op, M, n, wire_formats=fmts)
            to = OnlineTuner(Tuner(V5E), op, M, n, wire_formats=fmts)
            assert to.arms == jo.arms, (op, M, n, fmts)
            assert [_decision(to._decision(a)) for a in to.arms] == \
                [_decision(jo._decision(a)) for a in jo.arms]
    arms = [("pipelined_chain", None, "fp8"), ("binomial", 1, "bf16")]
    assert OnlineTuner(Tuner(V5E), op, 1 << 20, 4, arms=arms).arms == \
        JOnline(JTuner(jcm.TPU_V5E), op, 1 << 20, 4, arms=arms).arms


def test_online_tuner_refuses_what_the_reference_refuses():
    for op in RAGGED_OPS:
        with pytest.raises(ValueError, match="ragged"):
            OnlineTuner(Tuner(V5E), op, 1 << 20, 8)
    with pytest.raises(ValueError, match="unknown collective op"):
        OnlineTuner(Tuner(V5E), "gather", 1 << 20, 8)
    with pytest.raises(ValueError, match="wire_format"):
        OnlineTuner(Tuner(V5E), "allreduce", 1 << 20, 8, wire_formats=("int4",))
    assert OnlineTuner(Tuner(V5E), "allreduce", 1 << 20, 8).best_arm() is None


def test_online_tuner_converges_and_invalidates_cached_plans():
    """The reference's test on the port: untried arms first in a fixed
    order, the planted best arm found within ``len(arms)`` steps, and the
    winning record invalidates every cached plan for the point."""
    M, n = 1 << 20, 8
    t = Tuner(V5E)
    ot = OnlineTuner(t, "allreduce", M, n, epsilon=0.0,
                     arms=[("reduce_then_bcast", None, "bf16"),
                           ("ring_allreduce", None, "bf16"),
                           ("ring_allreduce", None, "int8")])
    rig = {("reduce_then_bcast", "bf16"): 5e-3,
           ("ring_allreduce", "bf16"): 3e-3,
           ("ring_allreduce", "int8"): 1e-3}
    fp0 = t.fingerprint()
    comm.plan_cached("allreduce", M, n, tuner=t)
    misses0 = comm.cache_stats()["misses"]
    seen = []
    for _ in range(len(ot.arms)):
        dec, _s = ot.step(lambda d: rig[(d.algo, d.wire_format or "bf16")])
        seen.append((dec.algo, dec.wire_format or "bf16"))
    assert seen == list(rig)
    assert ot.best_arm()[0] == "ring_allreduce" and ot.best_arm()[2] == "int8"
    assert t.fingerprint() != fp0
    dec = ot.propose()
    assert (dec.algo, dec.wire_format, dec.source) == ("ring_allreduce", "int8", "empirical")
    plan = comm.plan_cached("allreduce", M, n, tuner=t)
    assert comm.cache_stats()["misses"] > misses0
    assert plan.wire_format is WireFormat.INT8
    # a slower observation changes nothing: same fingerprint, a cache hit
    fp1, hits = t.fingerprint(), comm.cache_stats()["hits"]
    ot.observe(dec, 2e-3)
    assert t.fingerprint() == fp1
    assert comm.plan_cached("allreduce", M, n, tuner=t) is plan
    assert comm.cache_stats()["hits"] == hits + 1
