"""The port's host-side planner against the reference: schedules, lowered
round tables, kernel tables, tuner decisions, wire-byte accounting and the
parameter bucketing must be identical for the same inputs."""
from __future__ import annotations

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

import repro.comm.plan as jplan
import repro.comm.schedules as jcs
import repro.core.bucketing as jbucketing
import repro.core.schedules as js
import repro.core.tuner as jtuner
from repro.configs import get_config as j_get_config
from repro.core.cost_model import TPU_V5E
from repro.models import Model as JModel
from repro_torch.comm import plan as tplan
from repro_torch.comm import schedules as tcs
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import bucketing as tbucketing
from repro_torch.core import cost_model as tcost
from repro_torch.core import schedules as ts
from repro_torch.core import tuner as ttuner
from repro_torch.core.tree import tree_leaves
from repro_torch.models.convert import params_from_jax

NS = [2, 3, 4, 6, 8]
KS = [1, 3, 8]
# the reference's v5e constants, handed to the port explicitly (the port
# keeps no copy of them)
V5E = tcost.Hardware(**dataclasses.asdict(TPU_V5E))

BCAST = ["direct", "chain", "pipelined_chain", "bidir_chain", "binomial", "knomial",
         "scatter_allgather"]
OPS = [("reduce", "binomial_reduce"), ("reduce", "pipelined_reduce_chain"),
       ("allreduce", "fused_rsb"), ("allreduce", "ring_allreduce"),
       ("allgather", "ring_allgather"), ("allgather", "doubling_allgather"),
       ("reduce_scatter", "ring_reduce_scatter")]


def _dec(d) -> dict:
    """A Decision as a dict; NaN (the one-shots' unpriced time) compares equal."""
    return {k: "nan" if isinstance(v, float) and math.isnan(v) else v
            for k, v in dataclasses.asdict(d).items()}


def _pow2(n):
    return n & (n - 1) == 0


def _build_pair(op, algo, n, K):
    """The same schedule from both packages."""
    if op == "bcast":
        kw = {"num_chunks": K} if algo in ("pipelined_chain", "bidir_chain") else {}
        if algo == "knomial":
            kw = {"k": 3}
        return js.build(algo, n, 1 % n, **kw), ts.build(algo, n, 1 % n, **kw)
    return (jcs.build_op(op, algo, n, 0, num_chunks=K),
            tcs.build_op(op, algo, n, 0, num_chunks=K))


def _sched_key(s):
    return (s.name, s.n, s.root, s.num_chunks, s.kind, s.sizes,
            [[dataclasses.astuple(t) for t in r.transfers] for r in s.rounds])


def _lowered_key(lw):
    classes = [(c.perm, c.block, c.combine.tobytes(), c.send_start.tobytes(),
                c.recv_start.tobytes(), c.lo.tobytes(), c.hi.tobytes()) for c in lw.classes]
    lanes = [[[dataclasses.astuple(t) for t in lane] for lane in r] for r in lw.round_lanes]
    return (lw.name, lw.kind, lw.n, lw.num_chunks, classes, lanes)


def _tables_key(kt):
    return (kt.n, kt.num_chunks, kt.perms, kt.blocks,
            *(a.tobytes() for a in (kt.send_start, kt.recv_start, kt.lo, kt.hi, kt.combine)))


CASES = [(op, algo, n) for op, algo in [("bcast", a) for a in BCAST] + OPS for n in NS
         if _pow2(n) or algo not in ("scatter_allgather", "doubling_allgather")]


@pytest.mark.parametrize("op,algo,n", CASES)
def test_schedules_lowering_and_tables_match(op, algo, n):
    for K in KS:
        ref, port = _build_pair(op, algo, n, K)
        assert _sched_key(port) == _sched_key(ref)
        lr, lp = js.lower_schedule(ref), ts.lower_schedule(port)
        assert _lowered_key(lp) == _lowered_key(lr)
        assert lp.zero_waste == lr.zero_waste
        assert lp.wire_chunks_compiled() == lr.wire_chunks_compiled()
        assert _tables_key(ts.pack_tables(lp)) == _tables_key(js.pack_tables(lr))


@pytest.mark.parametrize("n", NS)
def test_reduce_then_bcast_composite_matches(n):
    for algo, kw in (("binomial", {}), ("pipelined_chain", {"num_chunks": 5})):
        if algo == "pipelined_chain" and n < 3:
            continue
        ref = jcs.reduce_then_bcast(n, 0, js.build(algo, n, 0, **kw))
        port = tcs.reduce_then_bcast(n, 0, ts.build(algo, n, 0, **kw))
        assert _sched_key(port) == _sched_key(ref)
        assert _lowered_key(ts.lower_schedule(port)) == _lowered_key(js.lower_schedule(ref))


SIZES_M = [1, 100, 4096, 65536, 1 << 20, 3 << 20, 1 << 24, 1 << 27, 2 << 30]


@pytest.mark.parametrize("inter_pod", [False, True])
@pytest.mark.parametrize("op", ["bcast", "reduce", "allreduce", "allgather", "reduce_scatter"])
def test_tuner_decisions_match(op, inter_pod):
    jt, tt = jtuner.Tuner(TPU_V5E), ttuner.Tuner(V5E)
    for n in NS + [16, 64]:
        for M in SIZES_M:
            want = jt.select(M, n, op=op, inter_pod=inter_pod)
            got = tt.select(M, n, op=op, inter_pod=inter_pod)
            assert _dec(got) == _dec(want), (op, n, M)


@pytest.mark.parametrize("op,sizes", [("allgatherv", (5, 0, 9, 2)), ("allgatherv", (1, 1, 1, 1)),
                                      ("alltoallv", (3, 1, 0, 7)),
                                      ("alltoallv", tuple(range(16)))])
def test_ragged_decisions_and_plans_match(op, sizes):
    jt, tt = jtuner.Tuner(TPU_V5E), ttuner.Tuner(V5E)
    for M in (256, 1 << 16, 1 << 22):
        want = jt.select(M, 4, op=op, sizes=sizes)
        assert _dec(tt.select(M, 4, op=op, sizes=sizes)) == _dec(want)
        jp = jplan.plan_collective(op, M, 4, tuner=jt, sizes=sizes)
        tp = tplan.plan_collective(op, M, 4, tuner=tt, sizes=sizes)
        assert _sched_key(tp.schedule) == _sched_key(jp.schedule)
        assert tp.wire_bytes() == jp.wire_bytes()


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("op", ["bcast", "reduce", "allreduce", "allgather", "reduce_scatter"])
def test_plans_and_wire_bytes_match(op, n):
    jt, tt = jtuner.Tuner(TPU_V5E), ttuner.Tuner(V5E)
    for M in SIZES_M:
        for algo in ("auto", "xla_psum") if op in ("bcast", "allreduce") else ("auto",):
            jp = jplan.plan_collective(op, M, n, tuner=jt, algo=algo)
            tp = tplan.plan_collective(op, M, n, tuner=tt, algo=algo)
            assert _dec(tp.decision) == _dec(jp.decision)
            assert tp.wire_bytes() == jp.wire_bytes()
            if jp.schedule is not None:
                assert _sched_key(tp.schedule) == _sched_key(jp.schedule)
            if tp.algo not in ("reduce_then_bcast", "noop", "xla_psum"):
                for fmt in (None, "int8", "fp8"):
                    assert tplan.expected_wire_bytes(op, tp.algo, M, n, tp.num_chunks,
                                                     wire_format=fmt) == \
                        jplan.expected_wire_bytes(op, jp.algo, M, n, jp.num_chunks,
                                                  wire_format=fmt)


def test_manual_decisions_match():
    jt, tt = jtuner.Tuner(TPU_V5E), ttuner.Tuner(V5E)
    for op, algo in [("bcast", "pipelined_chain"), ("bcast", "bidir_chain"),
                     ("reduce", "pipelined_reduce_chain"), ("allreduce", "fused_rsb"),
                     ("allreduce", "reduce_then_bcast"), ("allreduce", "ring_allreduce")]:
        for M in (4096, 1 << 22, 1 << 30):
            want = jplan.decide(op, M, 6, algo=algo, tuner=jt)
            got = tplan.decide(op, M, 6, algo=algo, tuner=tt)
            assert _dec(got) == _dec(want), (op, algo, M)


def test_plan_cache_keys_on_tuner_and_stream():
    tplan.plan_cache_clear()
    t1, t2 = ttuner.Tuner(V5E), ttuner.Tuner()
    a = tplan.plan_cached("bcast", 1 << 20, 4, tuner=t1)
    assert tplan.plan_cached("bcast", 1 << 20, 4, tuner=t1) is a
    assert tplan.plan_cached("bcast", 1 << 20, 4, tuner=t2) is not a
    assert tplan.plan_cached("bcast", 1 << 20, 4, tuner=t1, stream="g") is not a
    assert tplan.cache_stats()["hits"] == 1


def test_h100_profile_is_the_default():
    assert ttuner.default_tuner().hw is tcost.H100_SXM
    assert tcost.H100_SXM.hbm_bw == 3.35e12 and tcost.H100_SXM.peak_flops == 989e12


@pytest.mark.parametrize("bucket_bytes", [4 << 20, 64 << 10, 1 << 10])
def test_smoke_param_buckets_match(bucket_bytes):
    cfg = j_get_config("minitron-8b-smoke")
    jparams = JModel(cfg).init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    js_ = jbucketing.plan_buckets(jparams, bucket_bytes)
    ts_ = tbucketing.plan_buckets(tparams, bucket_bytes)
    assert ts_.bucket_sizes == js_.bucket_sizes
    assert ts_.bucket_bytes() == js_.bucket_bytes()
    assert [str(d).replace("torch.", "") for d in ts_.bucket_dtypes] == \
        [np.dtype(d).name for d in js_.bucket_dtypes]
    assert [(m.index, m.shape, m.bucket, m.offset) for m in ts_.leaves] == \
        [(m.index, m.shape, m.bucket, m.offset) for m in js_.leaves]
    assert dataclasses.asdict(t_get_config("minitron-8b-smoke")) == dataclasses.asdict(cfg)
    # packed contents agree element for element
    for jb, tb in zip(jbucketing.pack_buckets(jparams, js_), tbucketing.pack_buckets(tparams, ts_)):
        np.testing.assert_array_equal(np.asarray(jb, np.float32), tb.float().numpy())
    back = tbucketing.unpack_buckets(tbucketing.pack_buckets(tparams, ts_), ts_)
    for a, b in zip(jax.tree_util.tree_leaves(jparams),
                    tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b.float().numpy())


def test_stacked_leaves_pack_with_their_rank_axis():
    tree = {"b": torch.arange(12.).reshape(2, 3, 2), "a": torch.arange(4.).reshape(2, 2)}
    spec = tbucketing.plan_buckets({"b": torch.zeros(3, 2), "a": torch.zeros(2)})
    (bucket,) = tbucketing.pack_buckets(tree, spec)
    assert bucket.shape == (2, 8)  # 'a' first: sorted keys, as jax flattens
    np.testing.assert_array_equal(bucket[1].numpy(), [2, 3, 6, 7, 8, 9, 10, 11])
    back = tbucketing.unpack_buckets([bucket], spec)
    assert torch.equal(back["b"], tree["b"]) and torch.equal(back["a"], tree["a"])
