"""The port's executors on rank-stacked buffers against the reference's
numpy simulators: integer-valued float32 data, so every sum is exact and
the comparison is bit for bit."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import repro.comm.schedules as jcs
import repro.core.schedules as js
from repro.core.simulator import simulate_collective, simulate_lowered
from repro_torch import comm
from repro_torch.comm import executors
from repro_torch.comm import schedules as tcs
from repro_torch.core import schedules as ts
from repro_torch.launch import mesh as tmesh

CASES = [
    # (op, algo, kwargs)
    ("bcast", "binomial", {}),
    ("bcast", "chain", {}),
    ("bcast", "pipelined_chain", {"num_chunks": 5}),
    ("bcast", "bidir_chain", {"num_chunks": 4}),
    ("bcast", "knomial", {"k": 3}),
    ("reduce", "binomial_reduce", {}),
    ("reduce", "pipelined_reduce_chain", {"num_chunks": 4}),
    ("allreduce", "fused_rsb", {"num_chunks": 3}),
    ("allreduce", "ring_allreduce", {}),
    ("allgather", "ring_allgather", {}),
    ("reduce_scatter", "ring_reduce_scatter", {}),
]


def _pair(op, algo, n, kw):
    if op == "bcast":
        return js.build(algo, n, n - 1, **kw), ts.build(algo, n, n - 1, **kw)
    return (jcs.build_op(op, algo, n, 0, num_chunks=kw.get("num_chunks", 1)),
            tcs.build_op(op, algo, n, 0, num_chunks=kw.get("num_chunks", 1)))


def _data(n, K, C, seed):
    rng = np.random.RandomState(seed)
    return rng.randint(-50, 50, size=(n, K, C)).astype(np.float32)


@pytest.mark.parametrize("n", [2, 3, 4, 6])
@pytest.mark.parametrize("op,algo,kw", CASES)
def test_executors_match_simulators(op, algo, kw, n):
    ref, port = _pair(op, algo, n, kw)
    data = _data(n, port.num_chunks, 9, seed=n)
    want = np.stack(simulate_collective(ref, list(data)))
    want_lowered = np.stack(simulate_lowered(js.lower_schedule(ref), list(data)))
    unrolled = executors.execute_collective(port, torch.from_numpy(data.copy()))
    compiled = executors.execute_compiled(port, torch.from_numpy(data.copy()))
    np.testing.assert_array_equal(unrolled.numpy(), want)
    np.testing.assert_array_equal(compiled.numpy(), want_lowered)
    assert torch.equal(compiled.view(torch.int32), unrolled.view(torch.int32))


@pytest.mark.parametrize("n", [2, 3, 4, 5])
@pytest.mark.parametrize("op", ["bcast", "reduce", "allreduce", "allgather", "reduce_scatter"])
def test_apply_plan_compiled_equals_unrolled(op, n):
    rng = np.random.RandomState(7 * n)
    x = rng.randint(-9, 9, size=(n, 13, 7)).astype(np.float32)  # 91 elements: ragged chunks
    plan = comm.plan_collective(op, x[0].nbytes, n, algo="auto")
    outs = [comm.apply_plan(plan, torch.from_numpy(x.copy()), compiled=c) for c in (False, True)]
    assert torch.equal(outs[0], outs[1])
    flat = x.reshape(n, -1)
    got = outs[0].numpy()
    if op == "bcast":
        np.testing.assert_array_equal(got, np.broadcast_to(x[0], x.shape))
    elif op == "reduce":
        np.testing.assert_array_equal(got[0], x.sum(0))
    elif op == "allreduce":
        np.testing.assert_array_equal(got, np.broadcast_to(x.sum(0), x.shape))
    elif op == "allgather":
        np.testing.assert_array_equal(got, np.broadcast_to(x, (n,) + x.shape))
    else:
        shard = -(-flat.shape[1] // n)
        full = np.pad(flat.sum(0), (0, shard * n - flat.shape[1]))
        np.testing.assert_array_equal(got, full.reshape(n, shard))


@pytest.mark.parametrize("algo", ["auto", "pipelined_chain", "binomial", "xla_psum",
                                  "xla_allgather"])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_pbcast_overwrites_nan_replicas(algo, dt):
    x = torch.randn((4, 33, 5), generator=torch.Generator().manual_seed(1)).to(dt)
    x[1:] = float("nan")
    root = x[0].clone()
    for compiled in (None, True):
        if compiled and algo.startswith("xla"):
            continue
        out = comm.pbcast(x.clone(), algo=algo, compiled=compiled)
        for r in range(4):
            assert torch.equal(out[r].view(torch.int16 if dt == torch.bfloat16 else torch.int32),
                               root.view(torch.int16 if dt == torch.bfloat16 else torch.int32))


def test_unported_paths_raise():
    sched = ts.build("binomial", 4, 0)
    with pytest.raises(NotImplementedError, match="B.6"):
        executors.execute_inkernel(sched, torch.zeros((4, 1, 3)))
    plan = comm.plan_collective("bcast", 4096, 4, algo="binomial", wire_format="int8")
    with pytest.raises(NotImplementedError, match="B.5"):
        comm.apply_plan(plan, torch.zeros((4, 256, 4)))
    with pytest.raises(ValueError):
        comm.apply_plan(plan, torch.zeros((3, 1024)))  # 3 rank rows for n=4


def test_mesh_reads_as_topology():
    mesh = tmesh.make_mesh(4, device="cpu")
    assert mesh.devices.shape == (4,) and mesh.axis_names == ("data",)
    from repro_torch.dist import topology

    assert topology.axis_sizes(mesh) == {"data": 4}
    assert topology.bcast_axes(mesh) == ("data",)


def test_mesh_needs_a_rank():
    with pytest.raises(ValueError, match="at least one rank"):
        tmesh.make_mesh(0, device="cpu")


@pytest.mark.parametrize("op", ["bcast", "reduce", "allreduce", "allgather", "reduce_scatter"])
def test_executor_routing_matches_reference(op):
    """Both packages send every plan to the same executor."""
    import dataclasses

    import repro.comm.api as japi
    import repro.comm.plan as jplan
    from repro.core.cost_model import TPU_V5E
    from repro.core.tuner import Tuner as JTuner
    from repro_torch.comm import api as tapi
    from repro_torch.core.cost_model import Hardware
    from repro_torch.core.tuner import Tuner as TTuner

    jt, tt = JTuner(TPU_V5E), TTuner(Hardware(**dataclasses.asdict(TPU_V5E)))
    for n in (2, 4, 8, 64):
        for M in (1 << 10, 1 << 20, 1 << 30):
            jp = jplan.plan_collective(op, M, n, tuner=jt)
            tp = comm.plan_collective(op, M, n, tuner=tt)
            for kw in ({}, {"fused": False}, {"compiled": True}, {"compiled": False}):
                assert tapi._resolve_exec_path(tp, **kw) == japi._resolve_exec_path(jp, **kw)
