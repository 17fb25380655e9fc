"""The port's in-kernel schedule replay against the reference, on the CPU.

The plain replay (what a CPU tensor takes) against the reference's Pallas
``inkernel_replay_shared`` in interpret mode and its numpy oracle
``inkernel_shared_ref``, bit for bit in f32 and bf16; the three executors
against each other; snapshot semantics on a schedule in which two ranks
swap a chunk; the host-side overlap modes against a brute-force count; and
the compressed-wire veto of the executor routing."""
from __future__ import annotations

import contextlib
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.comm.api as japi
import repro.comm.plan as jplan
import repro.comm.schedules as jcs
import repro.core.schedules as js
from repro.core.cost_model import TPU_V5E
from repro.core.tuner import Tuner as JTuner
from repro.kernels.inkernel_collective import inkernel_replay_shared as jreplay
from repro.kernels.ref import inkernel_shared_ref
from repro_torch import comm
from repro_torch.comm import api as tapi
from repro_torch.comm import executors
from repro_torch.comm import schedules as tcs
from repro_torch.core import schedules as ts
from repro_torch.core.cost_model import Hardware
from repro_torch.core.simulator import simulate_collective, simulate_lowered
from repro_torch.core.tuner import Tuner as TTuner
from repro_torch.kernels import inkernel_collective as ik

# one intra-op thread: the suite runs in several worker processes at once, and
# the spinning OpenMP threads of each would contend for the same cores
torch.set_num_threads(1)


def _builders(mod_s, mod_c, n: int, K: int):
    """Every builder at (n, K): bcast, reduce, allreduce, allgather and
    reduce_scatter, from one package's modules."""
    out = [
        mod_s.build("direct", n), mod_s.build("chain", n),
        mod_s.build("pipelined_chain", n, 1 % n, num_chunks=K),
        mod_s.build("binomial", n),
        mod_c.build_op("reduce", "binomial_reduce", n, 0),
        mod_c.build_op("reduce", "pipelined_reduce_chain", n, 0, num_chunks=K),
        mod_c.build_op("allreduce", "fused_rsb", n, 0, num_chunks=K),
        mod_c.build_op("allgather", "ring_allgather", n, 0),
        mod_c.build_op("reduce_scatter", "ring_reduce_scatter", n, 0),
    ]
    if n >= 3:
        out.append(mod_c.build_op("allreduce", "ring_allreduce", n, 0))
    if n >= 4:
        out.append(mod_s.build("bidir_chain", n, 0, num_chunks=K))
    if n >= 4 and n & (n - 1) == 0:
        out += [mod_s.build("scatter_allgather", n), mod_s.build("knomial", n, k=4)]
    return out


def _port_buf(data: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(data.copy()).to(dtype)


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view({2: torch.int16, 4: torch.int32}[x.element_size()]).numpy()
    x = np.asarray(x)
    return x.view({2: np.int16, 4: np.int32}[x.dtype.itemsize])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,K", [(2, 5), (3, 1), (4, 1), (4, 5), (6, 5), (8, 3)])
def test_plain_replay_matches_reference_kernel(n, K, dtype):
    """The port's plain replay, the reference's interpret-mode kernel and
    its numpy oracle agree bit for bit over every builder; -0.0 and NaN
    payloads sit in every rank's last column."""
    rng = np.random.RandomState(10 * n + K)
    tdt = getattr(torch, dtype)
    for ref, port in zip(_builders(js, jcs, n, K), _builders(ts, tcs, n, K)):
        assert ref.name == port.name
        data = rng.randn(n, port.num_chunks, 3).astype(np.float32)
        data[:, 0, 2] = -0.0
        data[:, -1, 2] = np.nan
        shared = jnp.asarray(data).astype(jnp.dtype(dtype))
        # the port's buffer takes the reference's bits (the two frameworks
        # round a NaN to bf16 with different payloads)
        buf = torch.from_numpy(_bits(shared).copy()).view(tdt)
        want = np.asarray(jreplay(js.lower_schedule(ref), shared, interpret=True))
        oracle = inkernel_shared_ref(js.pack_tables(js.lower_schedule(ref)), np.asarray(shared))
        got = ik.inkernel_replay_shared(ts.lower_schedule(port), buf)
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=port.name)
        np.testing.assert_array_equal(_bits(got), _bits(oracle), err_msg=port.name)


@pytest.mark.parametrize("n", [2, 3, 4, 6])
def test_inkernel_equals_compiled_equals_unrolled(n):
    """The three executors of the port agree bit for bit (bf16, where every
    combine round rounds), and match the numpy simulators on exact f32."""
    rng = np.random.RandomState(n)
    for sched in _builders(ts, tcs, n, 4):
        data = rng.randn(n, sched.num_chunks, 7).astype(np.float32)
        outs = [run(sched, _port_buf(data, torch.bfloat16)) for run in
                (executors.execute_inkernel, executors.execute_compiled,
                 executors.execute_collective)]
        for o in outs[1:]:
            assert np.array_equal(_bits(outs[0]), _bits(o)), sched.name
        ints = np.round(data * 10)
        got = executors.execute_inkernel(sched, torch.from_numpy(ints.copy())).numpy()
        np.testing.assert_array_equal(got, np.stack(simulate_collective(sched, list(ints))))
        np.testing.assert_array_equal(
            got, np.stack(simulate_lowered(ts.lower_schedule(sched), list(ints))))


@pytest.mark.parametrize("op", ["bcast", "reduce", "allreduce", "allgather", "reduce_scatter"])
def test_apply_plan_inkernel_equals_compiled(op):
    x = np.random.RandomState(3).randint(-9, 9, size=(4, 13, 7)).astype(np.float32)
    plan = comm.plan_collective(op, x[0].nbytes, 4, algo="auto")
    a = comm.apply_plan(plan, torch.from_numpy(x.copy()), inkernel=True)
    b = comm.apply_plan(plan, torch.from_numpy(x.copy()), compiled=True)
    assert torch.equal(a, b)


def _swap(combine: bool) -> ts.Schedule:
    """Ranks 0 and 1 swap chunk 0 in round 0 (and again in round 2, where
    0 and 2 also swap chunk 1): a class-round whose reads and writes share
    rows."""
    T = ts.Transfer
    rounds = (
        ts.Round((T(0, 1, 0, 1, combine), T(1, 0, 0, 1, combine))),
        ts.Round((T(1, 2, 0, 2, combine),)),
        ts.Round((T(2, 0, 1, 1, combine), T(0, 2, 1, 1, combine), T(1, 0, 0, 1, combine))),
    )
    return ts.Schedule("swap", 3, 0, 2, rounds, kind="allreduce" if combine else "bcast")


@pytest.mark.parametrize("combine", [False, True])
def test_swap_schedule_reads_the_snapshot(combine):
    sched = _swap(combine)
    low = ts.lower_schedule(sched)
    modes = ik.round_modes(ts.pack_tables(low))
    assert (modes == ik.STAGED).sum() == 2 and (modes == ik.DIRECT).sum() == 2
    data = np.arange(12, dtype=np.float32).reshape(3, 2, 2)
    want = np.stack(simulate_collective(sched, list(data)))
    got = executors.execute_inkernel(sched, torch.from_numpy(data.copy())).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        executors.execute_compiled(sched, torch.from_numpy(data.copy())).numpy(), want)
    # without the snapshot, rank 1 would receive rank 0's chunk after rank 0
    # had already taken rank 1's
    naive = data.copy()
    for t in sched.rounds[0].transfers:
        sl = slice(t.chunk_start, t.chunk_start + t.chunk_count)
        naive[t.dst, sl] = naive[t.dst, sl] + naive[t.src, sl] if combine else naive[t.src, sl]
    assert not np.array_equal(naive, np.stack(simulate_collective(
        dataclasses.replace(sched, rounds=sched.rounds[:1]), list(data))))


def _brute_force_modes(tables) -> np.ndarray:
    C, T, K = tables.num_classes, tables.num_rounds, tables.num_chunks
    out = np.zeros((C, T), np.int32)
    for c in range(C):
        for s in range(T):
            reads, writes = [], []
            for src, dst in tables.perms[c]:
                for i in range(int(tables.lo[c, s, dst]), int(tables.hi[c, s, dst])):
                    reads.append(src * K + int(tables.send_start[c, s, src]) + i)
                    writes.append(dst * K + int(tables.recv_start[c, s, dst]) + i)
            if reads:
                clash = sum(1 for r in reads for w in writes if r == w)
                out[c, s] = ik.STAGED if clash else ik.DIRECT
    return out


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_round_modes_match_brute_force(n):
    scheds = [s for K in (1, 4, 21, 32) for s in _builders(ts, tcs, n, K)]
    scheds += [_swap(False), _swap(True)]
    for sched in scheds:
        tables = ts.pack_tables(ts.lower_schedule(sched))
        np.testing.assert_array_equal(ik.round_modes(tables), _brute_force_modes(tables),
                                      err_msg=sched.name)


def test_replay_bytes_counts_merged_rows():
    """Every transfer's rows are merged once: read the source, write the
    destination, and read it too when the transfer combines."""
    for n in (2, 3, 4):
        for sched in _builders(ts, tcs, n, 4):
            tables = ts.pack_tables(ts.lower_schedule(sched))
            want = sum(t.chunk_count * (3 if t.combine else 2)
                       for r in sched.rounds for t in r.transfers) * 10 * 2
            assert ik.replay_bytes(tables, 10, 2) == want, sched.name


def test_compressed_plans_stay_off_the_inkernel_path():
    """An explicit inkernel=True on a compressed plan raises in both
    packages; a tuned 'inkernel' entry on it falls through to the same
    executor as the reference's."""
    M, n = 1 << 20, 4
    with pytest.raises(ValueError, match="compressed"):
        comm.apply_plan(comm.plan_collective("allreduce", M, n, wire_format="int8"),
                        torch.zeros((n, M // 4)), inkernel=True)
    hw = Hardware(**dataclasses.asdict(TPU_V5E))
    for fmt in (None, "int8", "fp8"):
        jt, tt = JTuner(TPU_V5E), TTuner(hw)
        for t in (jt, tt):
            t.record(M, n, "fused_rsb", 4, 1e-6, op="allreduce",
                     extras={"exec_path": "inkernel"})
        jp = jplan.plan_collective("allreduce", M, n, tuner=jt, wire_format=fmt)
        tp = comm.plan_collective("allreduce", M, n, tuner=tt, wire_format=fmt)
        for kw in ({}, {"inkernel": False}, {"compiled": True}, {"fused": False}):
            got = tapi._resolve_exec_path(tp, **kw)
            assert got == japi._resolve_exec_path(jp, **kw), (fmt, kw)
            assert (got == "inkernel") == (fmt is None and not kw), (fmt, kw, got)
        with pytest.raises(ValueError) if fmt else contextlib.nullcontext():
            tapi._resolve_exec_path(tp, inkernel=True)


def test_inkernel_wrapper_rejects_bad_buffers():
    low = ts.lower_schedule(ts.build("chain", 3))
    with pytest.raises(TypeError):
        ik.inkernel_replay_shared(low, torch.zeros((3, 1, 4), dtype=torch.float16))
    with pytest.raises(ValueError):
        ik.inkernel_replay_shared(low, torch.zeros((4, 1, 4)))
    with pytest.raises(ValueError):
        executors.execute_inkernel(low, torch.zeros((3, 2, 4)))
