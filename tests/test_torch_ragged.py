"""The port's ragged collectives against the reference's, on the CPU.

One 4-device subprocess runs the reference's ``pallgatherv`` and
``palltoallv`` under ``shard_map`` on the numpy inputs the port gets
rank-stacked: the size vectors and matrices of
``tests/test_ragged_multidev.py`` (zero-sized ranks, a rank that receives
nothing, one that sends nothing, poison beyond each valid prefix), compact
and padded layouts, every algorithm ('auto' and each named one) through the
unrolled and the compiled executor. The port's results are bit-equal to
the reference's through its unrolled, compiled and in-kernel executors, in
f32 and bf16 (the rows only move, so the reference runs f32 and its result
cast to bf16 is the bf16 result). The reference's tuner prices on its v5e
profile, so the port's gets the same constants, and the port's plans pick
the reference's algorithm for every case.

The same subprocess runs the reference's alltoallv ``moe_ffn`` (E = 6 over
4 ranks, a shared expert, f32) and its einsum oracle, which
``tests/test_torch_moe.py`` reads through :func:`moe_reference`.
"""
from __future__ import annotations

import dataclasses
import fcntl
import os

import numpy as np
import pytest
import torch

from repro.comm.plan import plan_cached as j_plan_cached
from repro.core import cost_model as jcm
from repro.core.tuner import Tuner as JTuner
from repro_torch import comm
from repro_torch.comm.plan import plan_cached as t_plan_cached
from repro_torch.core import cost_model as tcm
from repro_torch.core.tuner import Tuner

# one intra-op thread: the suite runs in several worker processes at once, and
# the spinning OpenMP threads of each would contend for the same cores
torch.set_num_threads(1)

N = 4
V5E = tcm.Hardware(**dataclasses.asdict(jcm.TPU_V5E))
DTYPES = ("float32", "bfloat16")
EXECUTORS = ({"compiled": False}, {"compiled": True})
GATHERV_SIZES = ((3, 1, 0, 2), (1, 1, 1, 1), (5, 0, 0, 7))
GATHERV_ALGOS = ("auto", "ring_allgatherv", "doubling_allgatherv")
A2AV_ALGOS = ("auto", "pairwise_alltoallv", "ring_alltoallv")
GATHERV_E, A2AV_E = 3, 2
# the padded round trip's matrix: rank 1 sends nothing, rank 2 receives 0 from 2
PADDED_M = ((2, 0, 1, 3), (0, 0, 0, 0), (1, 4, 0, 0), (2, 2, 2, 2))
# (in_padded, out_padded) of the padded cases
LAYOUTS = ((True, True), (True, False), (False, True))
# the expert-parallel moe_ffn case (tests/test_ragged_multidev.py's)
MOE_CFG = dict(name="t", family="moe", num_layers=1, d_model=8, num_heads=2, num_kv_heads=2,
               d_ff=16, vocab_size=32, num_experts=6, experts_per_token=2, moe_group_size=8,
               num_shared_experts=1)
MOE_B, MOE_T = 8, 16


def _a2av_matrices() -> list[np.ndarray]:
    """The three seeded matrices of the reference's compact test: random,
    rank 2 receiving nothing, rank 1 sending nothing."""
    rng = np.random.RandomState(1)
    out = []
    for trial in range(3):
        m = rng.randint(0, 4, size=(N, N)).astype(np.int64)
        if trial == 1:
            m[:, 2] = 0
        if trial == 2:
            m[1, :] = 0
        if m.sum() == 0:
            m[0, 0] = 1
        out.append(m)
    return out


def gatherv_cases() -> list[tuple]:
    """(key, input name, sizes, algo, executor, dtype) of every allgatherv
    case."""
    return [(f"gv/{i}/{algo}/{int(ex['compiled'])}/{dt}", f"gv/{i}", sizes, algo, ex, dt)
            for i, sizes in enumerate(GATHERV_SIZES) for algo in GATHERV_ALGOS
            for ex in EXECUTORS for dt in DTYPES]


def a2av_cases() -> list[tuple]:
    """(key, matrix index, algo, executor, in_padded, out_padded, dtype);
    matrix index 3 is :data:`PADDED_M`."""
    cases = [(f"av/{i}/{algo}/{int(ex['compiled'])}/{dt}", i, algo, ex, False, False, dt)
             for i in range(3) for algo in A2AV_ALGOS for ex in EXECUTORS for dt in DTYPES]
    cases += [(f"avp/{int(ip)}{int(op)}/{algo}/{int(ex['compiled'])}/{dt}", 3, algo, ex, ip,
               op, dt)
              for ip, op in LAYOUTS for algo in ("auto", "ring_alltoallv") for ex in EXECUTORS
              for dt in DTYPES]
    return cases


def _matrix(i: int) -> np.ndarray:
    return _a2av_matrices()[i] if i < 3 else np.asarray(PADDED_M, np.int64)


def _inputs() -> dict:
    """Every rank-stacked f32 input by name, with poison beyond each
    rank's valid rows (99, 88, 77 as in the reference's tests)."""
    rng = np.random.RandomState(0)
    out = {}
    for i, sizes in enumerate(GATHERV_SIZES):
        x = np.full((N, max(sizes), GATHERV_E), 99.0, np.float32)
        for r in range(N):
            x[r, :sizes[r]] = rng.randn(sizes[r], GATHERV_E)
        out[f"gv/{i}"] = x
    for i in range(4):
        m = _matrix(i)
        send = m.sum(axis=1)
        compact = np.full((N, max(int(send.max()), 1), A2AV_E), 88.0, np.float32)
        padded = np.full((N, N, max(int(m.max()), 1), A2AV_E), 77.0, np.float32)
        for s in range(N):
            pos = 0
            for d in range(N):
                block = rng.randn(int(m[s, d]), A2AV_E).astype(np.float32)
                compact[s, pos:pos + m[s, d]] = block
                padded[s, d, :m[s, d]] = block
                pos += m[s, d]
        out[f"av/{i}/compact"], out[f"av/{i}/padded"] = compact, padded
    out["moe/x"] = np.random.RandomState(1).randn(MOE_B, MOE_T, MOE_CFG["d_model"]).astype(
        np.float32)
    return out


_REFERENCE = r'''
import dataclasses
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.comm import api
from repro.configs.base import ModelConfig
from repro.core.cost_model import TPU_V5E
from repro.core.tuner import Tuner
from repro.models import moe as moe_lib

mesh = jax.make_mesh((N,), ("x",), axis_types=(jax.sharding.AxisType.Auto,))
tuner = Tuner(TPU_V5E)
data = dict(np.load(INPUTS))
xs = {}
for key, name, _s, _a, _e, dt in GV:
    xs[key] = jnp.asarray(data[name]).astype(dt)
for key, i, _a, _e, ip, _op, dt in AV:
    xs[key] = jnp.asarray(data[f"av/{i}/{'padded' if ip else 'compact'}"]).astype(dt)
MAT = {i: m for i, m in enumerate(MATRICES)}

def body(d):
    out = {}
    for key, _name, sizes, algo, ex, _dt in GV:
        out[key] = api.pallgatherv(d[key][0], "x", sizes=sizes, algo=algo, tuner=tuner, **ex)
    for key, i, algo, ex, ip, op, _dt in AV:
        out[key] = api.palltoallv(d[key][0], "x", sizes=MAT[i], algo=algo, tuner=tuner,
                                  in_padded=ip, out_padded=op, **ex)
    return {k: v[None] for k, v in out.items()}

f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("x"),), out_specs=P("x"),
                          check_vma=False))
out = {k: np.asarray(v) for k, v in f(xs).items()}

cfg = ModelConfig(**MOE_CFG)
cfga = dataclasses.replace(cfg, moe_dispatch="alltoallv")
p = moe_lib.init_moe(jax.random.PRNGKey(0), cfg, jnp.float32)
x = jnp.asarray(data["moe/x"])
y_ref, aux_ref = jax.jit(lambda pp, xx: moe_lib.moe_ffn(pp, xx, cfg))(p, x)
g = jax.jit(jax.shard_map(lambda pp, xx: moe_lib.moe_ffn(pp, xx, cfga, axis_name="x"),
                          mesh=mesh, in_specs=(P(), P("x")), out_specs=(P("x"), P()),
                          check_vma=False))
y, aux = g(p, x)
out.update({"moe/y": np.asarray(y), "moe/aux": np.asarray(aux),
            "moe/y_einsum": np.asarray(y_ref), "moe/aux_einsum": np.asarray(aux_ref)})
out.update({f"moe/p/{k}": np.asarray(v) for k, v in p.items() if k != "shared"})
out.update({f"moe/p/shared/{k}": np.asarray(v) for k, v in p["shared"].items()})
np.savez(PATH, **{k: v.view(np.uint16) if v.dtype.itemsize == 2 else v
                  for k, v in out.items()})
print("PASS")
'''


def _run_reference(dist, d) -> None:
    inputs, path = d / "inputs.npz", d / "reference.npz"
    np.savez(inputs, **_inputs())
    gv = [c for c in gatherv_cases() if c[-1] == "float32"]
    av = [c for c in a2av_cases() if c[-1] == "float32"]
    mats = [_matrix(i).tolist() for i in range(4)]
    code = (f"N = {N}\nGV = {gv!r}\nAV = {av!r}\nMATRICES = {mats!r}\n"
            f"MOE_CFG = {MOE_CFG!r}\nINPUTS = {str(inputs)!r}\nPATH = {str(path)!r}\n"
            + _REFERENCE)
    dist(code, devices=N, timeout=400, env={"OMP_NUM_THREADS": "1"})


def moe_reference(dist, tmp_path_factory) -> dict:
    """The reference's results of every case, from one 4-device subprocess
    per test session: the first module to ask runs it under a file lock in
    the session's shared temporary directory (one per run, also across
    xdist workers), the other reads its file."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent  # the run's directory, shared by its workers
    d = base / "torch_ragged_reference"
    d.mkdir(exist_ok=True)
    with open(d / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (d / "reference.npz").exists():
            _run_reference(dist, d)
    return dict(np.load(d / "reference.npz"))


@pytest.fixture(scope="module")
def reference(dist, tmp_path_factory):
    return moe_reference(dist, tmp_path_factory)


def _t(x: np.ndarray, dtype: str) -> torch.Tensor:
    return torch.from_numpy(x.copy()).to(getattr(torch, dtype))


def _want(reference: dict, key: str) -> np.ndarray:
    """The reference's result of case ``key``: its f32 run, as bf16 bits
    for a bf16 case."""
    want = reference[key.replace("bfloat16", "float32")]
    return _np(_t(want, "bfloat16")) if key.endswith("bfloat16") else want


def _np(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 \
        else t.numpy()


PORT_EXECUTORS = ({"compiled": False}, {"compiled": True}, {"inkernel": True})
GV_COMPILED = [c for c in gatherv_cases() if c[4]["compiled"]]
AV_COMPILED = [c for c in a2av_cases() if c[3]["compiled"]]


def _gatherv(case, ex) -> np.ndarray:
    _key, name, sizes, algo, _ex, dt = case
    got = comm.pallgatherv(_t(_inputs()[name], dt), sizes=sizes, algo=algo, tuner=Tuner(V5E),
                           **ex)
    assert got.shape == (N, sum(sizes), GATHERV_E)
    return _np(got)


def _a2av(case, ex) -> np.ndarray:
    _key, i, algo, _ex, ip, op, dt = case
    x = _t(_inputs()[f"av/{i}/{'padded' if ip else 'compact'}"], dt)
    return _np(comm.palltoallv(x, sizes=_matrix(i).tolist(), algo=algo, tuner=Tuner(V5E),
                               in_padded=ip, out_padded=op, **ex))


@pytest.mark.parametrize("case", gatherv_cases(), ids=[c[0] for c in gatherv_cases()])
def test_pallgatherv_matches_reference(reference, case):
    """Bit for bit against the reference's same algorithm and executor."""
    np.testing.assert_array_equal(_gatherv(case, case[4]), _want(reference, case[0]))


@pytest.mark.parametrize("case", GV_COMPILED, ids=[c[0] for c in GV_COMPILED])
def test_pallgatherv_inkernel_matches_reference(reference, case):
    """The port's in-kernel executor (its plain version here) against the
    reference's compiled replay of the same plan."""
    np.testing.assert_array_equal(_gatherv(case, {"inkernel": True}), _want(reference, case[0]))


@pytest.mark.parametrize("case", a2av_cases(), ids=[c[0] for c in a2av_cases()])
def test_palltoallv_matches_reference(reference, case):
    """Compact and padded layouts, bit for bit against the reference."""
    want = _want(reference, case[0])
    got = _a2av(case, case[3])
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", AV_COMPILED, ids=[c[0] for c in AV_COMPILED])
def test_palltoallv_inkernel_matches_reference(reference, case):
    np.testing.assert_array_equal(_a2av(case, {"inkernel": True}), _want(reference, case[0]))


def _host_reshuffle(m: np.ndarray, x: np.ndarray, in_padded: bool, out_padded: bool):
    """The alltoallv by numpy indexing, for the layouts' contract."""
    bmax = int(m.max())
    rmax = max(int(m.sum(axis=0).max()), 1)
    out = np.zeros((N, N, bmax) + x.shape[-1:] if out_padded else (N, rmax) + x.shape[-1:],
                   x.dtype)
    for r in range(N):
        pos = 0
        for s in range(N):
            h = int(m[s, r])
            if in_padded:
                block = x[s, r, :h]
            else:
                start = int(m[s, :r].sum())
                block = x[s, start:start + h]
            if out_padded:
                out[r, s, :h] = block
            else:
                out[r, pos:pos + h] = block
            pos += h
    return out


@pytest.mark.parametrize("i,ip,op", [(i, False, False) for i in range(3)]
                         + [(3, ip, op) for ip, op in LAYOUTS])
def test_palltoallv_is_the_host_reshuffle(i, ip, op):
    """Every layout is the numpy reshuffle of the blocks, zeros beyond each
    valid prefix (the reference's tests' contract), on every executor."""
    m = _matrix(i)
    x = _inputs()[f"av/{i}/{'padded' if ip else 'compact'}"]
    want = _host_reshuffle(m, x, ip, op)
    for ex in PORT_EXECUTORS:
        got = comm.palltoallv(torch.from_numpy(x.copy()), sizes=m.tolist(), in_padded=ip,
                              out_padded=op, **ex)
        np.testing.assert_array_equal(got.numpy(), want)


def _ref_plan(op: str, M: int, sizes):
    return j_plan_cached(op, M, N, tuner=JTuner(jcm.TPU_V5E), sizes=sizes)


@pytest.mark.parametrize("op,sizes,elems", [("allgatherv", s, GATHERV_E) for s in GATHERV_SIZES]
                         + [("allgatherv", (1000, 0, 30, 5000), 4096),
                            ("alltoallv", [[2576] * 4] * 4, 4096),
                            ("alltoallv", [2576, 2576, 1288, 1288], 4096)]
                         + [("alltoallv", _matrix(i).tolist(), A2AV_E) for i in range(4)])
def test_plans_pick_the_references_algorithm(op, sizes, elems):
    """For the same sizes and payload, the port's skew-aware tuner (the
    reference's v5e constants) picks the reference's algorithm, chunking
    and predicted time, and the same wire bytes and schedule."""
    flat = np.asarray(sizes).reshape(-1)
    M = int(flat.sum()) * elems * 4
    want = _ref_plan(op, M, sizes)
    got = t_plan_cached(op, M, N, tuner=Tuner(V5E), sizes=sizes)
    assert dataclasses.asdict(got.decision) == dataclasses.asdict(want.decision)
    assert got.sizes == want.sizes
    assert got.wire_bytes() == want.wire_bytes()
    assert [[(t.src, t.dst, t.chunk_start, t.chunk_count) for t in r.transfers]
            for r in got.schedule.rounds] == \
        [[(t.src, t.dst, t.chunk_start, t.chunk_count) for t in r.transfers]
         for r in want.schedule.rounds]


def test_apply_plan_no_longer_refuses_ragged_ops():
    """``apply_plan`` replays a pre-built ragged plan with the compact
    conventions of the entry points."""
    sizes = GATHERV_SIZES[0]
    x = torch.from_numpy(_inputs()["gv/0"])
    plan = comm.plan_collective("allgatherv", sum(sizes) * GATHERV_E * 4, N, sizes=sizes)
    np.testing.assert_array_equal(comm.apply_plan(plan, x.clone()).numpy(),
                                  comm.pallgatherv(x.clone(), sizes=sizes).numpy())
    m = _matrix(0)
    x = torch.from_numpy(_inputs()["av/0/compact"])
    plan = comm.plan_collective("alltoallv", int(m.sum()) * A2AV_E * 4, N, sizes=m.tolist())
    np.testing.assert_array_equal(comm.apply_plan(plan, x.clone()).numpy(),
                                  _host_reshuffle(m, x.numpy(), False, False))


def test_ragged_refusals():
    """The reference's validations and messages."""
    x = torch.zeros((N, 5, 3))
    with pytest.raises(ValueError, match="3 entries for axis size 4"):
        comm.pallgatherv(x, sizes=(1, 1, 1))
    with pytest.raises(ValueError, match="non-negative and non-empty"):
        comm.pallgatherv(x, sizes=(0, 0, 0, 0))
    with pytest.raises(ValueError, match="non-negative and non-empty"):
        comm.pallgatherv(x, sizes=(1, -1, 1, 1))
    with pytest.raises(ValueError, match="needs max"):
        comm.pallgatherv(x, sizes=(1, 6, 1, 1))
    with pytest.raises(ValueError, match="all zeros"):
        comm.palltoallv(x, sizes=[[0] * N] * N)
    with pytest.raises(ValueError, match="size matrix needs 8"):
        comm.palltoallv(x, sizes=[2] * N)
    with pytest.raises(ValueError, match="n, n\\*n, or matrix"):
        comm.palltoallv(x, sizes=[1, 1, 1])
    with pytest.raises(ValueError, match="block layout"):
        comm.palltoallv(torch.zeros((N, 3, 2, 1)), sizes=[1] * N, in_padded=True)
    with pytest.raises(ValueError, match="size matrix needs 2"):
        comm.palltoallv(torch.zeros((N, N, 1, 1)), sizes=[2] * N, in_padded=True)


def test_single_rank_and_empty_rows():
    """n == 1 returns the rank's valid prefix in each layout; a zero-width
    row returns zeros of the result's shape."""
    x = torch.arange(12.0).reshape(1, 4, 3)
    assert torch.equal(comm.pallgatherv(x, sizes=(2,)), x[:, :2])
    assert torch.equal(comm.palltoallv(x, sizes=[3]), x[:, :3])
    assert torch.equal(comm.palltoallv(x, sizes=[3], out_padded=True), x[:, None, :3])
    xp = x[:, None]
    assert torch.equal(comm.palltoallv(xp, sizes=[3], in_padded=True), x[:, :3])
    assert torch.equal(comm.palltoallv(xp, sizes=[3], in_padded=True, out_padded=True),
                       xp[:, :, :3])
    empty = torch.zeros((N, 5, 0))
    assert comm.pallgatherv(empty, sizes=(3, 1, 0, 2)).shape == (N, 6, 0)
    m = _matrix(0)
    assert comm.palltoallv(empty, sizes=m.tolist()).shape == (N, int(m.sum(0).max()), 0)
    assert comm.palltoallv(empty, sizes=m.tolist(), out_padded=True).shape == \
        (N, N, int(m.max()), 0)
