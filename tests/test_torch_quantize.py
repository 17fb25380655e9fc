"""The port's quantize pair and compressed wire against the reference.

The reference side runs its Pallas kernels in interpret mode on the CPU;
the port's side is the plain PyTorch twin (what its wrappers run on a CPU
tensor). Inputs are made with numpy from a seed and handed to both."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm.compress import CompressionState as JState
from repro.comm.compress import roundtrip as jroundtrip
from repro.kernels.ops import dequantize_blocks as jdequantize
from repro.kernels.ops import quantize_blocks as jquantize
from repro_torch import comm
from repro_torch.comm import executors
from repro_torch.comm.compress import CompressedWire, CompressionState, roundtrip
from repro_torch.core import schedules as ts
from repro_torch.kernels import quantize as qk

# one intra-op thread: the suite runs in several worker processes at once, and
# the spinning OpenMP threads of each would contend for the same cores
torch.set_num_threads(1)

FMTS = ["int8", "fp8"]


def _blocks_input(rows: int = 5, cols: int = 1000) -> np.ndarray:
    """A ragged width with a zero block, extreme values, a NaN block and
    rounding ties for int8."""
    rng = np.random.RandomState(0)
    x = (rng.randn(rows, cols) * 3).astype(np.float32)
    x[1, :256] = 0.0
    x[2, 0], x[2, 1], x[2, 2:10] = 1e30, -1e30, 1e-30
    x[3, 300] = np.nan
    x[4, :256] = (np.arange(256) - 128) * 0.5
    return x


def _bits(a: np.ndarray) -> np.ndarray:
    return np.asarray(a).view({1: np.uint8, 4: np.uint32}[np.asarray(a).dtype.itemsize])


def _port_bits(t: torch.Tensor) -> np.ndarray:
    return t.view({1: torch.uint8, 4: torch.int32}[t.element_size()]).numpy().view(
        {1: np.uint8, 4: np.uint32}[t.element_size()])


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("cols", [1000, 256, 1])
def test_plain_twins_match_reference_bit_for_bit(fmt, cols):
    """Payloads, scales and the dequantized values are bit-equal to the
    reference's (a NaN block included: its scale is NaN on both sides)."""
    x = np.ascontiguousarray(_blocks_input()[:, :cols])
    v, s = jquantize(jnp.asarray(x), fmt, interpret=True)
    pv, ps = qk.quantize_blocks(torch.from_numpy(x), fmt)
    assert pv.shape == v.shape and ps.shape == s.shape
    assert pv.dtype == qk.QUANT_DTYPES[fmt][0]
    np.testing.assert_array_equal(_port_bits(pv), _bits(v))
    np.testing.assert_array_equal(_port_bits(ps), _bits(s))
    d = np.asarray(jdequantize(v, s, out_cols=cols, interpret=True))
    pd = qk.dequantize_blocks(pv, ps, out_cols=cols).numpy()
    np.testing.assert_array_equal(pd.view(np.uint32), d.view(np.uint32))


@pytest.mark.parametrize("fmt", FMTS)
def test_zero_rows_return_empty_without_launch(fmt):
    before = qk.quantize_blocks.launches, qk.dequantize_blocks.launches
    v, s = qk.quantize_blocks(torch.zeros((0, 300)), fmt)
    jv, js = jquantize(jnp.zeros((0, 300), jnp.float32), fmt, interpret=True)
    assert tuple(v.shape) == jv.shape == (0, 512) and tuple(s.shape) == js.shape == (0, 2)
    assert tuple(qk.dequantize_blocks(v, s, out_cols=300).shape) == (0, 300)
    assert (qk.quantize_blocks.launches, qk.dequantize_blocks.launches) == before


@pytest.mark.parametrize("fmt", FMTS)
def test_row_tables_equal_gather_and_scatter(fmt):
    """``rows=`` on quantize is ``x[rows]``; on dequantize it writes
    ``out[rows]`` and leaves every other row alone."""
    x = torch.from_numpy(_blocks_input())
    rows = torch.tensor([4, 0, 2], dtype=torch.int64)
    v, s = qk.quantize_blocks(x, fmt, rows=rows)
    v2, s2 = qk.quantize_blocks(x[rows].contiguous(), fmt)
    assert torch.equal(_as_bytes(v), _as_bytes(v2)) and torch.equal(s, s2)
    out = torch.full((6, 1000), 7.0)
    land = torch.tensor([5, 1, 3], dtype=torch.int64)
    qk.dequantize_blocks(v, s, out_cols=1000, out=out, rows=land)
    want = qk.dequantize_blocks(v2, s2, out_cols=1000)
    np.testing.assert_array_equal(out[land].numpy(), want.numpy())
    assert (out[[0, 2, 4]] == 7.0).all()


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("cols", [1001, 1002, 1003])
def test_dequantize_into_an_odd_pitch_receive_view_matches_reference(fmt, cols):
    """As the compressed hop calls it: the payload of three send rows
    written through ``rows=`` into a receive view ``(n * block, C)`` whose
    pitch is 1, 2 or 3 mod 4 and whose width crosses 256-column blocks;
    the landed rows are bit-equal to the reference's dequantize (interpret
    mode), NaN block included, and every other row keeps its bytes."""
    x = np.ascontiguousarray(_blocks_input(cols=cols)[[0, 2, 3]])
    v, s = jquantize(jnp.asarray(x), fmt, interpret=True)
    want = np.asarray(jdequantize(v, s, out_cols=cols, interpret=True))
    pv, ps = qk.quantize_blocks(torch.from_numpy(x), fmt)
    n, block = 3, 2
    recv = torch.full((n, block, cols), 7.0)
    land = torch.tensor([5, 0, 3], dtype=torch.int64)
    out = recv.view(n * block, cols)
    assert out.stride(0) % 4 == cols % 4 != 0
    got = qk.dequantize_blocks(pv, ps, out_cols=cols, out=out, rows=land)
    assert got is out
    np.testing.assert_array_equal(out[land].numpy().view(np.uint32), want.view(np.uint32))
    assert (out[[1, 2, 4]] == 7.0).all()
    assert np.isnan(want[2, 300]) and np.isnan(out[3, 300].item())


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.uint8)


def test_unknown_format_and_bad_inputs_rejected():
    with pytest.raises(ValueError):
        qk.quantize_blocks(torch.zeros((1, 256)), "int4")
    with pytest.raises(TypeError):
        qk.quantize_blocks(torch.zeros((1, 256), dtype=torch.bfloat16), "int8")
    with pytest.raises(ValueError):
        qk.dequantize_blocks(torch.zeros((1, 300), dtype=torch.int8), torch.zeros((1, 2)))


@pytest.mark.parametrize("fmt", FMTS + ["bf16"])
def test_roundtrip_and_residual_update_match_reference(fmt):
    rng = np.random.RandomState(3)
    tree = {"a": rng.randn(3, 7, 41).astype(np.float32), "b": rng.randn(300).astype(np.float32)}
    jt = {k: jnp.asarray(v) for k, v in tree.items()}
    tt = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    for k in tree:
        want = np.asarray(jroundtrip(jt[k], fmt, interpret=True))
        np.testing.assert_array_equal(roundtrip(tt[k], fmt).numpy(), want)
    want = JState.update(jt, fmt, interpret=True)
    got = CompressionState.update(tt, fmt)
    for k in tree:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # the in-place rank-stacked form: row r is rank r's own update
    stacked = torch.stack([tt["a"], tt["a"] * 2])
    CompressionState.update_(stacked, fmt)
    for r, scale in enumerate((1, 2)):
        ref = JState.update({"a": jt["a"] * scale}, fmt, interpret=True)["a"]
        np.testing.assert_array_equal(stacked[r].numpy(), np.asarray(ref))


def test_compensate_and_init_match_reference():
    rng = np.random.RandomState(4)
    g = rng.randn(5, 6).astype(np.float32)
    e = rng.randn(5, 6).astype(np.float32)
    want = np.asarray(JState.compensate({"w": jnp.asarray(g)}, {"w": jnp.asarray(e)})["w"])
    got = CompressionState.compensate({"w": torch.from_numpy(g)}, {"w": torch.from_numpy(e)})
    np.testing.assert_array_equal(got["w"].numpy(), want)
    z = CompressionState.init({"w": torch.zeros((2, 3), dtype=torch.bfloat16)}, n=4)["w"]
    assert z.shape == (4, 2, 3) and z.dtype == torch.float32 and not z.any()


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("op,algo", [("allreduce", "ring_allreduce"),
                                     ("allreduce", "fused_rsb"),
                                     ("allreduce", "reduce_then_bcast"),
                                     ("bcast", "pipelined_chain"),
                                     ("reduce", "binomial_reduce")])
def test_compressed_compiled_equals_unrolled(op, algo, fmt):
    """The wire seam of both executors gives the same bits, and the
    compressed path leaves the caller's buffer as it was."""
    n = 4
    rng = np.random.RandomState(5)
    x = torch.from_numpy((rng.randn(n, 37, 29) * 2).astype(np.float32))
    before = x.clone()
    plan = comm.plan_collective(op, x[0].numel() * 4, n, algo=algo,
                                num_chunks=None if algo in ("ring_allreduce", "binomial_reduce")
                                else 3, wire_format=fmt)
    outs = [comm.apply_plan(plan, x, compiled=c) for c in (False, True)]
    assert torch.equal(x, before)
    assert torch.equal(outs[0].view(torch.int32), outs[1].view(torch.int32))
    # the reference's own bounds for per-hop compression error
    # (tests/test_compress.py): int8 2%, fp8 9% of the largest magnitude
    exact = {"allreduce": x.sum(0), "bcast": x[0], "reduce": x.sum(0)}[op]
    tol = {"int8": 0.02, "fp8": 0.09}[fmt]
    assert float((outs[0][0] - exact).abs().max()) <= tol * float(exact.abs().max())


def test_executor_wire_needs_the_f32_domain():
    sched = ts.build("chain", 2, 0)
    buf = torch.zeros((2, sched.num_chunks, 8), dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        executors.execute_collective(sched, buf, wire=CompressedWire(comm.WireFormat.INT8))


def test_one_shot_algos_refuse_a_compressed_wire():
    x = torch.zeros((2, 16))
    with pytest.raises(ValueError):
        comm.pallreduce(x, algo="xla_psum", wire_format="int8")
    with pytest.raises(ValueError):
        comm.pallreduce(x, combiner="max", wire_format="int8")
    with pytest.raises(ValueError):
        comm.pallreduce(x, combiner="prod")


def test_tree_variants_sync_every_bucket():
    """pbcast_tree / pallreduce_tree over mixed-dtype buckets (integer
    data: every sum is exact); the compressed tree allreduce keeps the
    caller's tree and each leaf's dtype."""
    from repro_torch.core.bcast import pbcast_tree, preduce_sum

    n = 4
    rng = np.random.RandomState(6)

    def tree():
        return {"a": torch.from_numpy(rng.randint(-8, 8, size=(n, 300)).astype(np.float32)),
                "b": torch.from_numpy(rng.randint(-8, 8, size=(n, 5, 7)).astype(np.float32))
                .to(torch.bfloat16),
                "c": [torch.from_numpy(rng.randint(-8, 8, size=(n, 2000)).astype(np.float32))]}

    t = tree()
    want = {k: v.clone() for k, v in t.items() if k != "c"}
    out = pbcast_tree(t, root=2, bucket_bytes=1024)
    for k in want:
        assert torch.equal(out[k], want[k][2:3].expand_as(want[k]))
    t = tree()
    sums = {"a": t["a"].sum(0), "b": t["b"].float().sum(0), "c": t["c"][0].sum(0)}
    out = comm.pallreduce_tree(t, ("data",), bucket_bytes=1024)
    assert torch.equal(out["a"], sums["a"].expand_as(out["a"]))
    assert torch.equal(out["b"].float(), sums["b"].expand_as(out["b"]))
    assert torch.equal(out["c"][0], sums["c"].expand_as(out["c"][0]))
    assert torch.equal(preduce_sum(t["a"].clone(), root=1)[1], t["a"].sum(0))
    t = tree()
    before = [t["a"].clone(), t["c"][0].clone()]
    sums = {"c": t["c"][0].sum(0)}
    out = comm.pallreduce_tree(t, ("data",), bucket_bytes=1024, wire_format="int8")
    assert out["b"].dtype == torch.bfloat16
    assert torch.equal(t["a"], before[0]) and torch.equal(t["c"][0], before[1])
    assert float((out["c"][0][0] - sums["c"]).abs().max()) <= 0.02 * float(sums["c"].abs().max())
