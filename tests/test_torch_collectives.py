"""The port's collective entry points against the reference's, on the CPU.

``pallgather``, ``preduce_scatter``, ``preduce`` and ``pallreduce`` of the
port (rank-stacked values) against the reference's functions under
``shard_map`` on 4 host devices, from the same numpy inputs: for each op
``algo='auto'`` and one named algo, each through the in-kernel executor
(``inkernel=True``) and the compiled one (``compiled=True``), bit for bit
(both packages replay the same schedule, so every sum is taken in the same
order); and the one-shot max/min combiners, exactly.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import comm

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

N = 4
# (op, keyword arguments, per-rank shape, dtype)
SUM_CASES = (
    ("pallgather", {"algo": "auto"}, (5, 7), "float32"),
    ("pallgather", {"algo": "ring_allgather"}, (5, 7), "float32"),
    ("preduce_scatter", {"algo": "auto"}, (13, 7), "float32"),
    ("preduce_scatter", {"algo": "ring_reduce_scatter"}, (13, 7), "float32"),
    ("preduce", {"algo": "auto", "root": 1}, (13, 7), "float32"),
    ("preduce", {"algo": "pipelined_reduce_chain", "root": 2, "num_chunks": 5}, (13, 7),
     "float32"),
    ("pallreduce", {"algo": "auto"}, (13, 7), "float32"),
    ("pallreduce", {"algo": "fused_rsb", "num_chunks": 5}, (13, 7), "bfloat16"),
)
EXECUTORS = ({"inkernel": True}, {"compiled": True})
ONE_SHOT_CASES = (
    ("pallreduce", {"combiner": "max"}, (9, 5), "float32"),
    ("pallreduce", {"combiner": "min", "algo": "xla_psum"}, (9, 5), "bfloat16"),
    ("preduce", {"combiner": "max"}, (9, 5), "float32"),
    ("preduce", {"combiner": "min"}, (9, 5), "float32"),
    ("preduce_scatter", {"combiner": "max"}, (9, 5), "float32"),
    ("preduce_scatter", {"combiner": "min"}, (9, 5), "bfloat16"),
)
CASES = ([(op, {**kw, **ex}, shape, dt) for op, kw, shape, dt in SUM_CASES for ex in EXECUTORS]
         + list(ONE_SHOT_CASES))


def _key(i: int) -> str:
    return f"case{i}"


def _data(i: int, shape, dtype: str) -> np.ndarray:
    """The rank-stacked f32 input of case ``i`` (cast to ``dtype`` by each
    package)."""
    return np.random.RandomState(i).randn(N, *shape).astype(np.float32)


_REFERENCE = r'''
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.comm import api

mesh = jax.make_mesh((N,), ("data",))
out = {}
for i, (op, kw, shape, dtype) in enumerate(CASES):
    x = jnp.asarray(np.random.RandomState(i).randn(N, *shape).astype(np.float32)).astype(dtype)
    fn = getattr(api, op)
    f = jax.jit(jax.shard_map(lambda b: fn(b[0], "data", **kw)[None], mesh=mesh,
                              in_specs=P("data"), out_specs=P("data"), check_vma=False))
    y = np.asarray(f(x))
    out[f"case{i}"] = y.view(np.uint16) if dtype == "bfloat16" else y
np.savez(PATH, **out)
print("PASS")
'''


@pytest.fixture(scope="module")
def reference(dist, tmp_path_factory):
    """The reference's result of every case, from one 4-device subprocess."""
    path = tmp_path_factory.mktemp("collectives") / "reference.npz"
    code = f"N = {N}\nCASES = {CASES!r}\nPATH = {str(path)!r}\n" + _REFERENCE
    dist(code, devices=N, timeout=300, env={"OMP_NUM_THREADS": "1"})
    return dict(np.load(path))


def _port(op: str, kw: dict, x: np.ndarray, dtype: str) -> np.ndarray:
    t = torch.from_numpy(x.copy()).to(getattr(torch, dtype))
    y = getattr(comm, op)(t, **kw)
    return y.view(torch.int16).numpy().view(np.uint16) if dtype == "bfloat16" else y.numpy()


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"{op}-{'-'.join(f'{k}={v}' for k, v in kw.items())}-{dt}"
                              for op, kw, _s, dt in CASES])
def test_entry_point_matches_reference(reference, i):
    op, kw, shape, dtype = CASES[i]
    got = _port(op, kw, _data(i, shape, dtype), dtype)
    want = reference[_key(i)]
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op,kw,shape,dtype", SUM_CASES)
def test_inkernel_equals_compiled(op, kw, shape, dtype):
    """The device-initiated executor's plain version and the compiled
    executor agree bit for bit on every entry point."""
    x = _data(0, shape, dtype)
    a = _port(op, {**kw, "inkernel": True}, x, dtype)
    b = _port(op, {**kw, "compiled": True}, x, dtype)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("combiner,reduce", [("max", torch.amax), ("min", torch.amin)])
def test_one_shot_combiners_and_pad_tail(combiner, reduce):
    """max/min combine before the pad tail is appended: a size that does
    not divide into the ranks keeps its true extreme, and the pad is 0."""
    x = torch.from_numpy(np.random.RandomState(5).randn(N, 10).astype(np.float32)) - 3
    full = reduce(x, dim=0)
    assert torch.equal(comm.pallreduce(x.clone(), combiner=combiner), full.expand(N, 10))
    assert torch.equal(comm.preduce(x.clone(), combiner=combiner)[0], full)
    shards = comm.preduce_scatter(x.clone(), combiner=combiner)
    assert shards.shape == (N, 3)
    assert torch.equal(shards.reshape(-1)[:10], full)
    assert torch.equal(shards.reshape(-1)[10:], torch.zeros(2))


def test_entry_points_refuse_what_the_reference_refuses():
    x = torch.zeros((N, 8))
    with pytest.raises(ValueError, match="sum"):
        comm.pallreduce(x, combiner="max", wire_format="int8")
    with pytest.raises(ValueError, match="algo"):
        comm.preduce(x, combiner="min", algo="binomial_reduce")
    with pytest.raises(ValueError, match="algo"):
        comm.preduce_scatter(x, combiner="max", algo="ring_reduce_scatter")
    with pytest.raises(ValueError):
        comm.pallreduce(x, combiner="prod")
    with pytest.raises(ValueError, match="compressed"):
        comm.pallgather(x, algo="ring_allgather", wire_format="int8", inkernel=True)
    with pytest.raises(ValueError):
        comm.pallgather(x, algo="xla_allgather", wire_format="int8")


def test_single_rank_shapes():
    """n == 1 keeps each entry point's shape contract."""
    x = torch.arange(6.0).reshape(1, 2, 3)
    assert comm.pallgather(x).shape == (1, 1, 2, 3)
    assert torch.equal(comm.preduce_scatter(x), x.reshape(1, 6))
    assert comm.preduce(x) is x and comm.pallreduce(x) is x
