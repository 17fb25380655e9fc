"""The port's ``core.algorithms``, ``core.bcast`` and the staged and inter-pod
tree collectives against the reference's, on the CPU.

One 4-device subprocess runs the reference under ``shard_map`` on the same
numpy inputs the port gets rank-stacked: ``ring_allreduce`` (sizes 1, 7,
1000, 4097; f32 and bf16), ``pipelined_chain_fused``, ``schedule_bcast``
for every broadcast algorithm (the compiled route too: 300 small chunks),
``execute_reduce_schedule``, both ``xla_*`` baselines, ``bcast_stacked``,
``hierarchical_bcast`` over one axis, ``pbcast_tree(inter_pod=True)`` and
both trees with ``stage=True`` (the reference's Pallas copy in interpret
mode). Every comparison is bit for bit: both packages run the same
schedules and add in the same order. The reference's tuner prices on its
v5e profile, so the port's tuners get the same constants.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import cost_model as jcm
from repro_torch import comm
from repro_torch.comm import api as tapi
from repro_torch.comm.executors import execute_collective
from repro_torch.core import algorithms as alg
from repro_torch.core import bcast as tbcast
from repro_torch.core import cost_model as tcm
from repro_torch.core.schedules import binomial_reduce, build
from repro_torch.core.tree import tree_leaves
from repro_torch.core.tuner import Tuner
from repro_torch.launch.mesh import make_mesh

# one intra-op thread: the suite runs in several worker processes at once, and
# the spinning OpenMP threads of each would contend for the same cores
torch.set_num_threads(1)

N = 4
V5E = tcm.Hardware(**dataclasses.asdict(jcm.TPU_V5E))
RING = tuple((size, dt) for size in (1, 7, 1000, 4097) for dt in ("float32", "bfloat16"))
# (algo, num_chunks, fused); each buffer (N, num_chunks, 5), or 3 wide at 300
BCAST = (("direct", 6, True), ("chain", 6, True), ("binomial", 6, True),
         ("knomial", 6, True), ("scatter_allgather", N, True), ("pipelined_chain", 6, True),
         ("bidir_chain", 6, True), ("pipelined_chain", 6, False),
         ("pipelined_chain", 300, True), ("bidir_chain", 300, True))
STACKED = ("auto", "pipelined_chain", "xla_psum", "xla_allgather")
TREES = ("inter_pod", "staged_bcast", "staged_allreduce")
TREE_KEYS = ("a", "b", "c0", "c1")


def _inputs() -> dict:
    """Every rank-stacked f32 input, by name (``/bf16`` ones are cast by
    each package)."""
    rng = np.random.RandomState(0)
    out = {f"ring/{size}/{dt}": rng.randn(N, size).astype(np.float32) for size, dt in RING}
    out["chain"] = rng.randn(N, 12, 64).astype(np.float32)
    for K in sorted({K for _a, K, _f in BCAST}):
        out[f"buf{K}"] = rng.randn(N, K, 3 if K > 6 else 5).astype(np.float32)
    out["one/f32"] = rng.randn(N, 33).astype(np.float32)
    out["one/bf16"] = rng.randn(N, 33).astype(np.float32)
    out["red"] = rng.randn(N, 13, 7).astype(np.float32)
    out["tree/a"] = rng.randn(N, 300).astype(np.float32)
    out["tree/b"] = rng.randn(N, 5, 7).astype(np.float32)  # bf16
    out["tree/c0"] = rng.randn(N, 17).astype(np.float32)
    out["tree/c1"] = rng.randn(N, 2, 3).astype(np.float32)
    out["stacked"] = rng.randn(N, 777).astype(np.float32)
    return out


def _bf16(key: str) -> bool:
    return key.endswith("bfloat16") or key in ("one/bf16", "tree/b")


_REFERENCE = r'''
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.comm import api
from repro.core import algorithms as alg
from repro.core import bcast
from repro.core.cost_model import TPU_V5E
from repro.core.schedules import binomial_reduce
from repro.core.tuner import Tuner

mesh = jax.make_mesh((N,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))
tuner = Tuner(TPU_V5E)
BF16 = {"one/bf16", "tree/b"} | {k for k in KEYS if k.endswith("bfloat16")}
xs = {k: jnp.asarray(v).astype(jnp.bfloat16 if k in BF16 else jnp.float32)
      for k, v in np.load(INPUTS).items()}

def tree(x):
    return {"a": x["tree/a"], "b": x["tree/b"], "c": [x["tree/c0"], x["tree/c1"]]}

def flat(name, t):
    return {f"{name}/a": t["a"], f"{name}/b": t["b"], f"{name}/c0": t["c"][0],
            f"{name}/c1": t["c"][1]}

def body(d):
    x = {k: v[0] for k, v in d.items()}
    out = {}
    for size, dt in RING:
        out[f"ring/{size}/{dt}"] = alg.ring_allreduce(x[f"ring/{size}/{dt}"], "data")
    out["chain_fused"] = alg.pipelined_chain_fused(x["chain"], "data", root=3)
    for algo, K, fused in BCAST:
        out[f"bcast/{algo}/{K}/{fused}"] = alg.schedule_bcast(
            x[f"buf{K}"], "data", algo=algo, root=2, fused=fused)
    for dt in ("f32", "bf16"):
        out[f"psum_bcast/{dt}"] = alg.xla_psum_bcast(x[f"one/{dt}"], "data", root=1)
        out[f"allgather_bcast/{dt}"] = alg.xla_allgather_bcast(x[f"one/{dt}"], "data", root=1)
    out["reduce_schedule"] = alg.execute_reduce_schedule(binomial_reduce(N, 1), x["red"],
                                                         "data")
    out["hierarchical"] = bcast.hierarchical_bcast(x["tree/a"], ("data",), root=2, tuner=tuner,
                                                   inter_pod_axes=("data",))
    t = tree(x)
    out.update(flat("inter_pod", api.pbcast_tree(t, "data", root=1, tuner=tuner,
                                                 bucket_bytes=512, inter_pod=True)))
    out.update(flat("staged_bcast", api.pbcast_tree(t, "data", root=1, tuner=tuner,
                                                    bucket_bytes=512, stage=True)))
    out.update(flat("staged_allreduce", api.pallreduce_tree(t, ("data",), tuner=tuner,
                                                            bucket_bytes=512, stage=True)))
    return {k: v[None] for k, v in out.items()}

f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("data"),), out_specs=P("data"),
                          check_vma=False))
out = {k: np.asarray(v) for k, v in f(xs).items()}
for algo in STACKED:
    g = jax.jit(lambda v: bcast.bcast_stacked(v, mesh, "data", root=2, algo=algo, tuner=tuner))
    out[f"stacked/{algo}"] = np.asarray(g(xs["stacked"]))
np.savez(PATH, **{k: v.view(np.uint16) if v.dtype.itemsize == 2 else v for k, v in out.items()})
print("PASS")
'''


@pytest.fixture(scope="module")
def reference(dist, tmp_path_factory):
    """The reference's result of every case, from one 4-device subprocess."""
    d = tmp_path_factory.mktemp("algorithms")
    inputs, path = d / "inputs.npz", d / "reference.npz"
    data = _inputs()
    np.savez(inputs, **data)
    code = (f"N = {N}\nRING = {RING!r}\nBCAST = {BCAST!r}\nSTACKED = {STACKED!r}\n"
            f"KEYS = {sorted(data)!r}\nINPUTS = {str(inputs)!r}\nPATH = {str(path)!r}\n"
            + _REFERENCE)
    dist(code, devices=N, timeout=300, env={"OMP_NUM_THREADS": "1"})
    return dict(np.load(path))


def _t(data: dict, key: str) -> torch.Tensor:
    t = torch.from_numpy(data[key].copy())
    return t.to(torch.bfloat16) if _bf16(key) else t


def _np(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 \
        else t.numpy()


def _tree(data: dict) -> dict:
    return {"a": _t(data, "tree/a"), "b": _t(data, "tree/b"),
            "c": [_t(data, "tree/c0"), _t(data, "tree/c1")]}


def _port() -> dict:
    """The port's result of every case, by the reference's keys."""
    data, out = _inputs(), {}
    for size, dt in RING:
        out[f"ring/{size}/{dt}"] = alg.ring_allreduce(_t(data, f"ring/{size}/{dt}"))
    out["chain_fused"] = alg.pipelined_chain_fused(_t(data, "chain"), root=3)
    for algo, K, fused in BCAST:
        out[f"bcast/{algo}/{K}/{fused}"] = alg.schedule_bcast(_t(data, f"buf{K}"), algo=algo,
                                                               root=2, fused=fused)
    for dt in ("f32", "bf16"):
        out[f"psum_bcast/{dt}"] = alg.xla_psum_bcast(_t(data, f"one/{dt}"), root=1)
        out[f"allgather_bcast/{dt}"] = alg.xla_allgather_bcast(_t(data, f"one/{dt}"), root=1)
    out["reduce_schedule"] = alg.execute_reduce_schedule(binomial_reduce(N, 1), _t(data, "red"))
    out["hierarchical"] = tbcast.hierarchical_bcast(_t(data, "tree/a"), ("data",), root=2,
                                                    tuner=Tuner(V5E), inter_pod_axes=("data",))
    trees = {
        "inter_pod": comm.pbcast_tree(_tree(data), root=1, tuner=Tuner(V5E), bucket_bytes=512,
                                      inter_pod=True),
        "staged_bcast": comm.pbcast_tree(_tree(data), root=1, tuner=Tuner(V5E),
                                         bucket_bytes=512, stage=True),
        "staged_allreduce": comm.pallreduce_tree(_tree(data), ("data",), tuner=Tuner(V5E),
                                                 bucket_bytes=512, stage=True),
    }
    for name, t in trees.items():
        for k, leaf in zip(TREE_KEYS, tree_leaves(t)):
            out[f"{name}/{k}"] = leaf
    mesh = make_mesh(N, device="cpu")
    for algo in STACKED:
        out[f"stacked/{algo}"] = tbcast.bcast_stacked(_t(data, "stacked"), mesh, "data", root=2,
                                                      algo=algo, tuner=Tuner(V5E))
    return {k: _np(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def port():
    return _port()


KEYS = ([f"ring/{size}/{dt}" for size, dt in RING] + ["chain_fused"]
        + [f"bcast/{a}/{K}/{f}" for a, K, f in BCAST]
        + [f"{k}/{dt}" for k in ("psum_bcast", "allgather_bcast") for dt in ("f32", "bf16")]
        + ["reduce_schedule", "hierarchical"]
        + [f"{t}/{k}" for t in TREES for k in TREE_KEYS]
        + [f"stacked/{a}" for a in STACKED])


@pytest.mark.parametrize("key", KEYS)
def test_port_matches_reference_bit_for_bit(reference, port, key):
    got, want = port[key], reference[key]
    assert got.shape == want.shape, (key, got.shape, want.shape)
    assert got.dtype == want.dtype, (key, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=key)


# --------------------------------------------------------------------------
# the port on its own: the generic executor, routes, in-place updates, refusals
# --------------------------------------------------------------------------


@pytest.mark.parametrize("root", range(N))
def test_pipelined_chain_fused_equals_the_generic_replay(root):
    x = torch.from_numpy(np.random.RandomState(root).randn(N, 9, 11).astype(np.float32))
    x[torch.arange(N) != root] = float("nan")
    fused = alg.pipelined_chain_fused(x.clone(), root=root)
    generic = execute_collective(build("pipelined_chain", N, root, num_chunks=9), x.clone())
    assert torch.equal(fused.view(torch.int32), generic.view(torch.int32))
    assert torch.equal(fused, x[root:root + 1].expand_as(x))


def test_ring_allreduce_equals_the_plan_and_works_in_place():
    """The explicit ring adds in the order of the ``ring_allreduce`` plan;
    a contiguous buffer whose size divides over the ranks is updated in
    place (the executors' convention), any other is left as it was."""
    rng = np.random.RandomState(1)
    for shape in ((N, 8, 3), (N, 7)):
        x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(torch.bfloat16)
        before = x.clone()
        got = alg.ring_allreduce(x)
        want = comm.pallreduce(before.clone(), algo="ring_allreduce")
        assert torch.equal(got.view(torch.int16), want.view(torch.int16)), shape
        in_place = shape[1:] == (8, 3)
        assert (got.data_ptr() == x.data_ptr()) == in_place
        assert torch.equal(x.view(torch.int16), (got if in_place else before).view(torch.int16))
    one = torch.ones(1, 5)
    assert alg.ring_allreduce(one) is one


def test_schedule_bcast_routes_and_refusals(monkeypatch):
    """More than 256 rounds of a fused chain take the compiled replay;
    ``scatter_allgather`` needs one chunk a rank; the schedule wrappers
    refuse the other kind."""
    from repro_torch.comm import executors

    calls = []
    real = executors.execute_compiled
    monkeypatch.setattr(executors, "execute_compiled",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    x = torch.randn(N, 300, 2)
    for K, fused, compiled in ((300, True, 1), (300, False, 0), (254, True, 0)):
        calls.clear()
        buf = x[:, :K].clone()
        out = alg.schedule_bcast(buf, algo="pipelined_chain", root=1, fused=fused)
        assert torch.equal(out, buf[1:2].expand_as(buf)) and len(calls) == compiled, (K, fused)
    with pytest.raises(ValueError, match="num_chunks == n"):
        alg.schedule_bcast(torch.zeros(N, 3, 2), algo="scatter_allgather")
    with pytest.raises(ValueError, match="reduce"):
        alg.execute_schedule(binomial_reduce(N, 0), torch.zeros(N, 1, 2))
    with pytest.raises(ValueError, match="not a reduce schedule"):
        alg.execute_reduce_schedule(build("chain", N, 0), torch.zeros(N, 2))
    single = torch.ones(1, 3, 2)
    assert alg.schedule_bcast(single, algo="chain") is single


def test_staged_trees_copy_each_nonempty_bucket_once(monkeypatch):
    """``stage=True`` sends each non-empty bucket through ``chunked_copy``
    once (an empty bucket never), and gives what ``stage=False`` gives."""
    copies = []
    real = tapi.chunked_copy
    monkeypatch.setattr(tapi, "chunked_copy", lambda b, **kw: copies.append(b.numel()) or real(b))
    tree = {"a": torch.randn(N, 300), "b": torch.randn(N, 5, 7).to(torch.bfloat16),
            "e": torch.zeros(N, 0), "c": [torch.randn(N, 17), torch.randn(N, 2, 3)]}
    for fn, kw in ((comm.pbcast_tree, {"root": 2}), (comm.pallreduce_tree, {"axes": ("data",)})):
        copies.clear()
        plain = fn({k: (v.clone() if torch.is_tensor(v) else [t.clone() for t in v])
                    for k, v in tree.items()}, bucket_bytes=512, **kw)
        assert not copies
        staged = fn(tree, bucket_bytes=512, stage=True, stage_chunk=128, **kw)
        assert sorted(copies) == sorted([N * 300, N * 35, N * 23]), copies
        for a, b in zip(tree_leaves(plain), tree_leaves(staged)):
            assert torch.equal(a, b)


def test_hierarchical_bcast_over_one_axis_and_refusals():
    x = torch.randn(N, 6, 5)
    want = x[3:4].expand_as(x).clone()
    mesh = make_mesh(N, device="cpu")
    assert torch.equal(tbcast.hierarchical_bcast(x.clone(), mesh=mesh, root=3), want)
    assert torch.equal(tbcast.hierarchical_bcast(x.clone(), ("data",), root=3, algo="chain"),
                       want)
    assert tbcast.hierarchical_bcast(x, ()) is x
    # two pods of two: every rank ends with the root's row, pod level first
    pods = make_mesh((2, 2), axis_names=("pod", "data"), device="cpu")
    want0 = x[:1].expand_as(x).clone()
    assert torch.equal(tbcast.hierarchical_bcast(x.clone(), ("pod", "data"), mesh=pods), want0)
    assert torch.equal(tbcast.hierarchical_bcast(x.clone(), mesh=pods, root=1),
                       x[3:4].expand_as(x).clone())  # coordinate 1 of each axis: rank 3
    with pytest.raises(ValueError, match="needs the mesh"):
        tbcast.hierarchical_bcast(x, ("pod", "data"))
    with pytest.raises(ValueError, match="needs `axes` or a `mesh`"):
        tbcast.hierarchical_bcast(x)
    with pytest.raises(ValueError, match="no axis 'pod'"):
        tbcast.bcast_stacked(x, mesh, "pod")
    with pytest.raises(ValueError, match="3 slices"):
        tbcast.bcast_stacked(x[:3], mesh, "data")
