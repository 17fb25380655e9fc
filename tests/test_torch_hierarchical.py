"""Hierarchical ('pod', 'data') meshes: the port against the reference, on
the CPU.

The reference runs its two-level designs under ``shard_map`` on 8 host
devices, in one module-scoped subprocess: ``hierarchical_bcast`` on the
meshes of its own test (``tests/test_comm_multidev.py``: (8,), (1, 8),
(8, 1), (2, 4) and (2, 2, 2) with a model axis), and ``pallreduce_tree``
and ``overlap_allreduce_tree`` over ('data', 'pod') on (2, 4) with the pod
level priced inter-pod, at ``bucket_bytes=2048``. The port's results from
the same numpy inputs, rank-stacked over the port's mesh of the same shape,
are held against them bit for bit through the compiled and the in-kernel
executors (each level replays the same plan on every group of ranks along
its axis, so every sum is taken in the reference's order); the overlap
engine at depths None, 1, 2 and 4, staged and not; a two-entry stream
replay; ``pallreduce_tree`` over the int8 and fp8 wires (compiled and
unrolled: the in-kernel executor refuses a compressed wire); and the
compressed trainer's two-level sync on a (2, 2) mesh, its synced row 0 and
new residuals against the reference's ``CompressionState`` and
``pallreduce_tree`` on the same gradients and residuals.

Then the host side (``dist.topology`` of every port mesh read by both
packages, ``plan_distribution``'s per-level plans on a (2, 4) mesh), the
trainer on a (2, 2) mesh in every sync mode and the degraded step against
the reference's full-batch steps, ``Engine.generate`` on a (2, 2) mesh
after a distribution whose replicas are bit-equal, a ('pod', 'data',
'model') mesh (the explicit sync modes refuse its model axis,
``grad_allreduce`` trains and ``Engine`` serves there), and a multi-level
collective without its ``mesh=`` refused.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import RunConfig as JRunConfig
from repro.core import cost_model as jcm
from repro.core.tuner import Tuner as JTuner
from repro.data.pipeline import batches as jbatches
from repro.dist import topology as jtopo
from repro.launch.mesh import make_local_mesh as jmake_local_mesh
from repro.models import Model as JModel
from repro.serve import engine as jengine
from repro.train import checkpoint as jckpt
from repro.train.train_step import make_train_step as jmake_train_step
from repro.train.trainer import Trainer as JTrainer
from repro_torch import comm
from repro_torch.comm import faults as tf
from repro_torch.core import bcast as tbcast
from repro_torch.core import cost_model as tcm
from repro_torch.core.algorithms import ring_allreduce
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.core.tuner import Tuner as TTuner
from repro_torch.configs import RunConfig, get_config
from repro_torch.data.pipeline import batches, make_source
from repro_torch.dist import topology as ttopo
from repro_torch.launch import mesh as tmesh
from repro_torch.models import Model
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import optimizers as topt
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.serve import Engine, plan_distribution
from repro_torch.train import train_step as tts
from repro_torch.train.trainer import Trainer

# one intra-op thread: the suite runs in several worker processes at once, and
# the spinning OpenMP threads of each would contend for the same cores
torch.set_num_threads(1)

W = 257  # the reference test's row width
BCAST_MESHES = (((8,), ("data",)), ((1, 8), ("pod", "data")), ((8, 1), ("pod", "data")),
                ((2, 4), ("pod", "data")), ((2, 2, 2), ("pod", "data", "model")))
LEAVES = {"w": 517, "b": 1201, "s": 33}  # the reference test's tree, (2, 4) mesh
DTYPES = ("float32", "bfloat16")
AXES, INTER = ("data", "pod"), ("pod",)
EXECUTORS = ({"compiled": True}, {"inkernel": True})
WIRES = ("int8", "fp8")


def _bcast_input(i: int) -> np.ndarray:
    shape = BCAST_MESHES[i][0]
    return np.random.RandomState(i).randn(math.prod(shape), W).astype(np.float32)


def _tree_input(dtype: str) -> dict:
    rng = np.random.RandomState(DTYPES.index(dtype))
    return {k: rng.randn(8, n).astype(np.float32) for k, n in LEAVES.items()}


_REFERENCE = r'''
import os
# A compressed hop whose row is one 256-element scale block runs the
# reference's dequantize kernel over a grid of one step; XLA:CPU then fuses
# its product into the add that consumes it as a fused multiply-add, one
# rounding where the kernel stores the product first (two). Capping the ISA
# below FMA keeps the kernel's own arithmetic; no other result here changes.
os.environ["XLA_FLAGS"] += " --xla_cpu_max_isa=AVX"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.comm import overlap_allreduce_tree, pallreduce_tree
from repro.core import hierarchical_bcast

def mk(shape, names):
    return jax.make_mesh(shape, names, axis_types=(jax.sharding.AxisType.Auto,) * len(names))

out = {}
for i, (shape, names) in enumerate(BCAST_MESHES):
    mesh = mk(shape, names)
    x = np.random.RandomState(i).randn(int(np.prod(shape)), W).astype(np.float32)
    zeros, spec = (0,) * len(names), P(*names)
    body = lambda b, mesh=mesh, zeros=zeros, k=len(names): hierarchical_bcast(
        b[zeros], mesh=mesh, root=0)[(None,) * k]
    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(spec,), out_specs=spec,
                              check_vma=False))
    out[f"bcast{i}"] = np.asarray(f(jnp.asarray(x.reshape(shape + (W,))))).reshape(-1, W)

mesh = mk((2, 4), ("pod", "data"))
specs = {k: P("pod", "data") for k in LEAVES}

def run(fn, tree):
    g = lambda t: {k: v[None, None] for k, v in fn({k: v[0, 0] for k, v in t.items()}).items()}
    f = jax.jit(jax.shard_map(g, mesh=mesh, in_specs=(specs,), out_specs=specs,
                              check_vma=False))
    return {k: np.asarray(v).reshape(8, -1) for k, v in f(tree).items()}

kw = dict(bucket_bytes=2048, inter_pod_axes=INTER)
for d, dtype in enumerate(DTYPES):
    rng = np.random.RandomState(d)
    tree = {k: jnp.asarray(rng.randn(8, n).astype(np.float32)).astype(dtype).reshape(2, 4, n)
            for k, n in LEAVES.items()}
    for name, fn in (("barrier", lambda t: pallreduce_tree(t, list(AXES), **kw)),
                     ("overlap", lambda t: overlap_allreduce_tree(t, list(AXES), **kw))):
        for k, v in run(fn, tree).items():
            out[f"{name}_{dtype}_{k}"] = v.view(np.uint16) if dtype == "bfloat16" else v
    if dtype == "float32":
        for fmt in WIRES:
            fn = lambda t, fmt=fmt: pallreduce_tree(t, list(AXES), wire_format=fmt, **kw)
            for k, v in run(fn, tree).items():
                out[f"wire_{fmt}_{k}"] = v

# the compressed trainer's sync on (2, 2): compensate, the two-level int8
# allreduce, the mean, and the new residual, as its local_step runs them
from repro.comm.api import hierarchical_allreduce_axes
from repro.comm.compress import CompressionState
mesh4 = jax.make_mesh((2, 2), ("pod", "data"), axis_types=(jax.sharding.AxisType.Auto,) * 2,
                      devices=jax.devices()[:4])
raw = np.load(STEP_INPUTS)
count = len(raw.files) // 2
g = [raw[f"g{i}"].reshape((2, 2) + raw[f"g{i}"].shape[1:]) for i in range(count)]
e = [raw[f"e{i}"].reshape((2, 2) + raw[f"e{i}"].shape[1:]) for i in range(count)]
axes = [a for a in hierarchical_allreduce_axes(mesh4) if dict(mesh4.shape)[a] > 1]

def step_sync(g, e):
    comp = CompressionState.compensate([x[0, 0] for x in g], [x[0, 0] for x in e])
    synced = pallreduce_tree(comp, axes, algo=STEP["algo"], bucket_bytes=STEP["bucket_bytes"],
                             inter_pod_axes=INTER, compiled=STEP["compiled"], wire_format="int8")
    new_ef = CompressionState.update(comp, "int8")
    return [(x / 4)[None, None] for x in synced], [x[None, None] for x in new_ef]

spec = [P("pod", "data")] * count
synced, new_ef = jax.jit(jax.shard_map(step_sync, mesh=mesh4, in_specs=(spec, spec),
                                       out_specs=(spec, spec), check_vma=False))(g, e)
for i in range(count):
    out[f"step_grad{i}"] = np.asarray(synced[i])[0, 0]
    out[f"step_ef{i}"] = np.asarray(new_ef[i]).reshape((4,) + new_ef[i].shape[2:])
np.savez(PATH, **out)
print("PASS")
'''


@pytest.fixture(scope="module")
def reference(dist, tmp_path_factory):
    """The reference's results, from one 8-device subprocess."""
    folder = tmp_path_factory.mktemp("hierarchical")
    path, inputs = folder / "reference.npz", folder / "step_inputs.npz"
    g, e = _compressed_step_inputs()
    np.savez(inputs, **{f"g{i}": x.numpy() for i, x in enumerate(g)},
             **{f"e{i}": x for i, x in enumerate(e)})
    run = _compressed_run()
    step = {"algo": run.allreduce_algo, "bucket_bytes": run.bcast_bucket_bytes,
            "compiled": run.compiled_collectives}
    code = (f"BCAST_MESHES = {BCAST_MESHES!r}\nW = {W}\nLEAVES = {LEAVES!r}\n"
            f"DTYPES = {DTYPES!r}\nAXES = {AXES!r}\nINTER = {INTER!r}\nWIRES = {WIRES!r}\n"
            f"STEP = {step!r}\nSTEP_INPUTS = {str(inputs)!r}\n"
            f"PATH = {str(path)!r}\n" + _REFERENCE)
    dist(code, devices=8, timeout=300, env={"OMP_NUM_THREADS": "1"})
    return dict(np.load(path))


def _mesh(shape, names=None):
    return tmesh.make_mesh(shape, axis_names=names, device="cpu")


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 \
        else t.numpy()


# --------------------------------------------------------------------------
# the collectives against the reference under shard_map
# --------------------------------------------------------------------------


@pytest.mark.parametrize("ex", EXECUTORS, ids=["compiled", "inkernel"])
@pytest.mark.parametrize("i", range(len(BCAST_MESHES)),
                         ids=["x".join(map(str, s)) for s, _ in BCAST_MESHES])
def test_hierarchical_bcast_matches_reference(reference, i, ex):
    shape, names = BCAST_MESHES[i]
    x = torch.from_numpy(_bcast_input(i))
    got = tbcast.hierarchical_bcast(x.clone(), mesh=_mesh(shape, names), root=0, **ex)
    np.testing.assert_array_equal(got.numpy(), reference[f"bcast{i}"])
    # every rank holds the root's row of its model coordinate
    want = x.view(*shape, W)[(0,) * min(len(shape), 2)]
    assert torch.equal(got.view(-1, *want.shape), want.expand(got.numel() // want.numel(),
                                                              *want.shape))


def _port_tree(dtype: str) -> dict:
    return {k: torch.from_numpy(v).to(getattr(torch, dtype)) for k, v in _tree_input(dtype).items()}


@pytest.mark.parametrize("ex", EXECUTORS, ids=["compiled", "inkernel"])
@pytest.mark.parametrize("stage", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_pallreduce_tree_matches_reference(reference, dtype, stage, ex):
    got = comm.pallreduce_tree(_port_tree(dtype), AXES, bucket_bytes=2048, inter_pod_axes=INTER,
                               stage=stage, mesh=_mesh((2, 4)), **ex)
    for k in LEAVES:
        np.testing.assert_array_equal(_bits(got[k]), reference[f"barrier_{dtype}_{k}"], err_msg=k)


@pytest.mark.parametrize("ex", EXECUTORS, ids=["compiled", "inkernel"])
@pytest.mark.parametrize("stage", [False, True])
@pytest.mark.parametrize("depth", [None, 1, 2, 4])
def test_overlap_allreduce_tree_matches_reference(reference, depth, stage, ex):
    """Each depth and staging against the reference's barrier tree (which
    the reference's own test holds equal to its overlap tree at each), and
    the reference's overlap tree at its tuned depth."""
    for dtype in DTYPES:
        tree = _port_tree(dtype)
        got = comm.overlap_allreduce_tree(tree, AXES, bucket_bytes=2048, inter_pod_axes=INTER,
                                          overlap_depth=depth, stage=stage, mesh=_mesh((2, 4)),
                                          **ex)
        assert all(got[k] is tree[k] for k in tree)  # updated in place
        for k in LEAVES:
            np.testing.assert_array_equal(_bits(got[k]), reference[f"barrier_{dtype}_{k}"])
            np.testing.assert_array_equal(_bits(got[k]), reference[f"overlap_{dtype}_{k}"])


@pytest.mark.parametrize("compiled", [True, False], ids=["compiled", "unrolled"])
@pytest.mark.parametrize("fmt", WIRES)
def test_compressed_pallreduce_tree_matches_reference(reference, fmt, compiled):
    """Every hop of both levels quantized: the compiled and the unrolled
    replay bit-equal to the reference's. The in-kernel executor has no
    quantize seam and refuses the wire."""
    mesh = _mesh((2, 4))
    kw = dict(bucket_bytes=2048, inter_pod_axes=INTER, wire_format=fmt, mesh=mesh)
    tree = _port_tree("float32")
    before = {k: v.clone() for k, v in tree.items()}
    got = comm.pallreduce_tree(tree, AXES, compiled=compiled, **kw)
    for k in LEAVES:
        assert torch.equal(tree[k], before[k])  # a compressed wire copies
        np.testing.assert_array_equal(got[k].numpy().view(np.uint32),
                                      reference[f"wire_{fmt}_{k}"].view(np.uint32), err_msg=k)
    with pytest.raises(comm.api.ExecutorRefusal):
        comm.pallreduce_tree(tree, AXES, inkernel=True, **kw)


@pytest.mark.parametrize("ex", EXECUTORS, ids=["compiled", "inkernel"])
def test_two_entry_streams_on_pods_match_reference(reference, ex):
    """``execute_streams`` on a (2, 4) mesh, two entries interleaved: the
    gradient allreduce over ('data', 'pod') bit-equal to the reference's
    ``pallreduce_tree`` of the same tree, and the weight broadcast over
    ('pod', 'data') equal to ``hierarchical_bcast`` of each leaf: rank 0's
    rows on every rank."""
    mesh = _mesh((2, 4))
    for dtype in DTYPES:
        one = {k: torch.empty((n,), dtype=getattr(torch, dtype), device="meta")
               for k, n in LEAVES.items()}
        graph = comm.plan_streams([
            comm.StreamSpec(name="grad_sync", tree=one, axes=(("data", 4), ("pod", 2)),
                            op="allreduce", priority=1, compute_s=1e-3, bucket_bytes=2048,
                            inter_pod_axes=INTER, reverse=True),
            comm.StreamSpec(name="weight_prefetch", tree=one, axes=(("pod", 2), ("data", 4)),
                            op="bcast", bucket_bytes=2048, inter_pod_axes=INTER),
        ])
        sched = comm.dispatch_schedule(graph)
        first = {n: min(i for i, (m, _) in enumerate(sched) if m == n) for n in graph.names}
        last = {n: max(i for i, (m, _) in enumerate(sched) if m == n) for n in graph.names}
        assert first["weight_prefetch"] < last["grad_sync"]  # they interleave
        weights = {k: v.flip(0).contiguous() for k, v in _port_tree(dtype).items()}
        want = {k: tbcast.hierarchical_bcast(v.clone(), mesh=mesh, **ex)
                for k, v in weights.items()}
        trees = {"grad_sync": _port_tree(dtype), "weight_prefetch": weights}
        got = comm.execute_streams(graph, trees, mesh=mesh, **ex)
        for k in LEAVES:
            np.testing.assert_array_equal(_bits(got["grad_sync"][k]),
                                          reference[f"barrier_{dtype}_{k}"], err_msg=k)
            assert torch.equal(got["weight_prefetch"][k], want[k])
            assert torch.equal(want[k], weights[k][:1].expand(8, -1))


# --------------------------------------------------------------------------
# the level replay and the other entry points
# --------------------------------------------------------------------------


def test_level_replay_groups_strided_and_contiguous():
    """The pod level's groups are rows d, d + D, ...; the data level's are
    runs of D rows; a model axis's coordinates are groups of their own."""
    mesh = _mesh((2, 3, 2))
    x = torch.randn(12, 5)
    seen = []

    def fn(frame):
        seen.append(frame.clone())
        return frame.mul_(2)

    out = comm.level_replay(x.clone(), "pod", fn, mesh=mesh)
    g = x.view(2, 3, 2, 5)
    assert [s.shape for s in seen] == [(2, 5)] * 6
    assert all(torch.equal(s, g[:, d, m]) for s, (d, m) in
               zip(seen, [(d, m) for d in range(3) for m in range(2)]))
    assert torch.equal(out, 2 * x)
    seen.clear()
    comm.level_replay(x.clone(), "data", fn, mesh=mesh)
    assert [s.shape for s in seen] == [(3, 5)] * 4
    assert torch.equal(seen[1], g[0, :, 1])
    seen.clear()
    assert comm.level_replay(x, "pod", fn, mesh=_mesh((1, 12))) is x and not seen


def test_level_replay_leaves_x_when_the_collective_copies():
    """A compressed wire returns new buffers: the level result is a new
    tensor and ``x`` (the error-feedback residual in training) is left as
    it was, on the strided level and the contiguous one."""
    mesh = _mesh((2, 2))
    x = torch.randn(4, 300)
    before = x.clone()
    fn = functools.partial(comm.pallreduce, wire_format="int8")
    for ax in ("pod", "data"):
        out = comm.level_replay(x, ax, fn, mesh=mesh)
        assert torch.equal(x, before) and out.data_ptr() != x.data_ptr()
        rows = [[0, 2], [1, 3]] if ax == "pod" else [[0, 1], [2, 3]]
        for r in rows:
            assert torch.equal(out[r], fn(x[r].clone()))


def test_bcast_stacked_over_pod_and_ring_per_axis():
    mesh = _mesh((2, 4))
    xs = torch.randn(2, 9)
    assert torch.equal(tbcast.bcast_stacked(xs.clone(), mesh, "pod", root=1),
                       xs[1:].expand(2, 9))
    x = torch.randn(8, 40)
    got = x.clone()
    for ax in ttopo.dp_axes(mesh):  # param_bcast's ring: one a data axis, pod first
        got = comm.level_replay(got, ax, ring_allreduce, mesh=mesh)
    want = x.clone()
    for rows in ([0, 4], [1, 5], [2, 6], [3, 7]):
        want[rows] = ring_allreduce(want[rows].clone())
    for rows in ([0, 1, 2, 3], [4, 5, 6, 7]):
        want[rows] = ring_allreduce(want[rows].clone())
    assert torch.equal(got, want)


def test_multi_level_without_the_mesh_raises():
    tree = {"w": torch.zeros((4, 8))}
    for call in (lambda: comm.pallreduce_tree(tree, ("data", "pod")),
                 lambda: comm.overlap_allreduce_tree(tree, ("data", "pod")),
                 lambda: tbcast.hierarchical_bcast(tree["w"], ("pod", "data")),
                 lambda: comm.pbcast_tree(tree, mesh=_mesh((2, 2)))):
        with pytest.raises(ValueError, match=r"needs the (mesh|axis)"):
            call()
    with pytest.raises(ValueError, match="4 rank rows, the mesh 8"):
        comm.pallreduce_tree(tree, ("data", "pod"), mesh=_mesh((2, 4)))
    with pytest.raises(ValueError, match="no axis 'pod'"):
        comm.pallreduce_tree(tree, ("pod",), mesh=_mesh(4))


# --------------------------------------------------------------------------
# host side: meshes, topology, distribution plans
# --------------------------------------------------------------------------


MESHES = {
    "data": lambda: _mesh(4),
    "pod_data": lambda: _mesh((2, 4), ("pod", "data")),
    "pod_data_model": lambda: _mesh((2, 2, 2)),
    "local": lambda: tmesh.make_local_mesh(2, n=8, device="cpu"),
    "production": lambda: tmesh.make_production_mesh(device="cpu"),
    "multi_pod": lambda: tmesh.make_production_mesh(multi_pod=True, device="cpu"),
}


@pytest.mark.parametrize("name", MESHES)
def test_topology_of_port_meshes_equals_reference(name):
    mesh = MESHES[name]()
    for fn in ("axis_sizes", "dp_axes", "dp_size", "tp_axis", "tp_size", "inter_pod_axes",
               "bcast_axes"):
        assert getattr(ttopo, fn)(mesh) == getattr(jtopo, fn)(mesh), fn
    from repro.comm.api import hierarchical_allreduce_axes as jaxes

    assert comm.hierarchical_allreduce_axes(mesh) == jaxes(mesh)
    assert mesh.size == math.prod(mesh.devices.shape)


def test_mesh_shapes_and_names():
    assert _mesh((2, 4)).axis_names == ("pod", "data")
    assert MESHES["production"]().devices.shape == (16, 16)
    assert MESHES["production"]().axis_names == ("data", "model")
    assert MESHES["multi_pod"]().devices.shape == (2, 16, 16)
    assert MESHES["multi_pod"]().axis_names == ("pod", "data", "model")
    assert MESHES["local"]().devices.shape == (4, 2)
    for bad in (lambda: _mesh((2, 0)), lambda: _mesh((2, 2), ("data", "data")),
                lambda: _mesh((2, 2), ("pod", "rows")), lambda: _mesh((2, 2, 2, 2)),
                lambda: tmesh.make_local_mesh(3, n=8, device="cpu")):
        with pytest.raises(ValueError):
            bad()


def test_plan_distribution_per_level_plans_equal_reference():
    """minitron-8b at full width: each bucket at each level, the pod level
    first, planned by both packages on the same v5e constants."""
    shapes = JModel(jget_config("minitron-8b")).param_shapes()
    mesh = _mesh((2, 4))
    jspec, jplans = jengine.plan_distribution(shapes, mesh, tuner=JTuner(jcm.TPU_V5E))
    stacked = jax.tree.map(lambda s: torch.empty((8,) + tuple(s.shape),
                                                 dtype=getattr(torch, str(s.dtype)),
                                                 device="meta"), shapes)
    spec, plans = plan_distribution(
        stacked, mesh, tuner=TTuner(tcm.Hardware(**dataclasses.asdict(jcm.TPU_V5E))))
    assert list(plans) == list(jplans) == ["pod", "data"]
    assert spec.bucket_sizes == jspec.bucket_sizes
    algos = set()
    for ax in plans:
        for p, q in zip(plans[ax], jplans[ax], strict=True):
            assert (p.algo, p.num_chunks, p.n, p.M, p.predicted_s, p.wire_bytes()) == \
                (q.algo, q.num_chunks, q.n, q.M, q.predicted_s, q.wire_bytes()), ax
            algos.add((ax, p.algo))
    # the inter-pod constants choose another algorithm than the intra-pod ones
    assert {a for ax, a in algos if ax == "pod"} != {a for ax, a in algos if ax == "data"}


# --------------------------------------------------------------------------
# the trainer and the engine on a (2, 2) mesh
# --------------------------------------------------------------------------

ARCH = "minitron-8b-smoke"
BATCH, SEQ, STEPS = 8, 16, 3
RUN = dict(total_steps=STEPS, warmup_steps=0, learning_rate=1e-3, seed=7)


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _compressed_run() -> RunConfig:
    return RunConfig(sync_mode="compressed_allreduce", wire_format="int8", **RUN)


def _compressed_step_inputs() -> tuple:
    """Rank by rank on a (2, 2) mesh, the port's gradient leaves of the first
    batch at its seeded parameters (what the compressed step computes), and
    a seeded nonzero residual of about the gradients' size, so that the
    compensation shows."""
    cfg, run = _f32(get_config(ARCH)), _compressed_run()
    model = Model(cfg)
    batch = next(batches(make_source(cfg, seed=run.seed), cfg, batch=BATCH, seq=SEQ))
    stacked, write = tts._stacked_writer(4)
    tts._per_rank(tts._grad_fn(model, run), model.init(run.seed, device="cpu"), batch, 4,
                  write)
    rng = np.random.RandomState(5)
    return stacked, [rng.randn(*g.shape).astype(np.float32) * float(g.abs().mean())
                     for g in stacked]


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference's single-device trainer: its initial state saved as
    its own npz checkpoint at step 0, then 3 full-batch steps from it."""
    ckpt = str(tmp_path_factory.mktemp("ref_ckpt"))
    trainer = JTrainer(_f32(jget_config(ARCH)), JRunConfig(**RUN), mesh=jmake_local_mesh(1),
                       ckpt_dir=ckpt)
    params, opt = trainer.init_state()
    jckpt.save_checkpoint(ckpt, 0, params)
    jckpt.save_checkpoint(os.path.join(ckpt, "opt"), 0, opt)
    _, _, hist = trainer.train(batch=BATCH, seq=SEQ, steps=STEPS, log_every=1)
    return ckpt, [h["loss"] for h in hist]


def _trainer(ckpt, mesh=None, health=None, **kw) -> Trainer:
    return Trainer(_f32(get_config(ARCH)), RunConfig(**RUN, **kw),
                   mesh=mesh or _mesh((2, 2)), ckpt_dir=ckpt, device="cpu",
                   check_rows=kw.get("sync_mode") != "grad_allreduce", health=health)


MODES = {
    "grad_allreduce": {"sync_mode": "grad_allreduce"},
    "param_bcast": {"sync_mode": "param_bcast"},
    "param_bcast_ring": {"sync_mode": "param_bcast", "bcast_algo": "ring_allreduce"},
    "tuned_allreduce": {"sync_mode": "tuned_allreduce"},
    "overlap_allreduce": {"sync_mode": "overlap_allreduce"},
    "overlap_prefetch": {"sync_mode": "overlap_allreduce", "prefetch_stream": True},
}


@pytest.mark.parametrize("mode", MODES)
def test_trainer_on_pods_tracks_reference_full_batch_steps(reference_run, mode):
    ckpt, ref_losses = reference_run
    _, _, hist = _trainer(ckpt, **MODES[mode]).train(batch=BATCH, seq=SEQ, steps=STEPS,
                                                      log_every=1)
    losses = [h["loss"] for h in hist]
    assert max(abs(a - b) for a, b in zip(losses, ref_losses)) <= 1e-4, (losses, ref_losses)
    if mode != "grad_allreduce":
        assert all(h["grad_rows_differ"] == 0 for h in hist)


def test_trainer_on_pods_compressed_and_one_axis_bits(reference_run):
    """compressed_allreduce keeps its residual in the optimizer state, which
    the reference's checkpoint lacks, so it starts from the port's own
    seeded state beside tuned_allreduce (which tracks the reference within
    1e-4 above): the bf16 wire bit-identical to it, with rows bit-equal,
    the int8 wire within 5e-3 (as on one axis). And the two-level tuned
    sync of a (1, 4) mesh, whose pod level is one rank, bit-equal to the
    one-axis run's."""
    ckpt, _ = reference_run
    runs = {fmt: _trainer(None, sync_mode="compressed_allreduce", wire_format=fmt).train(
        batch=BATCH, seq=SEQ, steps=STEPS, log_every=1) for fmt in ("bf16", "int8")}
    tuned = _trainer(None, sync_mode="tuned_allreduce").train(
        batch=BATCH, seq=SEQ, steps=STEPS, log_every=1)
    (pb, ob, hb), (_, oi, hi) = runs["bf16"], runs["int8"]
    for a, b in zip(tree_leaves(tuned[0]), tree_leaves(pb)):
        assert torch.equal(a, b)
    assert [h["loss"] for h in tuned[2]] == [h["loss"] for h in hb]
    assert all(h["grad_rows_differ"] == 0 for h in hb)
    assert all(not e.any() for e in tree_leaves(ob["ef"]))
    assert max(abs(a["loss"] - b["loss"]) for a, b in zip(tuned[2], hi)) <= 5e-3
    assert all(e.shape[0] == 4 for e in tree_leaves(oi["ef"]))
    runs = [_trainer(ckpt, mesh=m, sync_mode="tuned_allreduce").train(
        batch=BATCH, seq=SEQ, steps=2, log_every=1)[0] for m in (_mesh(4), _mesh((1, 4)))]
    for a, b in zip(tree_leaves(runs[0]), tree_leaves(runs[1])):
        assert torch.equal(a, b)


def test_compressed_step_on_pods_matches_reference_sync(reference, monkeypatch):
    """One int8 ``compressed_allreduce`` step on a (2, 2) mesh from a
    nonzero residual: the synced mean the optimizer gets (row 0, before the
    clip) and every rank's new residual, bit for bit against the reference's
    compensate, two-level ``pallreduce_tree`` and ``CompressionState.update``
    under ``shard_map`` on the same gradients and residuals, both planned on
    the reference's default (v5e) constants. A second level
    that read the residual in place of the first level's result, a
    residual not re-injected or a wrong mean all change these bits."""
    cfg, run = _f32(get_config(ARCH)), _compressed_run()
    model = Model(cfg)
    _, residual = _compressed_step_inputs()
    opt = tts.with_error_feedback(topt.get_optimizer(run.optimizer, run.weight_decay), 4)
    step = tts.make_compressed_allreduce_train_step(
        model, run, opt, warmup_cosine(run.learning_rate, run.warmup_steps, run.total_steps),
        _mesh((2, 2)), tuner=TTuner(tcm.Hardware(**dataclasses.asdict(jcm.TPU_V5E))))
    params = model.init(run.seed, device="cpu")
    state = opt.init(params)
    for e, want in zip(tree_leaves(state["ef"]), residual, strict=True):
        e.copy_(torch.from_numpy(want))
    seen, clip = [], tts.clip_by_global_norm

    def spy(grads, max_norm):
        seen.append([g.clone() for g in tree_leaves(grads)])
        return clip(grads, max_norm)

    monkeypatch.setattr(tts, "clip_by_global_norm", spy)
    step(params, state, next(batches(make_source(cfg, seed=run.seed), cfg, batch=BATCH,
                                     seq=SEQ)))
    (grads,) = seen
    for i, (g, e) in enumerate(zip(grads, tree_leaves(state["ef"]), strict=True)):
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      reference[f"step_grad{i}"].view(np.uint32), err_msg=i)
        np.testing.assert_array_equal(e.numpy().view(np.uint32),
                                      reference[f"step_ef{i}"].view(np.uint32), err_msg=i)


def test_degraded_trainer_on_pods_tracks_reference_survivor_steps(reference_run):
    """Rank 1 of the (2, 2) mesh dead: the survivors' mean against the
    reference's single-device steps on the batch without rank 1's rows."""
    ckpt, _ = reference_run
    jtr = JTrainer(_f32(jget_config(ARCH)), JRunConfig(**RUN), mesh=jmake_local_mesh(1))
    params = jckpt.restore_checkpoint(ckpt, 0, jtr.init_state()[0])
    opt = jckpt.restore_checkpoint(os.path.join(ckpt, "opt"), 0, jtr.init_state()[1])
    step = jax.jit(jmake_train_step(jtr.model, jtr.run, jtr.optimizer, jtr.lr_fn))
    it = jbatches(jtr.source, _f32(jget_config(ARCH)), batch=BATCH, seq=SEQ)
    keep = np.array([r for r in range(BATCH) if r // (BATCH // 4) != 1])
    ref = []
    for _ in range(STEPS):
        params, opt, out = step(params, opt, {k: v[keep] for k, v in next(it).items()})
        ref.append(float(out["loss"]))
    tr = _trainer(ckpt, health=tf.MeshHealth(n=4, dead_ranks=(1,)), sync_mode="tuned_allreduce")
    _, _, hist = tr.train(batch=BATCH, seq=SEQ, steps=STEPS, log_every=1)
    losses = [h["loss"] for h in hist]
    assert max(abs(a - b) for a, b in zip(losses, ref)) <= 1e-4, (losses, ref)


def test_engine_on_pods_matches_reference():
    jcfg, tcfg = _f32(jget_config(ARCH)), _f32(get_config(ARCH))
    jparams = JModel(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    tokens = np.random.RandomState(0).randint(0, jcfg.vocab_size - 1, size=(4, 12))
    want = jengine.Engine(jcfg, jparams).generate({"tokens": jnp.asarray(tokens, jnp.int32)},
                                                  steps=6)
    engine = Engine(tcfg, tree_map(torch.clone, tparams), mesh=_mesh((2, 2)), distribute=True,
                    double_buffer=True, device="cpu")
    for leaf, root in zip(tree_leaves(engine.params), tree_leaves(tparams)):
        for r in range(4):
            assert torch.equal(leaf[r], root)
    got = engine.generate({"tokens": tokens}, steps=6)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.logprobs, want.logprobs, atol=1e-4, rtol=1e-4)


def test_model_axis_is_refused_naming_serving_remainder():
    """On a ('pod', 'data', 'model') mesh the explicit sync modes refuse the
    model axis with the reference's pure data-parallel reason, while
    ``grad_allreduce`` trains there in the blocked FSDP + TP layout and the
    engine serves on it tensor-parallel, every weight cut to its rank's
    block."""
    cfg = _f32(get_config(ARCH))
    mesh = _mesh((2, 2, 2))
    with pytest.raises(ValueError, match="pure data-parallel"):
        Trainer(cfg, RunConfig(sync_mode="param_bcast", **RUN), mesh=mesh, device="cpu")
    tr = Trainer(cfg, RunConfig(**RUN), mesh=mesh, device="cpu")
    blocked, _ = tr.init_state()
    assert blocked["decoder"]["blocks"][0]["attn"]["wq"].shape[0] == 8
    assert np.isfinite(tr.train(batch=BATCH, seq=SEQ, steps=1, log_every=1)[2][0]["loss"])
    params = Model(cfg).init(0, device="cpu")
    engine = Engine(cfg, params, mesh=mesh, distribute=True, device="cpu")
    wq = params["decoder"]["blocks"][0]["attn"]["wq"]
    assert engine.params["decoder"]["blocks"][0]["attn"]["wq"].shape == \
        (8,) + wq.shape[:2] + (cfg.num_heads // 2,) + wq.shape[3:]
    res = engine.generate({"tokens": np.arange(48).reshape(4, 12) % cfg.vocab_size}, steps=2)
    assert res.tokens.shape == (4, 2) and np.isfinite(res.logprobs).all()
    # a model axis of one rank is a data-parallel mesh
    tr = Trainer(cfg, RunConfig(**RUN), mesh=tmesh.make_local_mesh(1, n=4, device="cpu"),
                 device="cpu")
    assert tr.train(batch=BATCH, seq=SEQ, steps=1, log_every=1)[2][0]["loss"] > 0
