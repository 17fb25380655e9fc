"""The port's overlap engine and multi-stream link scheduler against the
reference's, on the CPU.

The cost forms (``multi_stream_finish_times`` with its trace records,
``window_finish_times``, ``t_overlapped``, ``t_bucketed_barrier``,
``optimal_overlap_depth``) on seeded inputs; ``plan_streams`` and
``plan_overlap`` across the four depth tiers (decisions, order, depth,
``depth_source``, priority, graph key); ``simulate_streams``,
``simulate_overlap`` and ``dispatch_schedule`` on 1-, 2- and 3-entry
graphs with priorities, links and ``after`` edges; ``StreamGraphError``;
and the replay: a 1-entry ``execute_streams`` against ``execute_overlap``,
``overlap_allreduce_tree`` against ``pallreduce_tree`` (plain versions),
and a 2-entry ``execute_streams`` against the reference's on 4 host
devices. Every comparison is exact: the host-side forms run the same float
arithmetic in the same order, and the replays sum in the same order.
The reference's tuners price on its v5e profile; the port's tuners are
handed the same constants (``Hardware(**asdict(TPU_V5E))``) and keep no
copy of them.
"""
from __future__ import annotations

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from repro.comm import overlap as jov
from repro.comm import streams as jst
from repro.core import cost_model as jcm
from repro.core.tuner import Tuner as JTuner
from repro_torch import comm
from repro_torch.comm import overlap as tov
from repro_torch.comm import streams as tst
from repro_torch.core import cost_model as tcm
from repro_torch.core.tuner import Tuner as TTuner
from repro_torch.launch.mesh import make_mesh

# one intra-op thread: the suite runs in several worker processes at once, and
# the spinning OpenMP threads of each would contend for the same cores
torch.set_num_threads(1)

V5E = tcm.Hardware(**dataclasses.asdict(jcm.TPU_V5E))
MIX = [65536, 65536, 4096, 4096, 512, 512, 64, 64]
N = 4


# --------------------------------------------------------------------------
# the cost forms
# --------------------------------------------------------------------------


def _rand_demand(rng, *, floats: bool, priority=0, link="ici", after=()):
    K = rng.randint(1, 6)
    num = (lambda hi: float(rng.rand() * hi)) if floats else (lambda hi: rng.randint(0, hi))
    return {
        "avail": sorted(num(20) for _ in range(K)),
        "stage": [num(3) for _ in range(K)],
        "comm": ([[num(2) + 0.5 for _ in range(rng.randint(1, 5))] for _ in range(K)]
                 if floats else [[1] * rng.randint(1, 5) for _ in range(K)]),
        "depth": rng.randint(1, 4),
        "priority": priority,
        "link": link,
        "after": after,
    }


@pytest.mark.parametrize("floats", [False, True])
@pytest.mark.parametrize("bound", [None, 1, 3])
def test_multi_stream_finish_times_and_trace_equal_reference(floats, bound):
    rng = np.random.RandomState(17 + (bound or 0) + 100 * floats)
    for _ in range(40):
        S = rng.randint(1, 5)
        demands = []
        for s in range(S):
            after = (int(rng.randint(0, s)),) if s and rng.rand() < 0.3 else ()
            demands.append(_rand_demand(rng, floats=floats, priority=int(rng.randint(0, 3)),
                                        link=["ici", "host"][rng.randint(0, 2)], after=after))
        jt, tt = [], []
        want = jcm.multi_stream_finish_times(demands, starvation_bound=bound, trace=jt)
        got = tcm.multi_stream_finish_times(demands, starvation_bound=bound, trace=tt)
        assert got == want
        assert tt == jt


def test_single_stream_forms_equal_reference():
    rng = np.random.RandomState(3)
    for _ in range(60):
        K = rng.randint(1, 9)
        comm_s = [float(rng.rand() * 1e-3) for _ in range(K)]
        stage = [float(rng.rand() * 5e-4) for _ in range(K)]
        avail = sorted(float(rng.rand() * 2e-3) for _ in range(K))
        compute = float(rng.rand() * 4e-3)
        depth = int(rng.randint(1, 5))
        assert (tcm.window_finish_times(avail, stage, comm_s, depth)
                == jcm.window_finish_times(avail, stage, comm_s, depth))
        for st in (None, stage):
            assert (tcm.t_overlapped(comm_s, compute, depth=depth, stage_s=st)
                    == jcm.t_overlapped(comm_s, compute, depth=depth, stage_s=st))
            assert (tcm.t_bucketed_barrier(comm_s, compute, st)
                    == jcm.t_bucketed_barrier(comm_s, compute, st))
            for md in (1, 3, 8):
                assert (tcm.optimal_overlap_depth(comm_s, compute, stage_s=st, max_depth=md)
                        == jcm.optimal_overlap_depth(comm_s, compute, stage_s=st,
                                                     max_depth=md))
    assert tcm.t_overlapped([], 0.5) == jcm.t_overlapped([], 0.5) == 0.5


@pytest.mark.parametrize("demands,match", [
    ([{"avail": [0], "stage": [0], "comm": [[]], "depth": 1}], "quantum"),
    ([{"avail": [0], "stage": [0], "comm": [1], "depth": 1, "after": (3,)}], "range"),
    ([{"avail": [0], "stage": [0], "comm": [1], "depth": 1, "after": (1,)},
      {"avail": [0], "stage": [0], "comm": [1], "depth": 1, "after": (0,)}], "deadlock"),
])
def test_multi_stream_finish_times_refuses_as_reference(demands, match):
    for fn in (jcm.multi_stream_finish_times, tcm.multi_stream_finish_times):
        with pytest.raises(ValueError, match=match):
            fn(demands)


def test_timed_rounds_equal_reference():
    from repro.core import schedules as js
    from repro.core import simulator as jsim
    from repro_torch.core import schedules as ts
    from repro_torch.core import simulator as tsim

    for algo, kw in (("pipelined_chain", {"num_chunks": 7}), ("binomial", {}),
                     ("bidir_chain", {"num_chunks": 5})):
        for n in (2, 4, 8):
            ref, port = js.build(algo, n, 0, **kw), ts.build(algo, n, 0, **kw)
            for chunk in (1, 4096, 3 << 20):
                assert (tsim.timed_rounds(port, chunk, V5E.ts, V5E.link_bw)
                        == jsim.timed_rounds(ref, chunk, V5E.ts, V5E.link_bw))


# --------------------------------------------------------------------------
# planning
# --------------------------------------------------------------------------


def _jtree(leaves, dtype=np.float32):
    return {f"l{i}": jax.ShapeDtypeStruct((e,), dtype) for i, e in enumerate(leaves)}


def _ttree(leaves, dtype=torch.float32):
    return {f"l{i}": torch.empty((e,), dtype=dtype, device="meta")
            for i, e in enumerate(leaves)}


def _specs(pkg, tree, count: int):
    """1, 2 or 3 stream specs: grad sync (allreduce, reversed, priority 1,
    compute-gated), weight prefetch (bcast, after grad sync) and a
    checkpoint drain on its own link (priority 2, reduce to rank 1)."""
    S = pkg.StreamSpec
    out = [S(name="grad_sync", tree=tree(MIX), axes=(("data", N),), op="allreduce",
             priority=1, compute_s=1e-3, bucket_bytes=64 << 10, reverse=True)]
    if count >= 2:
        out.append(S(name="weight_prefetch", tree=tree(MIX), axes=(("data", N),), op="bcast",
                     priority=0, after=("grad_sync",), bucket_bytes=64 << 10))
    if count >= 3:
        out.append(S(name="ckpt", tree=tree([4096] * 5), axes=(("data", N),), op="reduce",
                     root=1, priority=2, link="host", overlap_depth=2, bucket_bytes=8 << 10))
    return out


def _graphs(count: int, starvation_bound: int = 4):
    ref = jst.plan_streams(_specs(jst, _jtree, count), tuner=JTuner(jcm.TPU_V5E),
                           starvation_bound=starvation_bound)
    port = tst.plan_streams(_specs(tst, _ttree, count), tuner=TTuner(V5E),
                            starvation_bound=starvation_bound)
    return ref, port


def _dec(d) -> dict:
    return {k: "nan" if isinstance(v, float) and math.isnan(v) else v
            for k, v in dataclasses.asdict(d).items()}


def _entry_key(e) -> dict:
    return {
        "name": e.name, "op": e.op, "axes": e.axes, "order": e.order,
        "depth": e.overlap_depth, "source": e.depth_source, "priority": e.priority,
        "after": e.after, "link": e.link, "compute_s": e.compute_s,
        "buckets": e.spec.bucket_bytes(),
        "plans": {ax: [(p.op, p.M, p.n, p.root, p.inter_pod, _dec(p.decision),
                        p.schedule.name if p.schedule is not None else None,
                        p.wire_bytes(), p.timed_rounds_s(V5E)) for p in ps]
                  for ax, ps in e.plans.items()},
        "comm_s": e.bucket_comm_s(), "stage_s": e.bucket_stage_s(V5E),
        "rounds": e.bucket_rounds(), "times": e.bucket_times_s(V5E),
    }


@pytest.mark.parametrize("count", [1, 2, 3])
def test_plan_streams_equals_reference(count):
    ref, port = _graphs(count)
    assert port.key == ref.key
    assert port.fingerprint() == ref.fingerprint()
    assert port.names == ref.names and port.topo_order() == ref.topo_order()
    assert port.fairness_bound() == ref.fairness_bound()
    assert port.wire_bytes() == ref.wire_bytes()
    for pe, je in zip(port.entries, ref.entries):
        assert _entry_key(pe) == _entry_key(je)
    # a hand-built graph's content fingerprint
    rebuilt = (tst.StreamGraph(port.entries, starvation_bound=2),
               jst.StreamGraph(ref.entries, starvation_bound=2))
    assert rebuilt[0].fingerprint() == rebuilt[1].fingerprint()


def _tier(pkg, tuner, tier: str):
    """A tuner set up so that plan_overlap resolves its depth from ``tier``,
    and the overlap_depth to ask for."""
    if tier == "stream":
        tuner.record_stream("overlap", overlap_depth=3, priority=7)
    elif tier == "empirical":
        probe = pkg.plan_overlap(_jtree(MIX) if pkg is jov else _ttree(MIX), [("data", N)],
                                 tuner=type(tuner)(tuner.hw), bucket_bytes=64 << 10)
        for M in {max(b, 1) for b in probe.spec.bucket_bytes()}:
            tuner.record_overlap(M, N, 2, op="allreduce")
    return 5 if tier == "manual" else None


@pytest.mark.parametrize("compute_s", [0.0, 2e-3])
@pytest.mark.parametrize("tier", ["manual", "stream", "empirical", "analytic"])
def test_plan_overlap_depth_tiers_equal_reference(tier, compute_s):
    jt, tt = JTuner(jcm.TPU_V5E), TTuner(V5E)
    depth = _tier(jov, jt, tier)
    assert _tier(tov, tt, tier) == depth
    kw = dict(bucket_bytes=64 << 10, compute_s=compute_s, overlap_depth=depth)
    ref = jov.plan_overlap(_jtree(MIX), [("data", N)], tuner=jt, **kw)
    port = tov.plan_overlap(_ttree(MIX), [("data", N)], tuner=tt, **kw)
    assert port.depth_source == ref.depth_source == tier
    assert _entry_key(port.as_entry()) == _entry_key(ref.as_entry())
    assert port.as_graph().fingerprint() == ref.as_graph().fingerprint()
    for fn in ("barrier_s", "overlapped_s", "efficiency"):
        assert getattr(port, fn)(V5E) == getattr(ref, fn)(jcm.TPU_V5E), fn
    if tier == "stream":  # the tuner's stream entry also gives the priority
        sp = tst.plan_streams([tst.StreamSpec(name="overlap", tree=_ttree(MIX),
                                              axes=(("data", N),), bucket_bytes=64 << 10)],
                              tuner=tt)
        assert sp.entries[0].priority == 7


# --------------------------------------------------------------------------
# the contention simulator
# --------------------------------------------------------------------------


@pytest.mark.parametrize("bound", [1, 4])
@pytest.mark.parametrize("count", [1, 2, 3])
def test_simulate_and_dispatch_equal_reference(count, bound):
    ref, port = _graphs(count, starvation_bound=bound)
    want = jst.simulate_streams(ref, jcm.TPU_V5E)
    got = tst.simulate_streams(port, V5E)
    assert got == want
    assert tst.dispatch_schedule(port, V5E) == jst.dispatch_schedule(ref, jcm.TPU_V5E)
    assert got["idle_while_ready_rounds"] == 0
    assert got["max_skips"] <= port.fairness_bound()


@pytest.mark.parametrize("leaves", [MIX, [4096] * 8, [262144, 262144]])
def test_simulate_overlap_equals_reference(leaves):
    kw = dict(bucket_bytes=64 << 10, compute_s=1e-3)
    ref = jov.plan_overlap(_jtree(leaves), [("data", N)], tuner=JTuner(jcm.TPU_V5E), **kw)
    port = tov.plan_overlap(_ttree(leaves), [("data", N)], tuner=TTuner(V5E), **kw)
    assert tov.simulate_overlap(port, V5E) == jov.simulate_overlap(ref, jcm.TPU_V5E)
    assert (tst.simulate_streams(port.as_graph(), V5E)
            == jst.simulate_streams(ref.as_graph(), jcm.TPU_V5E))


# --------------------------------------------------------------------------
# graph validation
# --------------------------------------------------------------------------


def _bad_graph(case: str):
    g = _graphs(2)[1]
    e0, e1 = g.entries
    return {
        "duplicate": lambda: tst.StreamGraph((e0, dataclasses.replace(e1, name=e0.name))),
        "after itself": lambda: tst.StreamGraph((dataclasses.replace(e0, after=(e0.name,)),
                                                 dataclasses.replace(e1, after=()))),
        "unknown": lambda: tst.StreamGraph((e0, dataclasses.replace(e1, after=("nope",)))),
        "cycle": lambda: tst.StreamGraph((dataclasses.replace(e0, after=(e1.name,)), e1)),
        "starvation_bound": lambda: tst.StreamGraph((e0,), starvation_bound=0),
    }[case]


@pytest.mark.parametrize("case", ["duplicate", "after itself", "unknown", "cycle",
                                  "starvation_bound"])
def test_stream_graph_refuses_malformed_graphs(case):
    with pytest.raises(tst.StreamGraphError, match=case):
        _bad_graph(case)()
    assert issubclass(tst.StreamGraphError, ValueError)


# --------------------------------------------------------------------------
# the replay (plain versions on the CPU)
# --------------------------------------------------------------------------


def _stacked(leaves, seed: int, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    return {f"l{i}": torch.from_numpy(rng.randn(N, e).astype(np.float32)).to(dtype)
            for i, e in enumerate(leaves)}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _same(a: dict, b: dict) -> bool:
    return all(torch.equal(_bits(a[k]), _bits(b[k])) for k in a)


@pytest.mark.parametrize("stage", [False, True])
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_one_entry_streams_bit_identical_to_execute_overlap(depth, stage):
    leaves = [65536, 4096, 4096, 512, 64]
    oplan = tov.plan_overlap(_ttree(leaves), [("data", N)], bucket_bytes=64 << 10,
                             overlap_depth=depth)
    graph = oplan.as_graph()
    a = tov.execute_overlap(oplan, _stacked(leaves, 0), stage=stage, compiled=True)
    b = tst.execute_streams(graph, {"overlap": _stacked(leaves, 0)}, stage=stage,
                            compiled=True)["overlap"]
    c = tst.execute_stream_entry(graph.entries[0], _stacked(leaves, 0), stage=stage,
                                 fused=False)
    assert _same(a, b) and _same(a, c)
    want = _stacked(leaves, 0)
    for k in a:
        np.testing.assert_allclose(a[k][0].numpy(), want[k].sum(0).numpy(), rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_overlap_allreduce_tree_bit_identical_to_pallreduce_tree(dtype):
    leaves = [3000, 17, 4096, 333, 1]
    for compiled in (None, True):
        for algo in ("auto", "ring_allreduce"):
            kw = dict(algo=algo, bucket_bytes=8 << 10, compiled=compiled)
            want = comm.pallreduce_tree(_stacked(leaves, 1, dtype), ("data",), **kw)
            tree = _stacked(leaves, 1, dtype)
            got = comm.overlap_allreduce_tree(tree, ("data",), overlap_depth=2, **kw)
            assert _same(got, want), (compiled, algo)
            assert all(got[k] is tree[k] for k in tree)  # updated in place
    assert comm.overlap_allreduce_tree({}, ("data",)) == {}
    # over two axes: the same levels, bit for bit
    pods = make_mesh((2, 2), axis_names=("pod", "data"), device="cpu")
    kw = dict(bucket_bytes=8 << 10, inter_pod_axes=("pod",), mesh=pods)
    want = comm.pallreduce_tree(_stacked(leaves, 1, dtype), ("data", "pod"), **kw)
    got = comm.overlap_allreduce_tree(_stacked(leaves, 1, dtype), ("data", "pod"),
                                      overlap_depth=2, **kw)
    assert _same(got, want)
    with pytest.raises(ValueError, match="needs the mesh"):
        comm.overlap_allreduce_tree(_stacked(leaves, 1), ("pod", "data"))


def test_two_entry_streams_equal_each_entry_alone():
    """The interleave changes only the order of the buckets' dispatches:
    each tree is bit-equal to its entry replayed alone. Without the
    ``after`` edge the prefetch's buckets interleave with the sync's."""
    specs = [dataclasses.replace(s, after=()) for s in _specs(tst, _ttree, 2)]
    graph = tst.plan_streams(specs, tuner=TTuner())
    trees = {"grad_sync": _stacked(MIX, 2), "weight_prefetch": _stacked(MIX, 3)}
    got = tst.execute_streams(graph, trees, stage=True, compiled=True)
    assert got["grad_sync"] is trees["grad_sync"]
    for name, seed in (("grad_sync", 2), ("weight_prefetch", 3)):
        alone = tst.execute_stream_entry(graph.entry(name), _stacked(MIX, seed),
                                         compiled=True)
        assert _same(got[name], alone), name
    sched = tst.dispatch_schedule(graph)
    first = {n: min(i for i, (m, _) in enumerate(sched) if m == n) for n in graph.names}
    last = {n: max(i for i, (m, _) in enumerate(sched) if m == n) for n in graph.names}
    assert first["weight_prefetch"] < last["grad_sync"]  # they interleave


# --------------------------------------------------------------------------
# a 2-entry graph against the reference's on 4 host devices
# --------------------------------------------------------------------------

_REFERENCE = r'''
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.comm import streams
from repro.core.tuner import Tuner

raw = np.load(INPUTS)
trees = {}
for key in raw.files:
    name, leaf = key.split("/")
    trees.setdefault(name, {})[leaf] = jnp.asarray(raw[key])
abstract = {name: {k: jax.ShapeDtypeStruct(v.shape[1:], v.dtype) for k, v in t.items()}
            for name, t in trees.items()}
graph = streams.plan_streams([
    streams.StreamSpec(name="grad_sync", tree=abstract["grad_sync"], axes=(("data", N),),
                       op="allreduce", priority=1, compute_s=1e-3, bucket_bytes=64 << 10,
                       reverse=True),
    streams.StreamSpec(name="weight_prefetch", tree=abstract["weight_prefetch"],
                       axes=(("data", N),), op="bcast", priority=0, after=("grad_sync",),
                       bucket_bytes=64 << 10),
], tuner=Tuner())
mesh = jax.make_mesh((N,), ("data",))
specs = {name: {k: P("data") for k in t} for name, t in trees.items()}

def body(ts):
    sub = {name: {k: v[0] for k, v in t.items()} for name, t in ts.items()}
    out = streams.execute_streams(graph, sub, stage=True, compiled=True)
    return {name: {k: v[None] for k, v in t.items()} for name, t in out.items()}

f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(specs,), out_specs=specs,
                          check_vma=False))
out = f(trees)
order = np.array([[graph.names.index(n), k] for n, k in streams.dispatch_schedule(graph)])
np.savez(PATH, order=order,
         **{f"{name}/{k}": np.asarray(v) for name, t in out.items() for k, v in t.items()})
print("PASS")
'''


def test_two_entry_streams_match_reference_on_4_devices(dist, tmp_path):
    """``execute_streams`` on the 2-entry graph (staged, compiled), the
    port on rank-stacked trees against the reference under ``shard_map``:
    the same dispatch order and every tree bit for bit (both replay the
    same schedules, summing in the same order)."""
    trees = {"grad_sync": _stacked(MIX, 4), "weight_prefetch": _stacked(MIX, 5)}
    inputs, path = tmp_path / "inputs.npz", tmp_path / "reference.npz"
    np.savez(inputs, **{f"{n}/{k}": v.numpy() for n, t in trees.items() for k, v in t.items()})
    code = f"N = {N}\nINPUTS = {str(inputs)!r}\nPATH = {str(path)!r}\n" + _REFERENCE
    dist(code, devices=N, timeout=300, env={"OMP_NUM_THREADS": "1"})
    want = dict(np.load(path))
    graph = tst.plan_streams(_specs(tst, _ttree, 2), tuner=TTuner(V5E))
    assert tst.dispatch_schedule(graph, V5E) == [(graph.names[i], k)
                                                 for i, k in want["order"].tolist()]
    got = tst.execute_streams(graph, trees, hw=V5E, stage=True, compiled=True)
    for name, t in got.items():
        for k, v in t.items():
            np.testing.assert_array_equal(v.numpy(), want[f"{name}/{k}"], err_msg=name + k)
