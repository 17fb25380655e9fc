"""The port's training slice against the reference, on the CPU.

Optimizers, schedules, data, the f32 smoke model's loss and gradients, the
trainer on 4 emulated ranks against the reference's single-device
full-batch steps (the same initial state, handed across as the reference's
own npz checkpoint), the compressed sync modes, and the compressed
allreduce against the reference's on 4 host devices."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data.pipeline import SyntheticZipf as JZipf
from repro.models import Model as JModel
from repro.optim import optimizers as jopt
from repro.optim.schedules import constant as jconstant
from repro.optim.schedules import warmup_cosine as jwarmup_cosine
from repro_torch.configs import RunConfig, get_config
from repro_torch.core.tree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.data.pipeline import MemmapTokens, SyntheticZipf, batches
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import Model
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import optimizers as topt
from repro_torch.optim.schedules import constant, warmup_cosine
from repro_torch.train import checkpoint as tckpt
from repro_torch.train.trainer import Trainer

from _torch_train_reference import (  # noqa: F401 (the fixture)
    BATCH,
    RUN,
    SEQ,
    STEPS,
    TOL,
    assert_restores,
    f32,
    port_trainer,
    reference,
    track,
)

# one intra-op thread: the suite runs in several worker processes at once, and
# the spinning OpenMP threads of each would contend for the same cores
torch.set_num_threads(1)

ARCH = "minitron-8b-smoke"


def _np(tree):
    return [np.asarray(a) for a in jax.tree.leaves(tree)]


# --------------------------------------------------------------------------
# optimizers, schedules, data
# --------------------------------------------------------------------------


def _opt_inputs():
    rng = np.random.RandomState(0)
    params = {"w": rng.randn(6, 5).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    grads = {k: (rng.randn(*v.shape) * 3).astype(np.float32) for k, v in params.items()}
    return params, grads


@pytest.mark.parametrize("name", ["adamw", "sgdm", "lion"])
def test_optimizer_update_matches_reference(name):
    params, grads = _opt_inputs()
    jo, to = jopt.get_optimizer(name, 0.1), topt.get_optimizer(name, 0.1)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jo.init(jp)
    tp = params_from_jax(params)
    ts = to.init(tp)
    for _ in range(2):  # the second update reads the moments of the first
        jg, jn = jopt.clip_by_global_norm({k: jnp.asarray(v) for k, v in grads.items()}, 1.0)
        tg, tn = topt.clip_by_global_norm(params_from_jax(grads), 1.0)
        assert abs(float(jn) - float(tn)) <= 1e-6 * float(jn)
        jp, js = jo.update(jg, js, jp, 1e-2)
        tp, ts = to.update(tg, ts, tp, torch.tensor(1e-2))
    for a, b in zip(_np(jp), tree_leaves(tp)):
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-6)
    for a, b in zip(_np(js["m"]), tree_leaves(ts["m"])):
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 2


def test_clip_by_global_norm_matches_reference():
    _, grads = _opt_inputs()
    jg, jn = jopt.clip_by_global_norm({k: jnp.asarray(v) for k, v in grads.items()}, 1.0)
    tg, tn = topt.clip_by_global_norm(params_from_jax(grads), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for a, b in zip(_np(jg), tree_leaves(tg)):
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-6)


def test_warmup_cosine_values_equal_reference():
    j, t = jwarmup_cosine(3e-4, 10, 100), warmup_cosine(3e-4, 10, 100)
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        assert np.float32(j(step)) == np.float32(t(step)), step
    assert np.float32(jconstant(1e-3)(7)) == np.float32(constant(1e-3)(7))


def test_synthetic_and_memmap_batches_equal_reference(tmp_path):
    for step in (0, 3):
        np.testing.assert_array_equal(SyntheticZipf(1024, seed=5).batch(step, 4, 9),
                                      JZipf(1024, seed=5).batch(step, 4, 9))
    path = tmp_path / "tokens.npy"
    np.save(path, np.arange(500, dtype=np.int32))
    from repro.data.pipeline import MemmapTokens as JMemmap

    np.testing.assert_array_equal(MemmapTokens(str(path), 2).batch(1, 3, 7),
                                  JMemmap(str(path), 2).batch(1, 3, 7))
    cfg = get_config(ARCH)
    b = next(batches(SyntheticZipf(1024, 5), cfg, batch=4, seq=9, start_step=3))
    toks = JZipf(1024, 5).batch(3, 4, 9)
    np.testing.assert_array_equal(b["tokens"].numpy(), toks[:, :-1])
    np.testing.assert_array_equal(b["labels"].numpy(), toks[:, 1:])


# --------------------------------------------------------------------------
# model: loss and gradients
# --------------------------------------------------------------------------


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_value_and_grad(remat):
    jcfg, tcfg = f32(jget_config(ARCH)), f32(get_config(ARCH))
    jm, tm = JModel(jcfg), Model(tcfg)
    jp = jm.init(jax.random.PRNGKey(1))
    toks = np.random.RandomState(1).randint(0, jcfg.vocab_size, size=(2, SEQ + 1))
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    vg = jax.jit(jax.value_and_grad(lambda p: jm.loss(p, jb, remat=remat), has_aux=True))
    (jl, _), jg = vg(jp)
    leaves, treedef = tree_flatten(params_from_jax(jax.device_get(jp)))
    ps = [p.requires_grad_(True) for p in leaves]
    tb = {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])}
    loss, metrics = tm.loss(tree_unflatten(treedef, ps), tb, remat=remat)
    grads = torch.autograd.grad(loss, ps)
    assert abs(float(loss) - float(jl)) <= 1e-5
    assert float(metrics["aux"]) == 0.0
    ref = _np(jg)
    norm = np.sqrt(sum(float((a.astype(np.float64) ** 2).sum()) for a in ref))
    err = max(float(np.abs(a - g.numpy()).max()) for a, g in zip(ref, grads))
    assert err <= 1e-5 * norm, (err, norm)


# --------------------------------------------------------------------------
# trainer on 4 emulated ranks against the reference's full-batch steps
# --------------------------------------------------------------------------


def test_reference_checkpoint_restores_into_the_port(reference):
    ckpt, ref_params, _ = reference(ARCH)
    assert_restores(ARCH, ckpt, ref_params)


@pytest.mark.parametrize("sync_mode", ["param_bcast", "tuned_allreduce", "overlap_allreduce",
                                       "grad_allreduce", "param_bcast_ring"])
def test_trainer_tracks_reference_full_batch_steps(reference, sync_mode):
    """``param_bcast_ring`` is ``param_bcast`` with
    ``bcast_algo='ring_allreduce'``: the explicit ring of
    ``core.algorithms`` in place of the reduce and the broadcast."""
    ckpt, _, ref_losses = reference(ARCH)
    kw = {"bcast_algo": "ring_allreduce"} if sync_mode == "param_bcast_ring" else {}
    track(ARCH, ckpt, ref_losses, sync_mode.removesuffix("_ring"), **kw)


def test_prefetch_stream_leaves_parameters_bit_equal(reference):
    """``overlap_allreduce`` with ``prefetch_stream``: the updated
    parameters, broadcast as a rank-stacked copy after every update, come
    back bit-equal to the run without the second stream (and to
    ``tuned_allreduce``'s), with both stream decisions recorded in the
    tuner; the losses track the reference's within 1e-4."""
    from repro_torch.core.tuner import Tuner
    from repro_torch.train import train_step

    ckpt, _, ref_losses = reference(ARCH)
    out = {}
    for label, mode, kw in (("tuned", "tuned_allreduce", {}),
                            ("overlap", "overlap_allreduce", {}),
                            ("prefetch", "overlap_allreduce", {"prefetch_stream": True})):
        tr = port_trainer(ARCH, mode, ckpt, compiled_collectives=True, **kw)
        params, opt, hist = tr.train(batch=BATCH, seq=SEQ, steps=STEPS, log_every=1)
        out[label] = (tree_leaves(params), tree_leaves(opt), [h["loss"] for h in hist])
    for label in ("overlap", "prefetch"):
        for a, b in zip(out["tuned"][0] + out["tuned"][1], out[label][0] + out[label][1]):
            assert torch.equal(a, b), label
        assert out[label][2] == out["tuned"][2]
    losses = out["prefetch"][2]
    assert max(abs(a - b) for a, b in zip(losses, ref_losses)) <= TOL, (losses, ref_losses)
    tr = port_trainer(ARCH, "overlap_allreduce", prefetch_stream=True)
    tuner = Tuner()
    train_step.make_overlap_allreduce_train_step(tr.model, tr.run, tr.optimizer, tr.lr_fn,
                                                 tr.mesh, tuner=tuner)
    assert tuner.stream_decision("grad_sync") == {"priority": 1}
    assert tuner.stream_decision("weight_prefetch") == {"priority": 0}


def test_microbatches_track_reference_full_batch_steps(reference):
    """Two microbatches per rank: the f32 mean of their gradients, as the
    reference accumulates them, follows the same trajectory."""
    ckpt, _, ref_losses = reference(ARCH)
    _, _, hist = port_trainer(ARCH, "tuned_allreduce", ckpt, num_microbatches=2).train(
        batch=BATCH, seq=SEQ, steps=STEPS, log_every=1)
    losses = [h["loss"] for h in hist]
    assert max(abs(a - b) for a, b in zip(losses, ref_losses)) <= TOL, (losses, ref_losses)


def test_compressed_allreduce_tracks_tuned_allreduce(tmp_path):
    """bf16 wire: bit-identical parameters to tuned_allreduce and a zero
    residual; int8 wire: the same first loss, every later one within 5e-3
    (measured at most 5.4e-4; the reference's own test allows 0.05), a
    nonzero residual, rows that differ."""
    out = {}
    for mode, fmt in (("tuned_allreduce", "bf16"), ("compressed_allreduce", "bf16"),
                      ("compressed_allreduce", "int8")):
        tr = port_trainer(ARCH, mode, wire_format=fmt, compiled_collectives=True, check_rows=True)
        out[(mode, fmt)] = tr.train(batch=BATCH, seq=SEQ, steps=STEPS, log_every=1)
    pt, _, ht = out[("tuned_allreduce", "bf16")]
    pp, op, hp = out[("compressed_allreduce", "bf16")]
    pi, oi, hi = out[("compressed_allreduce", "int8")]
    for a, b in zip(tree_leaves(pt), tree_leaves(pp)):
        assert torch.equal(a, b)
    assert [h["loss"] for h in ht] == [h["loss"] for h in hp]
    assert all(not e.any() for e in tree_leaves(op["ef"]))
    assert hi[0]["loss"] == ht[0]["loss"]
    assert max(abs(a["loss"] - b["loss"]) for a, b in zip(hi, ht)) <= 5e-3, (hi, ht)
    assert any(e.any() for e in tree_leaves(oi["ef"]))
    assert hi[-1]["grad_rows_differ"] > 0
    # the port's own checkpoint round-trips the residual and the moments
    tckpt.save_checkpoint(str(tmp_path), 3, oi)
    back = tckpt.restore_checkpoint(str(tmp_path), tckpt.latest_step(str(tmp_path)), oi)
    for a, b in zip(tree_leaves(oi), tree_leaves(back)):
        assert torch.equal(a, b)


def _exec_path_table(path: str, exec_path: str) -> None:
    """A tuner table that pins every allreduce bucket of the smoke model to
    its analytic plan, routed to ``exec_path``."""
    from repro_torch.core import bucketing
    from repro_torch.core.tuner import Tuner

    tr = port_trainer(ARCH, "tuned_allreduce")
    params, _ = tr.init_state()
    analytic, table = Tuner(), Tuner()
    for M in bucketing.plan_buckets(params, tr.run.bcast_bucket_bytes).bucket_bytes():
        dec = analytic.select(M, 4, op="allreduce")
        table.record(M, 4, dec.algo, dec.num_chunks, 1e-3, op="allreduce",
                     extras={"exec_path": exec_path})
    table.save(path)


def test_tuner_table_routes_the_trainer_to_the_inkernel_executor(tmp_path, monkeypatch):
    """``RunConfig.tuner_table``: a table pinning 'inkernel' trains to
    parameters bit-identical to the same table pinning 'compiled', and
    every bucket plan of the run goes to the executor its table names."""
    from repro_torch.comm import api as tapi

    calls = {"inkernel": 0, "compiled": 0, "unrolled": 0}
    for name, fn in list(tapi._EXECUTORS.items()):
        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setitem(tapi._EXECUTORS, name, counted)
    out = {}
    for exec_path in ("compiled", "inkernel"):
        table = str(tmp_path / f"{exec_path}.json")
        _exec_path_table(table, exec_path)
        before = dict(calls)
        tr = port_trainer(ARCH, "tuned_allreduce", tuner_table=table)
        out[exec_path] = tr.train(batch=BATCH, seq=SEQ, steps=STEPS, log_every=1)
        used = {k: calls[k] - before[k] for k in calls}
        assert used[exec_path] > 0 and sum(used.values()) == used[exec_path], used
    (pc, _, hc), (pi, _, hi) = out["compiled"], out["inkernel"]
    for a, b in zip(tree_leaves(pc), tree_leaves(pi)):
        assert torch.equal(a, b)
    assert [h["loss"] for h in hc] == [h["loss"] for h in hi]


def test_inkernel_table_trainer_tracks_reference_full_batch_steps(reference, tmp_path):
    """The slice end to end: the reference's initial state, a tuner table
    routing every bucket to the in-kernel executor, 3 steps on 4 emulated
    ranks, losses within 1e-4 of the reference's full-batch steps."""
    ckpt, _, ref_losses = reference(ARCH)
    table = str(tmp_path / "inkernel.json")
    _exec_path_table(table, "inkernel")
    track(ARCH, ckpt, ref_losses, "tuned_allreduce", tuner_table=table)


def test_compressed_step_follows_reference_error_feedback():
    """Step by step on 4 emulated ranks, each rank's new residual is
    ``e' = update(compensate(g_r, e_r))`` with ``g_r`` the reference
    model's gradient of rank ``r``'s shard at the port's parameters and
    ``compensate`` the reference's; ``update`` is the port's plain twin,
    which ``tests/test_torch_quantize.py`` holds bit-equal to the
    reference's (the reference's interpret mode takes seconds per call at
    this size). A residual never re-injected, injected twice or never
    updated misses by O(1); what remains is int8 rounding flips where the
    two frameworks' gradients differ in the last bits (at most 1.7% on
    any rank and step, measured)."""
    from repro.comm.compress import CompressionState as JState
    from repro_torch.comm.compress import CompressionState
    from repro_torch.data.pipeline import make_source
    from repro_torch.train.train_step import (
        make_compressed_allreduce_train_step,
        with_error_feedback,
    )

    n = 4
    jcfg, tcfg = f32(jget_config(ARCH)), f32(get_config(ARCH))
    jm, tm = JModel(jcfg), Model(tcfg)
    run = RunConfig(sync_mode="compressed_allreduce", wire_format="int8",
                    compiled_collectives=True, **RUN)
    opt = with_error_feedback(topt.get_optimizer(run.optimizer, run.weight_decay), n)
    step = make_compressed_allreduce_train_step(
        tm, run, opt, warmup_cosine(run.learning_rate, run.warmup_steps, run.total_steps),
        make_mesh(n, device="cpu"))
    params = tm.init(run.seed, device="cpu")
    state = opt.init(params)
    structure = jax.tree.structure(jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    grad = jax.jit(jax.grad(lambda p, b: jm.loss(p, b)[0]))
    it = batches(make_source(tcfg, seed=run.seed), tcfg, batch=BATCH, seq=SEQ)
    shard = BATCH // n
    for t in range(STEPS):
        batch = next(it)
        jp = jax.tree.unflatten(structure, [jnp.asarray(x.numpy()) for x in tree_leaves(params)])
        before = [e.clone() for e in tree_leaves(state["ef"])]
        want = []
        for r in range(n):
            jb = {k: jnp.asarray(v[r * shard:(r + 1) * shard].numpy()) for k, v in batch.items()}
            comp = JState.compensate(jax.tree.leaves(grad(jp, jb)),
                                     [jnp.asarray(e[r].numpy()) for e in before])
            want.append(CompressionState.update([torch.from_numpy(np.array(c)) for c in comp],
                                                "int8"))
        params, state, _ = step(params, state, batch)
        for r in range(n):
            got = [e[r].double() for e in tree_leaves(state["ef"])]
            miss = sum(float(((a - b.double()) ** 2).sum()) for a, b in zip(got, want[r]))
            size = sum(float((b.double() ** 2).sum()) for b in want[r])
            assert miss ** 0.5 <= 0.1 * size ** 0.5, (t, r, (miss / size) ** 0.5)


def test_trainer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(get_config(ARCH), RunConfig())
    with pytest.raises(ValueError, match="unknown sync_mode"):
        port_trainer(ARCH, "degraded_psum")


# --------------------------------------------------------------------------
# compressed allreduce on 4 host devices, bit for bit
# --------------------------------------------------------------------------


def test_compressed_pallreduce_matches_reference_bit_for_bit(dist):
    dist(
        """
import numpy as np, jax, torch
from jax.sharding import PartitionSpec as P
from repro.comm import pallreduce as jpallreduce
from repro_torch.comm import pallreduce

n = 4
mesh = jax.make_mesh((n,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))
xs = (np.random.RandomState(0).randn(n, 3001) * 2).astype(np.float32)
for algo in ("ring_allreduce", "fused_rsb"):
    for fmt in ("int8", "fp8"):
        f = lambda b: jpallreduce(b[0], "data", algo=algo, wire_format=fmt)[None]
        want = np.asarray(jax.jit(jax.shard_map(
            f, mesh=mesh, in_specs=(P("data"),), out_specs=P("data"),
            check_vma=False))(xs))
        for compiled in (False, True):
            got = pallreduce(torch.from_numpy(xs.copy()), algo=algo, wire_format=fmt,
                             compiled=compiled).numpy()
            assert (got.view(np.uint32) == want.view(np.uint32)).all(), (algo, fmt, compiled)
print("PASS")
""",
        devices=4,
        timeout=300,
        env={"OMP_NUM_THREADS": "1"},  # one intra-op thread, as in this process
    )


def test_compressed_trainer_tracks_reference_trainer(dist):
    """The reference's int8 ``compressed_allreduce`` trainer on 4 host
    devices and the port's on 4 emulated ranks, from the reference's own
    checkpoint. Each reference rank applies the update from its own view
    of the synced gradients, so its ranks' parameters drift apart (in
    about 75% of the elements, by up to 2 lr, after 3 steps), while the
    port applies rank 0's view everywhere: the trajectories agree exactly
    at step 0 and to within rounding-flip noise after it. Measured: step-0
    losses equal, rank 0's residual after step 1 within 0.65% (norm of the
    difference over the norm), losses within 1.8e-3, every rank's final
    residual norm within 0.5%."""
    dist(
        """
import dataclasses, os, tempfile
import numpy as np, jax
from repro.configs import get_config as jget_config
from repro.configs.base import RunConfig as JRunConfig
from repro.launch.mesh import make_local_mesh
from repro.train import checkpoint as jckpt
from repro.train.trainer import Trainer as JTrainer
from repro_torch.configs import RunConfig, get_config
from repro_torch.core.tree import tree_leaves
from repro_torch.launch.mesh import make_mesh
from repro_torch.train import checkpoint as tckpt
from repro_torch.train.trainer import Trainer

ARCH = "minitron-8b-smoke"
RUN = dict(total_steps=3, warmup_steps=0, learning_rate=1e-3, seed=7,
           sync_mode="compressed_allreduce", wire_format="int8", compiled_collectives=True)
d = tempfile.mkdtemp()
ref_dir, port_dir = os.path.join(d, "ref"), os.path.join(d, "port")
mesh = make_local_mesh(1)
jtr = JTrainer(dataclasses.replace(jget_config(ARCH), dtype="float32"), JRunConfig(**RUN),
               mesh=mesh, ckpt_dir=ref_dir)
params, opt = jtr.init_state()
jckpt.save_checkpoint(ref_dir, 0, params)
jckpt.save_checkpoint(os.path.join(ref_dir, "opt"), 0, opt)
_, jopt, jhist = jtr.train(batch=8, seq=16, steps=3, log_every=1, ckpt_every=1)

tr = Trainer(dataclasses.replace(get_config(ARCH), dtype="float32"), RunConfig(**RUN),
             mesh=make_mesh(4, device="cpu"), ckpt_dir=port_dir, device="cpu")
p, o = tr.init_state()
tckpt.save_checkpoint(port_dir, 0, tckpt.restore_checkpoint(ref_dir, 0, p))
tckpt.save_checkpoint(os.path.join(port_dir, "opt"), 0, o)
_, topt, thist = tr.train(batch=8, seq=16, steps=3, log_every=1, ckpt_every=1)

jl, tl = [h["loss"] for h in jhist], [h["loss"] for h in thist]
assert abs(jl[0] - tl[0]) <= 1e-5, (jl, tl)
assert max(abs(a - b) for a, b in zip(jl, tl)) <= 5e-3, (jl, tl)
# rank 0's residual after step 1, as both checkpoints hold it (the
# reference's replicated output reads back rank 0's)
a = np.load(os.path.join(ref_dir, "opt", "ckpt_00000001.npz"))
b = np.load(os.path.join(port_dir, "opt", "ckpt_00000001.npz"))
keys = sorted(k for k in a.files if k.startswith("ef"))
assert keys and keys == sorted(k for k in b.files if k.startswith("ef"))
miss = sum(float(((a[k] - b[k][0]).astype(np.float64) ** 2).sum()) for k in keys)
size = sum(float((a[k].astype(np.float64) ** 2).sum()) for k in keys)
assert miss ** 0.5 <= 0.05 * size ** 0.5, (miss / size) ** 0.5
# every rank's final residual: the reference's on its device, the port's row
ranks = list(mesh.devices[:, 0])
jn = np.zeros(4)
for leaf in jax.tree.leaves(jopt["ef"]):
    for sh in leaf.addressable_shards:
        jn[ranks.index(sh.device)] += float((np.asarray(sh.data, np.float64) ** 2).sum())
tn = sum((e.double() ** 2).flatten(1).sum(1).numpy() for e in tree_leaves(topt["ef"]))
rel = np.abs(np.sqrt(jn) - np.sqrt(tn)) / np.sqrt(jn)
assert (rel <= 0.02).all(), rel
print("PASS")
""",
        devices=4,
        timeout=300,
        env={"OMP_NUM_THREADS": "1"},  # one intra-op thread, as in this process
    )
