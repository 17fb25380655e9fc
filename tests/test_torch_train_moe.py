"""Training a MoE model (mixtral-8x7b-smoke) in the port against the
reference, on the CPU, at 4 emulated data ranks.

The MoE aux loss ``E * sum(me * ce)`` is a product of batch means, so it
depends on the batch it reads. The reference's ``grad_allreduce`` is one
GSPMD step over the global batch: its aux reads the whole batch's ``me``
and ``ce``. Its explicit modes run a ``local_step`` per rank under
``shard_map`` and ``pmean`` the loss: their aux is the mean of the ranks'
values. The port holds each mode to its own reference:

(a) ``grad_allreduce`` against the reference's single-device ``Trainer``
    on the full batch;
(b) ``param_bcast`` (and its ring form), ``tuned_allreduce`` and
    ``overlap_allreduce`` against a 4-shard step composed of the
    reference's own functions: ``jax.value_and_grad`` of its
    ``Model.loss`` on each shard, the mean of the gradients, its
    ``clip_by_global_norm`` and its optimizer;
(c) the degraded step (rank 1 dead) against the same composition over
    the three survivors;
(d) the two semantics differ on this batch by more than 10x the 1e-4
    tolerance, so (a)-(c) can tell them apart (the test's config raises
    ``router_aux_coef`` to 0.1 for that);
(e) the bf16 model, whose router leaves are f32 among bf16 leaves,
    through every sync mode.

Besides: the recompute under remat makes the forward's routing choices,
``ce`` carries no gradient, and moonshot-v1-16b-a3b-smoke (shared
experts) takes a ``tuned_allreduce`` step.
"""
from __future__ import annotations

import dataclasses
import math
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import RunConfig as JRunConfig
from repro.data.pipeline import batches as jbatches
from repro.launch.mesh import make_local_mesh
from repro.optim import optimizers as jopt
from repro.train import checkpoint as jckpt
from repro.train.trainer import Trainer as JTrainer
from repro_torch.comm.faults import MeshHealth
from repro_torch.configs import RunConfig, get_config
from repro_torch.core import bucketing
from repro_torch.core.tree import tree_flatten, tree_leaves, tree_paths, tree_unflatten
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import Model
from repro_torch.models import moe as tmoe
from repro_torch.train.trainer import Trainer

# one intra-op thread: the suite runs in several worker processes at once, and
# the spinning OpenMP threads of each would contend for the same cores
torch.set_num_threads(1)

ARCH = "mixtral-8x7b-smoke"
N, BATCH, SEQ, STEPS = 4, 8, 16, 3
AUX_COEF = 0.1  # (d): the default 0.01 separates the semantics by only ~1e-3
TOL = 1e-4
RUN = dict(total_steps=STEPS, warmup_steps=0, learning_rate=1e-3, seed=7)
DEAD = 1


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32", router_aux_coef=AUX_COEF)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's initial state as its own npz checkpoint at step 0;
    its single-device ``Trainer`` over 3 full-batch steps; and the 4-shard
    and 3-survivor compositions of its own functions from the same state
    on the same batches. Each run: (losses, grad norms, aux values)."""
    ckpt = str(tmp_path_factory.mktemp("moe_ckpt"))
    jcfg = _f32(jget_config(ARCH))
    jtr = JTrainer(jcfg, JRunConfig(**RUN), mesh=make_local_mesh(1), ckpt_dir=ckpt)
    params, opt = jtr.init_state()
    jckpt.save_checkpoint(ckpt, 0, params)
    jckpt.save_checkpoint(os.path.join(ckpt, "opt"), 0, opt)
    _, _, hist = jtr.train(batch=BATCH, seq=SEQ, steps=STEPS, log_every=1)
    glob = ([h["loss"] for h in hist], [h["grad_norm"] for h in hist],
            [h["aux"] for h in hist])

    vg = jax.jit(jax.value_and_grad(
        lambda p, b: jtr.model.loss(p, b, remat=jtr.run.remat), has_aux=True))

    @jax.jit
    def update(params, opt, grads):
        grads, gnorm = jopt.clip_by_global_norm(grads, 1.0)
        params, opt = jtr.optimizer.update(grads, opt, params, jtr.lr_fn(opt["step"]))
        return params, opt, gnorm

    def composed(ranks):
        params, opt = jtr.init_state()
        it = jbatches(jtr.source, jcfg, batch=BATCH, seq=SEQ)
        per = BATCH // N
        losses, norms, auxs = [], [], []
        for _ in range(STEPS):
            b = next(it)
            outs = [vg(params, {k: v[r * per:(r + 1) * per] for k, v in b.items()})
                    for r in ranks]
            grads = jax.tree.map(lambda *g: sum(g) / len(g), *[g for _, g in outs])
            params, opt, gnorm = update(params, opt, grads)
            losses.append(float(np.mean([float(l) for (l, _m), _g in outs])))
            auxs.append(float(np.mean([float(m["aux"]) for (_l, m), _g in outs])))
            norms.append(float(gnorm))
        return losses, norms, auxs

    return {"ckpt": ckpt, "global": glob, "per_rank": composed(range(N)),
            "survivors": composed([r for r in range(N) if r != DEAD])}


def _port(sync_mode: str, ckpt=None, health=None, check_rows=False, **kw) -> Trainer:
    return Trainer(_f32(get_config(ARCH)), RunConfig(sync_mode=sync_mode, **RUN, **kw),
                   mesh=make_mesh(N, device="cpu"), ckpt_dir=ckpt, device="cpu",
                   health=health, check_rows=check_rows)


def _track(hist, want) -> None:
    """Losses within TOL at every step; grad norms as
    tests/test_torch_resilience.py holds them: step 0 within f32 summation
    order (1e-5 relative), the later steps, whose parameters have drifted by
    the losses' 1e-4, within 1e-4 relative."""
    losses, norms = [h["loss"] for h in hist], [h["grad_norm"] for h in hist]
    assert len(losses) == STEPS
    assert max(abs(a - b) for a, b in zip(losses, want[0])) <= TOL, (losses, want[0])
    rel = [abs(a - b) / b for a, b in zip(norms, want[1])]
    assert rel[0] <= 1e-5 and max(rel) <= 1e-4, (norms, want[1])


def test_grad_allreduce_tracks_the_reference_global_batch_trainer(reference):
    """(a): one pass over the global batch, the aux of the whole batch."""
    _, _, hist = _port("grad_allreduce", reference["ckpt"]).train(
        batch=BATCH, seq=SEQ, steps=STEPS, log_every=1)
    _track(hist, reference["global"])
    auxs = [h["aux"] for h in hist]
    assert max(abs(a - b) for a, b in zip(auxs, reference["global"][2])) <= 1e-6


@pytest.mark.parametrize("sync_mode", ["param_bcast", "param_bcast_ring", "tuned_allreduce",
                                       "overlap_allreduce"])
def test_explicit_modes_track_the_reference_per_rank_composition(reference, sync_mode):
    """(b): each rank's loss on its shard (its own aux), the mean of the
    ranks' gradients; ``grad_rows_differ`` 0 at every step."""
    kw = {"bcast_algo": "ring_allreduce"} if sync_mode == "param_bcast_ring" else {}
    _, _, hist = _port(sync_mode.removesuffix("_ring"), reference["ckpt"], check_rows=True,
                       **kw).train(batch=BATCH, seq=SEQ, steps=STEPS, log_every=1)
    _track(hist, reference["per_rank"])
    auxs = [h["aux"] for h in hist]
    assert max(abs(a - b) for a, b in zip(auxs, reference["per_rank"][2])) <= 1e-6
    assert all(h["grad_rows_differ"] == 0 for h in hist)


def test_degraded_step_tracks_the_reference_survivor_composition(reference, capsys):
    """(c): rank 1 dead: the survivors' mean of ``nll + aux``, each
    survivor's aux its own."""
    tr = _port("tuned_allreduce", reference["ckpt"], health=MeshHealth(n=N, dead_ranks=(DEAD,)))
    assert "falls back to psum-over-survivors" in capsys.readouterr().out
    _, _, hist = tr.train(batch=BATCH, seq=SEQ, steps=STEPS, log_every=1)
    _track(hist, reference["survivors"])


def test_the_two_aux_semantics_differ_on_this_batch(reference):
    """(d): the global-batch and the per-rank losses differ by more than 10x
    TOL, at the first step (same parameters: only the aux differs) and over
    the run, so (a) and (b) cannot both pass on one semantics."""
    glob, per = reference["global"], reference["per_rank"]
    assert abs(glob[0][0] - per[0][0]) > 10 * TOL, (glob[0], per[0])
    assert abs(glob[2][0] - per[2][0]) > 10 * TOL, (glob[2], per[2])
    assert max(abs(a - b) for a, b in zip(glob[0], per[0])) > 10 * TOL


# ------------------------------------------------------------- (e) bf16 tree

# phase 6's run settings (chip_smoke.py TRAIN_RUN): no update at step 0
BF16_RUN = dict(total_steps=STEPS, warmup_steps=1, learning_rate=1e-3, seed=0)
BF16_MODES = (  # label, RunConfig fields
    ("grad_allreduce", {"sync_mode": "grad_allreduce"}),
    ("param_bcast", {"sync_mode": "param_bcast"}),
    ("param_bcast_ring", {"sync_mode": "param_bcast", "bcast_algo": "ring_allreduce"}),
    ("tuned_allreduce", {"sync_mode": "tuned_allreduce", "compiled_collectives": True}),
    ("overlap_allreduce", {"sync_mode": "overlap_allreduce", "compiled_collectives": True}),
    ("overlap_prefetch", {"sync_mode": "overlap_allreduce", "compiled_collectives": True,
                          "prefetch_stream": True}),
    ("compressed_bf16", {"sync_mode": "compressed_allreduce", "wire_format": "bf16",
                         "compiled_collectives": True}),
    ("compressed_int8", {"sync_mode": "compressed_allreduce", "wire_format": "int8",
                         "compiled_collectives": True}),
)


@pytest.fixture(scope="module")
def bf16_runs():
    cfg = get_config(ARCH)
    out = {}
    for label, fields in BF16_MODES:
        tr = Trainer(cfg, RunConfig(**BF16_RUN, **fields), mesh=make_mesh(N, device="cpu"),
                     device="cpu", check_rows=label != "grad_allreduce")
        params, opt, hist = tr.train(batch=BATCH, seq=32, steps=STEPS, log_every=1)
        out[label] = (params, opt, hist)
    return out


def test_bf16_bucket_plan_puts_the_f32_leaves_in_f32_buckets():
    """The router is f32 among bf16 leaves (so are the RMS-norm scales, as
    in the reference): the bucket plan gives the f32 leaves buckets of
    their own, holding every router leaf and nothing else but the scales."""
    params = Model(get_config(ARCH)).init(0, device="cpu")
    spec = bucketing.plan_buckets(params, RunConfig().bcast_bucket_bytes)
    paths = tree_paths(params)
    f32 = {b for b, d in enumerate(spec.bucket_dtypes) if d == torch.float32}
    assert f32 and any(d == torch.bfloat16 for d in spec.bucket_dtypes)
    in_f32 = {paths[m.index] for m in spec.leaves if m.bucket in f32}
    routers = {p for p in paths if p.endswith("router")}
    assert routers and routers <= in_f32
    assert all(p.endswith(("router", "scale")) for p in in_f32), in_f32
    for m in spec.leaves:
        assert (m.bucket in f32) == (m.dtype == torch.float32)


def test_bf16_sync_modes_on_the_mixed_tree(bf16_runs):
    """Every bf16-wire mode: synced rows bit-equal at every step, finite
    losses, and the modes that replay ``tuned_allreduce``'s plans
    bit-equal to it. Phase 6's limits hold at the two steps taken from the
    initial parameters (step 0's learning rate is 0): losses within 1e-3 of
    ``grad_allreduce``'s (whose global aux differs from the per-rank one by
    up to 8.4e-4 here) and grad norms within 2e-4 relative of
    ``tuned_allreduce``'s, which shares the explicit modes' aux. Later steps
    are not held to them at this width: Adam's first update is
    ``lr * sign(g)``, which takes the sign of near-zero bf16 gradients
    that another summation order or aux flips (at seed 0 the last losses
    read up to 6.1e-3 apart, the ring's 8.4e-4 from tuned's)."""
    base = bf16_runs["grad_allreduce"][2]
    tuned = bf16_runs["tuned_allreduce"]
    for label, _f in BF16_MODES[1:-1]:
        params, _opt, hist = bf16_runs[label]
        assert all(h["grad_rows_differ"] == 0 for h in hist), label
        assert all(math.isfinite(h["loss"]) for h in hist), label
        for s in (0, 1):
            assert abs(hist[s]["loss"] - base[s]["loss"]) <= 1e-3, (label, s)
            want = tuned[2][s]["grad_norm"]
            assert abs(hist[s]["grad_norm"] - want) <= 2e-4 * want, (label, s)
        if label in ("overlap_allreduce", "overlap_prefetch", "compressed_bf16"):
            for a, b in zip(tree_leaves(tuned[0]), tree_leaves(params)):
                assert torch.equal(a, b), label
    for a, b in zip(tree_leaves(tuned[0]), tree_leaves(Model(get_config(ARCH)).init(
            0, device="cpu"))):
        assert a.dtype == b.dtype  # the router stays f32 through the updates


def test_int8_wire_on_the_mixed_tree(bf16_runs):
    """int8: last loss within 5e-3 of ``tuned_allreduce``'s; the residual
    keeps one f32 row per rank for every leaf, bf16 or f32, and is nonzero
    in the router's rows as in the experts'."""
    params, opt, hist = bf16_runs["compressed_int8"]
    tuned = bf16_runs["tuned_allreduce"][2]
    assert abs(hist[-1]["loss"] - tuned[-1]["loss"]) <= 5e-3
    paths = tree_paths(params)
    for path, p, e in zip(paths, tree_leaves(params), tree_leaves(opt["ef"])):
        assert e.dtype == torch.float32 and tuple(e.shape) == (N,) + tuple(p.shape), path
        if path.endswith(("router", "w_gate")):
            assert all(bool(row.any()) for row in e), path


# ------------------------------------------------------------- the router


def test_recompute_under_remat_routes_as_the_forward(monkeypatch):
    """``torch.utils.checkpoint`` recomputes each superblock in the backward
    pass: the recompute's top-k and capacity choices are the forward's, in
    bf16 and under a zeroed router (every probability ties), and the
    gradients equal those of the run without remat."""
    cfg = get_config(ARCH)
    model = Model(cfg)
    calls = []
    route = tmoe._route

    def spy(p, xg, cfg, ranks=1):
        out = route(p, xg, cfg, ranks)
        calls.append(out[1].detach().clone())  # the dispatch tensor
        return out

    monkeypatch.setattr(tmoe, "_route", spy)
    toks = torch.from_numpy(np.random.RandomState(3).randint(0, cfg.vocab_size, (2, 65)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    for zero in (False, True):
        params = model.init(3, device="cpu")
        if zero:
            for b in params["decoder"]["blocks"]:
                b["moe"]["router"].zero_()
        grads = {}
        for remat in (False, True):
            calls.clear()
            leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
            treedef = tree_flatten(params)[1]
            loss, _ = model.loss(tree_unflatten(treedef, leaves), batch, remat=remat)
            grads[remat] = torch.autograd.grad(loss, leaves)
            fwd = cfg.num_layers  # one layer a superblock
            if remat:  # the backward recomputes the last superblock first
                assert len(calls) == 2 * fwd
                for a, b in zip(calls[:fwd], reversed(calls[fwd:])):
                    assert torch.equal(a, b)
            else:
                assert len(calls) == fwd
        for a, b in zip(grads[False], grads[True]):
            assert torch.equal(a, b), zero


def test_ce_carries_no_gradient_and_me_does():
    """``ce`` counts the top-k choices (one-hot of indices: no gradient in
    the reference), ``me`` averages the router's probabilities."""
    cfg = get_config(ARCH)
    params = Model(cfg).init(5, device="cpu")
    p = dict(params["decoder"]["blocks"][0]["moe"])
    p["router"] = p["router"][0].clone().requires_grad_(True)
    xg = torch.randn(2, 1, 16, cfg.d_model, generator=torch.Generator().manual_seed(5))
    _combine, _dispatch, me, ce = tmoe._route(p, xg.to(torch.bfloat16), cfg)
    assert not ce.requires_grad and ce.grad_fn is None
    assert me.requires_grad
    (g,) = torch.autograd.grad((me * ce).sum(), p["router"])
    assert float(g.abs().max()) > 0


def test_shared_expert_model_takes_a_tuned_allreduce_step():
    cfg = get_config("moonshot-v1-16b-a3b-smoke")
    assert cfg.num_shared_experts
    tr = Trainer(cfg, RunConfig(sync_mode="tuned_allreduce", **RUN),
                 mesh=make_mesh(N, device="cpu"), device="cpu", check_rows=True)
    _, _, hist = tr.train(batch=BATCH, seq=SEQ, steps=1, log_every=1)
    assert math.isfinite(hist[0]["loss"]) and hist[0]["aux"] > 0
    assert hist[0]["grad_rows_differ"] == 0
