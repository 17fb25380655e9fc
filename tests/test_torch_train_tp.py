"""Training on a model axis: the port's ``grad_allreduce`` on ('data',
'model') and ('pod', 'data', 'model') meshes against the reference's, on
the CPU.

The reference trains its ``Trainer`` under ``grad_allreduce`` on 8 host
devices in a module-scoped fixture (two subprocesses side by side), in f32: minitron-8b-smoke,
gemma3-27b-smoke and qwen1.5-32b-smoke (every QKV bias redrawn nonzero from
a numpy seed) on ``make_local_mesh(model_parallel=2)``, (4, 2), and
minitron-8b-smoke on (2, 2, 2). Each run starts from its initial state
placed by ``param_specs`` (FSDP on the data axes, the heads, the MLP width
and the vocab on ``model``), saved as the reference's own npz checkpoint,
which the port's ``Trainer`` restores on the port's mesh of the same shape.
The subprocesses also run the reference test's own pair
(``tests/test_train.py::test_sync_modes_agree``, in f32: two microbatches
for 6 steps on (4, 2), and ``param_bcast`` on 8 data ranks) and the
reference's training CLI with ``--model-parallel 2``.

Held: each rank row of the port's blocked state bit-equal to the
reference's addressable shard at that mesh coordinate; 3 steps of losses
within 1e-4, grad norms within 1e-5 relative and the returned full
parameters within 1e-4; the pair's relations; the rows that hold copies of
a block bit-equal after every step; the gather bit-equal to the plain
concatenation of the blocks through every executor; the tensor-parallel
embedding's gradient bit-equal to the one-axis one in bf16; checkpoints
restoring across layouts; the refusals; the CLI beside the reference's.
"""
from __future__ import annotations

import dataclasses
import os
import re
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro_torch import comm
from repro_torch.configs import RunConfig, get_config
from repro_torch.core.tree import tree_flatten, tree_leaves
from repro_torch.data.pipeline import batches
from repro_torch.dist import sharding as tsharding
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as ttrain
from repro_torch.models import Model
from repro_torch.models import layers as tlayers
from repro_torch.models import tensor_parallel as tp_lib
from repro_torch.optim import optimizers as topt
from repro_torch.train import train_step as tts
from repro_torch.train.trainer import SYNC_MODES, Trainer

# one intra-op thread: the suite runs in several worker processes at once, and
# the spinning OpenMP threads of each would contend for the same cores
torch.set_num_threads(1)

CASES = {  # case: (arch, mesh shape)
    "minitron_4x2": ("minitron-8b-smoke", (4, 2)),
    "gemma3_4x2": ("gemma3-27b-smoke", (4, 2)),
    "qwen_4x2": ("qwen1.5-32b-smoke", (4, 2)),
    "minitron_2x2x2": ("minitron-8b-smoke", (2, 2, 2)),
}
BIAS_SEED = {"qwen1.5-32b-smoke": 3}
RUN = dict(total_steps=3, warmup_steps=0, learning_rate=1e-3, seed=7)
BATCH, SEQ, STEPS = 8, 16, 3
PAIR = dict(total_steps=6, warmup_steps=2, learning_rate=1e-3)  # the reference test's
PAIR_BATCH, PAIR_SEQ, PAIR_STEPS = 8, 32, 6
CLI = ["--arch", "minitron-8b-smoke", "--model-parallel", "2", "--steps", "2", "--log-every", "1"]
LOSS_TOL, NORM_REL, PARAM_TOL, PARAM_SHARE = 1e-4, 1e-5, 1e-4, 1e-4


def _names(shape) -> tuple:
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")


_REFERENCE = r'''
import contextlib, dataclasses, io, os, sys
import numpy as np
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.configs.base import RunConfig
from repro.launch import train as jtrain
from repro.launch.mesh import make_local_mesh
from repro.train import checkpoint as ckpt
from repro.train.trainer import Trainer

def mk(shape):
    names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    return jax.make_mesh(shape, names, axis_types=(jax.sharding.AxisType.Auto,) * len(names))

def f32(name):
    return dataclasses.replace(get_config(name), dtype="float32")

def with_biases(tree, seed):
    rng = np.random.RandomState(seed)
    def draw(path, a):
        if getattr(path[-1], "key", None) in ("bq", "bk", "bv"):
            return (rng.randn(*a.shape) * 0.5).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(draw, tree)

def start(tr, mesh, folder, seed=None):
    """The trainer's initial state placed by its specs (biases redrawn with
    seed), saved as the step-0 checkpoint under folder; the trainer then
    starts from the placed state."""
    params, _ = tr.init_state()
    host = jax.tree.map(np.asarray, jax.device_get(params))
    if seed is not None:
        host = with_biases(host, seed)
    shardings = jax.tree.map(lambda s: NamedSharding(mesh, s), tr._pspecs)
    placed = jax.device_put(host, shardings)
    opt = jax.jit(tr.optimizer.init)(placed)
    ckpt.save_checkpoint(folder, 0, host)
    ckpt.save_checkpoint(folder + "/opt", 0, jax.device_get(opt))
    tr.restore_or_init = lambda: (placed, opt, 0)
    return placed

out = {}
for case in PART_CASES:
    arch, shape = CASES[case]
    mesh = mk(shape)
    tr = Trainer(f32(arch), RunConfig(**RUN), mesh=mesh)
    placed = start(tr, mesh, os.path.join(FOLDER, case), BIAS_SEED.get(arch))
    ranks = {d: r for r, d in enumerate(mesh.devices.flat)}
    for i, leaf in enumerate(jax.tree.leaves(placed)):
        rows = [None] * mesh.size
        for s in leaf.addressable_shards:
            rows[ranks[s.device]] = np.asarray(s.data)
        out[f"{case}/shard{i}"] = np.stack(rows)
    params, _, hist = tr.train(batch=BATCH, seq=SEQ, steps=STEPS, log_every=1)
    out[f"{case}/loss"] = np.array([h["loss"] for h in hist])
    out[f"{case}/gnorm"] = np.array([h["grad_norm"] for h in hist])
    for i, leaf in enumerate(jax.tree.leaves(params)):
        out[f"{case}/final{i}"] = np.asarray(jax.device_get(leaf))

if PART == 0:  # the reference test's pair, in f32
    cfg = f32("minitron-8b-smoke")
    mesh = make_local_mesh(model_parallel=2)
    tr = Trainer(cfg, RunConfig(num_microbatches=2, sync_mode="grad_allreduce", **PAIR),
                 mesh=mesh)
    start(tr, mesh, os.path.join(FOLDER, "pair"))
    _, _, h1 = tr.train(batch=PAIR_BATCH, seq=PAIR_SEQ, steps=PAIR_STEPS, log_every=1)
    run2 = RunConfig(sync_mode="param_bcast", bcast_algo="auto", **PAIR)
    _, _, h2 = Trainer(cfg, run2, mesh=make_local_mesh(model_parallel=1)).train(
        batch=PAIR_BATCH, seq=PAIR_SEQ, steps=PAIR_STEPS, log_every=1)
    out["pair/tp"] = np.array([h["loss"] for h in h1])
    out["pair/bcast"] = np.array([h["loss"] for h in h2])
else:  # the training CLI on its checkpoint (bf16, seed 0)
    folder = os.path.join(FOLDER, "cli")
    tr = Trainer(get_config("minitron-8b-smoke"), RunConfig(), mesh=make_local_mesh(2))
    start(tr, tr.mesh, folder)
    sys.argv = ["train"] + CLI + ["--ckpt-dir", folder]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jtrain.main()
    out["cli"] = np.array(buf.getvalue())
np.savez(os.path.join(FOLDER, f"reference{PART}.npz"), **out)
print("PASS")
'''


# the reference's work in two 8-device subprocesses run side by side (each
# is bound by XLA's compiles, one thread apiece): the cases of each part, and
# the pair (part 0) or the CLI (part 1)
PARTS = (("gemma3_4x2",), ("minitron_4x2", "qwen_4x2", "minitron_2x2x2"))


@pytest.fixture(scope="module")
def reference(dist, tmp_path_factory):
    """The reference's results and checkpoints: (folder, results)."""
    folder = str(tmp_path_factory.mktemp("train_tp"))
    head = (f"CASES = {CASES!r}\nBIAS_SEED = {BIAS_SEED!r}\nRUN = {RUN!r}\nPAIR = {PAIR!r}\n"
            f"BATCH, SEQ, STEPS = {BATCH}, {SEQ}, {STEPS}\n"
            f"PAIR_BATCH, PAIR_SEQ, PAIR_STEPS = {PAIR_BATCH}, {PAIR_SEQ}, {PAIR_STEPS}\n"
            f"CLI = {CLI!r}\nFOLDER = {folder!r}\n")
    with ThreadPoolExecutor(len(PARTS)) as pool:
        runs = [pool.submit(dist, head + f"PART = {i}\nPART_CASES = {cases!r}\n" + _REFERENCE,
                            devices=8, timeout=400, env={"OMP_NUM_THREADS": "1"})
                for i, cases in enumerate(PARTS)]
        for r in runs:
            r.result()
    out = {}
    for i in range(len(PARTS)):
        out.update(np.load(os.path.join(folder, f"reference{i}.npz")))
    return folder, out


def _f32(name: str):
    return dataclasses.replace(get_config(name), dtype="float32")


def _mesh(shape):
    return tmesh.make_mesh(shape, axis_names=_names(shape), device="cpu")


def _trainer(case: str, ckpt=None, **kw) -> Trainer:
    arch, shape = CASES[case]
    return Trainer(_f32(arch), RunConfig(**{**RUN, **kw}), mesh=_mesh(shape), ckpt_dir=ckpt,
                   device="cpu")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def _copies_equal(tree, specs, mesh) -> None:
    """Every rank row that holds a copy of a block is bit-equal to the row
    of the rank that owns it (the same coordinates on the axes the spec
    names, 0 on the others)."""
    shape, names = tuple(mesh.devices.shape), tuple(mesh.axis_names)
    for leaf, spec in zip(tree_leaves(tree), tree_flatten(specs, tsharding.is_spec)[0]):
        named = set(tsharding.spec_axes(spec))
        for r in range(mesh.size):
            coords = np.unravel_index(r, shape)
            owner = int(np.ravel_multi_index(
                [c if a in named else 0 for a, c in zip(names, coords)], shape))
            assert owner in tsharding.owner_ranks(spec, mesh)
            assert torch.equal(_bits(leaf[r]), _bits(leaf[owner])), (spec, r, owner)


# --------------------------------------------------------------------------
# the trainer against the reference's model-axis trainer
# --------------------------------------------------------------------------


@pytest.mark.parametrize("case", CASES)
def test_rows_are_the_reference_shards(reference, case):
    """The port restores the reference's step-0 checkpoint into the
    blocked layout: row ``r`` of every parameter is the reference's
    addressable shard on the device at rank ``r``'s mesh coordinate, bit for
    bit; the optimizer's moments are zero blocks of the same shapes."""
    folder, ref = reference
    params, opt, step = _trainer(case, os.path.join(folder, case)).restore_or_init()
    assert step == 0 and int(opt["step"]) == 0
    leaves = tree_leaves(params)
    assert len(leaves) == len([k for k in ref if k.startswith(f"{case}/shard")])
    for i, leaf in enumerate(leaves):
        np.testing.assert_array_equal(leaf.numpy(), ref[f"{case}/shard{i}"], err_msg=str(i))
    for m in tree_leaves(opt["m"]):
        assert not m.any()
    assert [m.shape for m in tree_leaves(opt["v"])] == [p.shape for p in leaves]


@pytest.mark.parametrize("case", CASES)
def test_trainer_tracks_the_reference_on_a_model_axis(reference, case):
    """``Trainer.train`` from the reference's checkpoint: 3 steps of
    losses within 1e-4, grad norms within 1e-5 relative, and the returned
    full parameters within 1e-4 of the reference's ``jax.device_get``, but
    for at most one element in 10^4, which stays within 2e-4. AdamW's step
    is about ``lr`` wherever a gradient is near zero, whatever its size, so
    such an element moves by up to 1e-3 a step on a rounding of its
    gradient: the reference's own one-axis and (4, 2) runs of the qwen case
    lie 8.43e-5 apart at their farthest element, and the port's one-axis
    trainer 8.22e-5 from the reference's one-axis run."""
    folder, ref = reference
    params, opt, hist = _trainer(case, os.path.join(folder, case)).train(
        batch=BATCH, seq=SEQ, steps=STEPS, log_every=1)
    losses = np.array([h["loss"] for h in hist])
    norms = np.array([h["grad_norm"] for h in hist])
    assert np.abs(losses - ref[f"{case}/loss"]).max() <= LOSS_TOL, (losses, ref[f"{case}/loss"])
    rel = np.abs(norms - ref[f"{case}/gnorm"]) / ref[f"{case}/gnorm"]
    assert rel.max() <= NORM_REL, (norms, ref[f"{case}/gnorm"])
    leaves = tree_leaves(params)
    over, total = 0, 0
    for i, leaf in enumerate(leaves):
        want = ref[f"{case}/final{i}"]
        assert tuple(leaf.shape) == want.shape
        err = np.abs(leaf.numpy() - want)
        assert err.max() <= 2 * PARAM_TOL, (i, err.max())
        over, total = over + int((err > PARAM_TOL).sum()), total + err.size
    assert over <= PARAM_SHARE * total, (over, total)
    assert [tuple(m.shape) for m in tree_leaves(opt["m"])] == [tuple(p.shape) for p in leaves]


@pytest.mark.parametrize("case", ["minitron_4x2", "minitron_2x2x2"])
def test_rows_holding_copies_stay_bit_equal(reference, case):
    """After every step, each rank row that holds a copy of a block (norm
    scales everywhere; the QKV biases and every leaf the data axes do not
    split, over the data ranks) is bit-equal to its owner's, in the
    parameters and in both AdamW moments."""
    folder, _ = reference
    trainer = _trainer(case, os.path.join(folder, case))
    params, opt, start = trainer.restore_or_init()
    it = batches(trainer.source, trainer.cfg, batch=BATCH, seq=SEQ, device="cpu")
    for _ in range(2):
        params, opt, _ = trainer._step_fn(params, opt, next(it))
        for tree in (params, opt["m"], opt["v"]):
            _copies_equal(tree, trainer.specs, trainer.mesh)


def test_microbatch_pair_keeps_the_reference_relations(reference):
    """The reference test's pair in f32: ``grad_allreduce`` with two
    microbatches on (4, 2) for 6 steps tracks the reference's own
    model-axis run within 1e-4 at every step, and holds the reference
    test's relations to ``param_bcast`` on 8 data ranks: the first loss
    within 0.02, the last within 0.15, the loss falling."""
    folder, ref = reference
    trainer = Trainer(_f32("minitron-8b-smoke"),
                      RunConfig(num_microbatches=2, sync_mode="grad_allreduce", **PAIR),
                      mesh=tmesh.make_local_mesh(2, n=8, device="cpu"),
                      ckpt_dir=os.path.join(folder, "pair"), device="cpu")
    _, _, hist = trainer.train(batch=PAIR_BATCH, seq=PAIR_SEQ, steps=PAIR_STEPS, log_every=1)
    losses = np.array([h["loss"] for h in hist])
    assert np.abs(losses - ref["pair/tp"]).max() <= LOSS_TOL, (losses, ref["pair/tp"])
    bcast = ref["pair/bcast"]
    assert losses[-1] < losses[0]
    assert abs(losses[0] - bcast[0]) < 0.02 and abs(losses[-1] - bcast[-1]) < 0.15, \
        (losses, bcast)


def test_checkpoints_restore_across_layouts(tmp_path):
    """A checkpoint written on (4, 2) holds the full tree: it restores on a
    one-axis mesh of 8 ranks as the parameters ``train`` returned there,
    and one written on the one-axis mesh restores on (4, 2) as the blocks
    of its tree; a step from it on either layout gives the same loss."""
    ckpt = str(tmp_path / "ckpt")
    cfg = _f32("minitron-8b-smoke")

    def trainer(mesh):
        return Trainer(cfg, RunConfig(**RUN), mesh=mesh, ckpt_dir=ckpt, device="cpu")

    tp, one = trainer(_mesh((4, 2))), trainer(tmesh.make_mesh(8, device="cpu"))
    params, opt, _ = tp.train(batch=BATCH, seq=SEQ, steps=2, log_every=0, ckpt_every=2)
    got, got_opt, step = one.restore_or_init()
    assert step == 2 and int(got_opt["step"]) == 2
    for a, b in zip(tree_leaves((got, got_opt["m"], got_opt["v"])),
                    tree_leaves((params, opt["m"], opt["v"]))):
        assert torch.equal(a, b)
    params, _, _ = one.train(batch=BATCH, seq=SEQ, steps=1, log_every=0, ckpt_every=1)
    blocked, _, step = tp.restore_or_init()
    assert step == 3
    for a, b in zip(tree_leaves(blocked), tree_leaves(
            tsharding.shard_stacked(params, tp.specs, tp.mesh))):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(tp._full(blocked)), tree_leaves(params)):
        assert torch.equal(a, b)
    (h_tp,), (h_one,) = (t.train(batch=BATCH, seq=SEQ, steps=1, log_every=1)[2]
                         for t in (tp, one))
    assert h_tp["step"] == h_one["step"] == 3
    assert abs(h_tp["loss"] - h_one["loss"]) <= LOSS_TOL, (h_tp, h_one)


# --------------------------------------------------------------------------
# the gather, the embedding's backward, the norm
# --------------------------------------------------------------------------


@pytest.mark.parametrize("ex", [{"compiled": True}, {"compiled": False}, {"inkernel": True}],
                         ids=["compiled", "unrolled", "inkernel"])
@pytest.mark.parametrize("shape", [(4, 2), (2, 2, 2)], ids=["4x2", "2x2x2"])
def test_gather_is_the_concatenation_of_the_blocks(shape, ex):
    """Each model rank's gathered shard of every minitron-8b-smoke leaf, in
    bf16, through the compiled, unrolled and in-kernel replays of
    ``pallgather``: bit-equal to the plain concatenation of its data ranks'
    blocks along the dim they split (pod-major over ('pod', 'data')), and
    to the model rank's block of the full leaf."""
    mesh = _mesh(shape)
    model = Model(get_config("minitron-8b-smoke"))
    full = model.init(0, device="cpu")
    specs = tts.tp_specs(model, mesh)
    blocked = tsharding.shard_stacked(full, specs, mesh)
    gather = lambda frame, axis: comm.pallgather(frame, **ex)  # noqa: E731
    sizes = dict(zip(mesh.axis_names, shape))
    for leaf, spec, whole in zip(tree_leaves(blocked), tree_flatten(specs, tsharding.is_spec)[0],
                                 tree_leaves(full)):
        got = tts.gather_model_shards(leaf, spec, mesh, gather)
        sharded = "model" in tsharding.spec_axes(spec)
        assert len(got) == (sizes["model"] if sharded else 1)
        k, axes = tts._fsdp_dim(spec)
        for j, g in enumerate(got):
            ranks = [r for r in range(mesh.size)
                     if np.unravel_index(r, shape)[-1] == j
                     and all(np.unravel_index(r, shape)[list(mesh.axis_names).index(a)] == 0
                             for a in mesh.axis_names[:-1] if a not in axes)]
            want = torch.cat([leaf[r] for r in ranks], dim=k) if axes else leaf[ranks[0]]
            assert torch.equal(_bits(g), _bits(want)), (spec, j)
            model_only = tsharding.P(*[e if e == "model" else None for e in spec])
            sl = tsharding.shard_slices(model_only, tuple(whole.shape), mesh, ranks[0])
            assert torch.equal(_bits(g), _bits(whole[sl])), (spec, j)


def test_tp_embedding_gradient_is_the_one_axis_f32_sum():
    """In bf16, on a batch where a few tokens repeat many times, each vocab
    shard's gradient of the tensor-parallel lookup is bit-equal to its rows
    of the one-axis lookup's (``_RowGather``: each row's gradients summed
    in f32, rounded once); indexing's own backward, which accumulates in
    bf16, is not."""
    rng = np.random.RandomState(0)
    vocab, d, m = 64, 32, 2
    table = torch.from_numpy(rng.randn(vocab, d).astype(np.float32)).bfloat16()
    tokens = torch.from_numpy(rng.choice([1, 3, 40, 63], size=(4, 96)).astype(np.int64))
    tokens[0, :5] = torch.arange(5)
    up = torch.from_numpy(rng.randn(4, 96, d).astype(np.float32)).bfloat16()
    one = table.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(tlayers.embed_tokens({"tokens": one}, tokens), one, up)
    shards = [table[j * vocab // m:(j + 1) * vocab // m].clone().requires_grad_(True)
              for j in range(m)]
    x = tp_lib.model_axis_sum([tp_lib._embed_shard(t, tokens, j) for j, t in enumerate(shards)])
    assert torch.equal(x, table[tokens])
    got = torch.autograd.grad(x, shards, up)
    for j, g in enumerate(got):
        assert torch.equal(_bits(g), _bits(want[j * vocab // m:(j + 1) * vocab // m])), j
    plain = table.clone().requires_grad_(True)
    (bf16_sum,) = torch.autograd.grad(plain[tokens], plain, up)
    assert not torch.equal(_bits(bf16_sum), _bits(want))


@pytest.mark.parametrize("shape", [(4, 2), (2, 2, 2)], ids=["4x2", "2x2x2"])
def test_global_norm_counts_each_element_once(shape):
    """The global norm over a blocked tree, counting the rows of
    ``owner_ranks``, is the full tree's; counting every row is not."""
    mesh = _mesh(shape)
    model = Model(_f32("minitron-8b-smoke"))
    full = model.init(1, device="cpu")
    specs = tts.tp_specs(model, mesh)
    blocked = tsharding.shard_stacked(full, specs, mesh)
    owners = [tsharding.owner_ranks(sp, mesh) for sp in tree_flatten(specs, tsharding.is_spec)[0]]
    want = float(topt.global_norm(full))
    got = float(topt.global_norm(blocked, owners))
    assert abs(got - want) <= 1e-6 * want
    assert float(topt.global_norm(blocked)) > want * (1 + 1e-3)
    clipped, norm = topt.clip_by_global_norm(blocked, 1.0, owners)
    assert float(norm) == got
    assert abs(float(topt.global_norm(clipped, owners)) - 1.0) <= 1e-5


# --------------------------------------------------------------------------
# the refusals and the CLI
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mode", [m for m in SYNC_MODES if m != "grad_allreduce"] + ["degraded"])
def test_explicit_modes_stay_pure_data_parallel(mode):
    """The explicit sync modes and the degraded step refuse a model axis of
    more than one rank with the reference's reason; nothing falls back to
    the one-axis step."""
    from repro_torch.comm.faults import MeshHealth

    cfg, mesh = _f32("minitron-8b-smoke"), _mesh((4, 2))
    with pytest.raises(ValueError, match="pure data-parallel"):
        if mode == "degraded":
            Trainer(cfg, RunConfig(**RUN), mesh=mesh, device="cpu",
                    health=MeshHealth(n=4, dead_ranks=(1,)))
        else:
            Trainer(cfg, RunConfig(sync_mode=mode, **RUN), mesh=mesh, device="cpu")


@pytest.mark.parametrize("arch", ["xlstm-350m-smoke", "hymba-1.5b-smoke"])
def test_uncovered_family_names_the_remainder(arch):
    """A family the tensor-parallel forward does not cover in training (the
    SSM mixers: xlstm-350m's mLSTM and sLSTM, hymba-1.5b's Mamba) raises
    naming "Tensor-parallel remainder" on a model axis, in the trainer and
    in ``apply_lm_tp(mode='train')``. The MoE, encoder-decoder and
    vision-prefix families train there (tests/test_torch_train_tp_families.py)."""
    cfg = _f32(arch)
    with pytest.raises(ValueError, match="Tensor-parallel remainder"):
        Trainer(cfg, RunConfig(**RUN), mesh=_mesh((4, 2)), device="cpu")
    with pytest.raises(ValueError, match="Tensor-parallel remainder"):
        tp_lib.apply_lm_tp([{}, {}], cfg, tokens=torch.zeros((1, 4), dtype=torch.int64),
                           mode="train")


def _step_losses(out: str) -> list:
    return [float(v) for v in re.findall(r"^step +\d+ loss (\S+)", out, flags=re.M)]


def test_train_cli_on_a_model_axis_beside_the_reference(reference, capsys):
    """``python -m repro_torch.launch.train --arch minitron-8b-smoke
    --model-parallel 2 --ranks 8 --device cpu --steps 2`` on the
    reference CLI's checkpoint (bf16, seed 0) prints the reference CLI's
    mesh and its losses within 2e-3 (the two packages round their bf16
    products in different orders: 6e-4 apart on the CPU)."""
    folder, ref = reference
    ttrain.main(CLI + ["--ranks", "8", "--device", "cpu", "--ckpt-dir",
                       os.path.join(folder, "cli")])
    got = capsys.readouterr().out
    want = str(ref["cli"])
    assert "'data': 4, 'model': 2" in got and "'data': 4, 'model': 2" in want, (got, want)
    g, w = _step_losses(got), _step_losses(want)
    assert len(g) == len(w) == 2 and max(abs(a - b) for a, b in zip(g, w)) <= 2e-3, (got, want)
