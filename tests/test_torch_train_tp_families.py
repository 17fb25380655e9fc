"""Training the MoE, encoder-decoder and vision-prefix families on a model
axis: the port's ``grad_allreduce`` on ('data', 'model') and ('pod',
'data', 'model') meshes against the reference's, on the CPU.

The reference trains its ``Trainer`` under ``grad_allreduce`` on 8 host
devices in a module-scoped fixture (subprocesses side by side), in f32,
under ``param_specs(fsdp=True, attn_fallback='replicate')``:
mixtral-8x7b-, qwen3-moe-30b-a3b- and moonshot-v1-16b-a3b-smoke (expert
shards; moonshot's shared experts), whisper-large-v3-smoke (the encoder and
cross attention, every QKV bias redrawn nonzero from a numpy seed) and
paligemma-3b-smoke (its one kv head replicated, each rank's query heads over
it) on (4, 2); mixtral-8x7b-smoke on (2, 2, 2); mixtral-8x7b-smoke with 3
experts (expert-FFN shards) and paligemma-3b-smoke with 3 query heads (the
whole attention replicated) on (4, 2). Each run starts from its initial
state placed by its specs, saved as the reference's own npz checkpoint,
which the port's ``Trainer`` restores on the port's mesh of the same shape.
The subprocesses also run the reference's training CLI with
``--model-parallel 2`` for mixtral-8x7b-smoke.

Held per case: each rank row of the port's blocked state bit-equal to the
reference's addressable shard at that mesh coordinate; 3 steps of losses
within 1e-4, the router's aux loss on its own within 1e-4, grad norms
within 1e-5 relative and the returned full parameters within 1e-4; the rows
that hold copies of a block bit-equal after every step. Besides: the
train-mode tensor-parallel forward's logits and aux against the one-axis
model's, ``tp_loss`` equal to ``nll + aux``, and the CLI beside the
reference's.
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
from repro_torch.core.tree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.data.pipeline import batches, make_source
from repro_torch.dist import sharding as tsharding
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as ttrain
from repro_torch.models import Model
from repro_torch.models import tensor_parallel as tp_lib
from repro_torch.train import train_step as tts
from repro_torch.train.trainer import Trainer

# one intra-op thread: the suite runs in several worker processes at once, and
# the spinning OpenMP threads of each would contend for the same cores
torch.set_num_threads(1)

CASES = {  # case: (arch, config overrides, mesh shape)
    "mixtral_4x2": ("mixtral-8x7b-smoke", {}, (4, 2)),
    "qwen3_moe_4x2": ("qwen3-moe-30b-a3b-smoke", {}, (4, 2)),
    "moonshot_4x2": ("moonshot-v1-16b-a3b-smoke", {}, (4, 2)),
    "whisper_4x2": ("whisper-large-v3-smoke", {}, (4, 2)),
    "paligemma_4x2": ("paligemma-3b-smoke", {}, (4, 2)),
    "mixtral_2x2x2": ("mixtral-8x7b-smoke", {}, (2, 2, 2)),
    "mixtral_3_experts_4x2": ("mixtral-8x7b-smoke", {"num_experts": 3}, (4, 2)),
    "paligemma_3_heads_4x2": ("paligemma-3b-smoke", {"num_heads": 3}, (4, 2)),
}
BIAS_SEED = {"whisper-large-v3-smoke": 5}
RUN = dict(total_steps=3, warmup_steps=0, learning_rate=1e-3, seed=7)
BATCH, SEQ, STEPS = 8, 16, 3
CLI = ["--arch", "mixtral-8x7b-smoke", "--model-parallel", "2", "--steps", "2", "--log-every",
       "1"]
LOSS_TOL, NORM_REL, PARAM_TOL, PARAM_SHARE = 1e-4, 1e-5, 1e-4, 1e-4
# the CLI's bf16 losses: the packages' one-axis CLIs lie 1.0e-3 apart on
# mixtral-8x7b-smoke, and the model axis's bf16 partial sums move the top-2
# routing of near-tie tokens (the port's own (4, 2) and one-axis runs: 2.2e-3)
CLI_TOL = 5e-3


def _names(shape) -> tuple:
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")


_REFERENCE = r'''
import contextlib, dataclasses, io, os, sys
import numpy as np
import jax
from jax.sharding import NamedSharding
from repro.configs import get_config
from repro.configs.base import RunConfig
from repro.launch import train as jtrain
from repro.launch.mesh import make_local_mesh
from repro.train import checkpoint as ckpt
from repro.train.trainer import Trainer

def mk(shape):
    names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    return jax.make_mesh(shape, names, axis_types=(jax.sharding.AxisType.Auto,) * len(names))

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
    arch, kw, shape = CASES[case]
    mesh = mk(shape)
    cfg = dataclasses.replace(get_config(arch), dtype="float32", **kw)
    tr = Trainer(cfg, RunConfig(**RUN), mesh=mesh)
    placed = start(tr, mesh, os.path.join(FOLDER, case), BIAS_SEED.get(arch))
    ranks = {d: r for r, d in enumerate(mesh.devices.flat)}
    for i, leaf in enumerate(jax.tree.leaves(placed)):
        rows = [None] * mesh.size
        for s in leaf.addressable_shards:
            rows[ranks[s.device]] = np.asarray(s.data)
        out[f"{case}/shard{i}"] = np.stack(rows)
    params, _, hist = tr.train(batch=BATCH, seq=SEQ, steps=STEPS, log_every=1)
    for key in ("loss", "aux", "grad_norm"):
        out[f"{case}/{key}"] = np.array([h[key] for h in hist])
    for i, leaf in enumerate(jax.tree.leaves(params)):
        out[f"{case}/final{i}"] = np.asarray(jax.device_get(leaf))

if PART == 0:  # the training CLI on its checkpoint (bf16, seed 0)
    folder = os.path.join(FOLDER, "cli")
    tr = Trainer(get_config("mixtral-8x7b-smoke"), RunConfig(), mesh=make_local_mesh(2))
    start(tr, tr.mesh, folder)
    sys.argv = ["train"] + CLI + ["--ckpt-dir", folder]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jtrain.main()
    out["cli"] = np.array(buf.getvalue())
np.savez(os.path.join(FOLDER, f"reference{PART}.npz"), **out)
print("PASS")
'''


# the reference's work in subprocesses of 8 host devices run side by side
# (each bound by XLA's compiles, one thread apiece)
PARTS = (("mixtral_4x2", "whisper_4x2", "paligemma_3_heads_4x2"),
         ("qwen3_moe_4x2", "moonshot_4x2", "paligemma_4x2"),
         ("mixtral_2x2x2", "mixtral_3_experts_4x2"))


@pytest.fixture(scope="module")
def reference(dist, tmp_path_factory):
    """The reference's results and checkpoints: (folder, results)."""
    folder = str(tmp_path_factory.mktemp("train_tp_families"))
    head = (f"CASES = {CASES!r}\nBIAS_SEED = {BIAS_SEED!r}\nRUN = {RUN!r}\n"
            f"BATCH, SEQ, STEPS = {BATCH}, {SEQ}, {STEPS}\nCLI = {CLI!r}\nFOLDER = {folder!r}\n")
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


def _cfg(arch: str, kw: dict):
    return dataclasses.replace(get_config(arch), dtype="float32", **kw)


def _mesh(shape):
    return tmesh.make_mesh(shape, axis_names=_names(shape), device="cpu")


def _trainer(case: str, ckpt=None) -> Trainer:
    arch, kw, shape = CASES[case]
    return Trainer(_cfg(arch, kw), RunConfig(**RUN), mesh=_mesh(shape), ckpt_dir=ckpt,
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
            assert torch.equal(_bits(leaf[r]), _bits(leaf[owner])), (spec, r, owner)


# --------------------------------------------------------------------------
# the trainer against the reference's model-axis trainer
# --------------------------------------------------------------------------


def test_the_cases_reach_each_layout():
    """The cases reach what they are named for under training's layout:
    the experts cut on 'model' (mixtral, qwen3-moe, moonshot, the (2, 2,
    2) mesh) or their FFN width (3 experts), moonshot's shared experts on
    their width, whisper's self and cross attention on their heads,
    paligemma's one kv head whole beside its query heads cut, and with 3
    query heads every attention projection whole."""
    def spec_of(case, *keys):
        arch, kw, shape = CASES[case]
        model = Model(_cfg(arch, kw))
        specs = tts.tp_specs(model, _mesh(shape))
        for k in keys:
            specs = specs[k]
        return specs

    for case in ("mixtral_4x2", "qwen3_moe_4x2", "moonshot_4x2", "mixtral_2x2x2"):
        assert spec_of(case, "decoder", "blocks", 0, "moe", "w_up")[1] == "model", case
        assert spec_of(case, "decoder", "blocks", 0, "moe", "router")[-1] == "model", case
    ffn = spec_of("mixtral_3_experts_4x2", "decoder", "blocks", 0, "moe", "w_up")
    assert ffn[1] is None and ffn[-1] == "model"
    assert spec_of("mixtral_3_experts_4x2", "decoder", "blocks", 0, "moe", "router")[-1] is None
    assert spec_of("moonshot_4x2", "decoder", "blocks", 0, "moe", "shared", "w_up")[-1] == "model"
    for key in ("attn", "cross"):
        assert spec_of("whisper_4x2", "decoder", "blocks", 0, key, "wk")[-2] == "model", key
    attn = spec_of("paligemma_4x2", "decoder", "blocks", 0, "attn")
    assert attn["wq"][-2] == "model" and "model" not in tsharding.spec_axes(attn["wk"])
    attn = spec_of("paligemma_3_heads_4x2", "decoder", "blocks", 0, "attn")
    assert not any("model" in tsharding.spec_axes(attn[k]) for k in ("wq", "wk", "wv", "wo"))


@pytest.mark.parametrize("case", CASES)
def test_rows_are_the_reference_shards(reference, case):
    """The port restores the reference's step-0 checkpoint into the
    blocked layout: row ``r`` of every parameter (the router's f32 rows
    among bf16-layout ones, the biases redrawn) is the reference's
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
    losses within 1e-4, the aux loss (the router's, over the whole global
    batch; exactly 0 for whisper and paligemma) within 1e-4 on its own,
    grad norms within 1e-5 relative, and the returned full parameters
    within 1e-4 of the reference's ``jax.device_get``, but for at most one
    element in 10^4, which stays within 2e-4, as
    tests/test_torch_train_tp.py holds the dense decoders: AdamW moves an
    element whose gradient is near zero by about ``lr`` on a rounding of
    it (whisper's worst element reads 1.02e-4)."""
    folder, ref = reference
    arch = CASES[case][0]
    params, opt, hist = _trainer(case, os.path.join(folder, case)).train(
        batch=BATCH, seq=SEQ, steps=STEPS, log_every=1)
    losses, aux, norms = (np.array([h[k] for h in hist]) for k in ("loss", "aux", "grad_norm"))
    assert np.abs(losses - ref[f"{case}/loss"]).max() <= LOSS_TOL, (losses, ref[f"{case}/loss"])
    assert np.abs(aux - ref[f"{case}/aux"]).max() <= LOSS_TOL, (aux, ref[f"{case}/aux"])
    if "moe" in get_config(arch).layer_kinds():
        assert (aux > 0).all(), aux
    else:
        assert not aux.any(), aux
    rel = np.abs(norms - ref[f"{case}/grad_norm"]) / ref[f"{case}/grad_norm"]
    assert rel.max() <= NORM_REL, (norms, ref[f"{case}/grad_norm"])
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


@pytest.mark.parametrize("case", CASES)
def test_rows_holding_copies_stay_bit_equal(reference, case):
    """After every step, each rank row that holds a copy of a block (norm
    scales everywhere; a replicated router, kv projection or whole
    attention over the model ranks; every leaf the data axes do not split,
    over the data ranks) is bit-equal to its owner's, in the parameters and
    in both AdamW moments."""
    folder, _ = reference
    trainer = _trainer(case, os.path.join(folder, case))
    params, opt, _ = trainer.restore_or_init()
    it = batches(trainer.source, trainer.cfg, batch=BATCH, seq=SEQ, device="cpu")
    for _ in range(STEPS):
        params, opt, _ = trainer._step_fn(params, opt, next(it))
        for tree in (params, opt["m"], opt["v"]):
            _copies_equal(tree, trainer.specs, trainer.mesh)


# --------------------------------------------------------------------------
# the train-mode forward and its loss
# --------------------------------------------------------------------------


def _shard_trees(cfg, params, m: int) -> list:
    """The model ranks' trees of ``params`` under training's layout on one
    data rank of ``m`` model ranks, as the trainer hands them to
    ``tp_loss``: a leaf the model axis splits is each rank's block, any
    other one tensor in every tree."""
    mesh = _mesh((1, m))
    specs = tree_flatten(tts.tp_specs(Model(cfg), mesh), tsharding.is_spec)[0]
    leaves, treedef = tree_flatten(params)
    blocked = tsharding.cut_leaves(leaves, specs, mesh)
    shards = [tts.gather_model_shards(b, sp, mesh, lambda frame, axis: comm.pallgather(frame))
              for b, sp in zip(blocked, specs)]
    return [tree_unflatten(treedef, [s[j] if len(s) > 1 else s[0] for s in shards])
            for j in range(m)]


FORWARD = {  # case: (arch, overrides)
    "mixtral": ("mixtral-8x7b-smoke", {}),
    "qwen3_moe": ("qwen3-moe-30b-a3b-smoke", {}),
    "moonshot": ("moonshot-v1-16b-a3b-smoke", {}),
    "mixtral_3_experts": ("mixtral-8x7b-smoke", {"num_experts": 3}),
    "whisper": ("whisper-large-v3-smoke", {}),
    "paligemma": ("paligemma-3b-smoke", {}),
    "paligemma_3_heads": ("paligemma-3b-smoke", {"num_heads": 3}),
    "minitron": ("minitron-8b-smoke", {}),
}


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("case", FORWARD)
def test_train_forward_returns_the_aux(case, m):
    """``apply_lm_tp(mode='train')`` on ``m`` model ranks' shards returns
    the one-axis model's logits within 1e-5 and its aux within 1e-6 (a MoE
    config's nonzero, a dense one's exactly 0), and ``tp_loss`` is exactly
    its ``nll + aux``, within 1e-5 of the one-axis ``Model.loss`` on the
    same batch (the patch or frame embeddings included)."""
    arch, kw = FORWARD[case]
    cfg = _cfg(arch, kw)
    model = Model(cfg)
    params = model.init(3, device="cpu")
    batch = next(batches(make_source(cfg, seed=5), cfg, batch=4, seq=16, device="cpu"))
    want_logits, want_aux = model.forward(params, batch)
    want_loss, want_metrics = model.loss(params, batch)
    trees = _shard_trees(cfg, params, m)
    with torch.no_grad():
        logits, aux = tp_lib.apply_lm_tp(trees, cfg, tokens=batch["tokens"],
                                         embeds=batch.get("embeds"), mode="train")
        loss, metrics = tp_lib.tp_loss(trees, cfg, batch)
    assert logits.shape == want_logits.shape
    assert float((logits - want_logits).abs().max()) <= 1e-5
    assert aux.shape == () and aux.dtype == torch.float32
    if "moe" in cfg.layer_kinds():
        assert float(aux) > 0 and abs(float(aux) - float(want_aux)) <= 1e-6, (aux, want_aux)
    else:
        assert float(aux) == float(want_aux) == 0.0
    assert torch.equal(metrics["aux"], aux)
    assert torch.equal(loss, metrics["nll"] + metrics["aux"])
    assert abs(float(loss) - float(want_loss)) <= 1e-5, (loss, want_loss)
    assert abs(float(metrics["nll"]) - float(want_metrics["nll"])) <= 1e-5


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------


def _step_losses(out: str) -> list:
    return [float(v) for v in re.findall(r"^step +\d+ loss (\S+)", out, flags=re.M)]


def test_train_cli_on_a_model_axis_beside_the_reference(reference, capsys):
    """``python -m repro_torch.launch.train --arch mixtral-8x7b-smoke
    --model-parallel 2 --ranks 8 --device cpu --steps 2`` on the reference
    CLI's checkpoint (bf16, seed 0) prints the reference CLI's mesh and its
    losses within 5e-3 (``CLI_TOL``: the dense CLI case holds 2e-3, but a
    bf16 rounding that moves a near-tie token to another expert moves the
    MoE's loss further)."""
    folder, ref = reference
    ttrain.main(CLI + ["--ranks", "8", "--device", "cpu", "--ckpt-dir",
                       os.path.join(folder, "cli")])
    got = capsys.readouterr().out
    want = str(ref["cli"])
    assert "'data': 4, 'model': 2" in got and "'data': 4, 'model': 2" in want, (got, want)
    g, w = _step_losses(got), _step_losses(want)
    assert len(g) == len(w) == 2, (got, want)
    assert max(abs(a - b) for a, b in zip(g, w)) <= CLI_TOL, (g, w)
