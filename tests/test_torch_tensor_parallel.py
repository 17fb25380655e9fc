"""Tensor-parallel serving on ('data', 'model') meshes: the port against the
reference, on the CPU.

The layout rules first, with no subprocess: ``param_specs`` (both ``fsdp``
values, both ``attn_fallback`` values), ``batch_specs`` and ``cache_specs``
at the reference's input shapes, and ``_HintCtx.spec_for``, leaf by leaf as
tuples against the reference's, for every name of ``ARCHS`` (full and
smoke) on a (2, 2) ('data', 'model') mesh, a (2, 2, 2) ('pod', 'data',
'model') mesh and both production meshes.

Then one reference subprocess on 8 host devices, computing each result
once: ``distribute_weights(specs=)`` of minitron-8b-smoke, restored from the
reference's own checkpoint, on (2, 2, 2), each device's addressable shard
saved under its mesh coordinate (read through ``mesh.devices``); and
``Engine`` on (2, 2) ('data', 'model') with ``distribute=True`` for
minitron-8b-smoke and gemma3-27b-smoke in f32 at the reference test's
batch (``tests/test_dist_integration.py``), beside its single-layout run.
The port's rows are held against the shards bit for bit, its plans against
the reference's ``plan_distribution``, its tokens against both reference
runs and its log-probs within 1e-4; its caches against the reference's
prefill caches cut by ``cache_specs``. Last, a model axis of one rank (the
data-parallel engine, bit for bit), the refusals ("Tensor-parallel
remainder", "Training on a model axis") and the serving CLI against the
reference's on one checkpoint.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro import dist as jdist
from repro.configs import INPUT_SHAPES
from repro.configs import get_config as jget_config
from repro.core import cost_model as jcm
from repro.dist import hints as jhints
from repro.dist import sharding as jsharding
from repro.launch import serve as jserve
from repro.models import Model as JModel
from repro.serve import engine as jengine
from repro.train import checkpoint as jckpt
from repro_torch import dist as tdist
from repro_torch.configs import ARCHS, RunConfig, get_config
from repro_torch.core import cost_model as tcm
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.core.tuner import Tuner as TTuner
from repro_torch.dist import hints as thints
from repro_torch.dist import sharding as tsharding
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as tserve
from repro_torch.models import Model
from repro_torch.models import tensor_parallel as tp_lib
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import Engine, distribute_weights, replicate
from repro_torch.serve.engine import rank_rows
from repro_torch.train import checkpoint as tckpt
from repro_torch.train.trainer import Trainer

# one intra-op thread: the suite runs in several worker processes at once, and
# the spinning OpenMP threads of each would contend for the same cores
torch.set_num_threads(1)

SPEC_MESHES = {
    "data_model": lambda: tmesh.make_mesh((2, 2), axis_names=("data", "model"), device="cpu"),
    "pod_data_model": lambda: tmesh.make_mesh((2, 2, 2), device="cpu"),
    "production": lambda: tmesh.make_production_mesh(device="cpu"),
    "multi_pod": lambda: tmesh.make_production_mesh(multi_pod=True, device="cpu"),
}
NAMES = sorted(n for a in ARCHS for n in (a, a + "-smoke"))
ARCH = "minitron-8b-smoke"
ENGINE_ARCHS = ("minitron-8b-smoke", "gemma3-27b-smoke")
TOKENS = np.random.RandomState(0).randint(0, 500, (4, 8))  # the reference test's batch
STEPS = 4


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _dm_mesh():
    return SPEC_MESHES["data_model"]()


# --------------------------------------------------------------------------
# the layout rules
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _shapes(name: str):
    return JModel(jget_config(name)).param_shapes(), Model(get_config(name)).param_shapes()


@functools.lru_cache(maxsize=None)
def _inputs(name: str, shape: str):
    return JModel(jget_config(name)).input_specs(INPUT_SHAPES[shape])


def _ref_specs(specs) -> list:
    return [tuple(s) for s in jax.tree.leaves(specs,
                                              is_leaf=lambda s: isinstance(s, JP))]


def _port_specs(specs) -> list:
    got = tree_leaves(specs, tsharding.is_spec)
    assert all(isinstance(s, tsharding.PartitionSpec) for s in got)
    return [tuple(s) for s in got]


def _meta(tree):
    return jax.tree.map(lambda s: torch.empty(s.shape, device="meta"), tree)


@pytest.mark.parametrize("mesh_name", SPEC_MESHES)
@pytest.mark.parametrize("name", NAMES)
def test_specs_equal_reference(name, mesh_name):
    """Every leaf's spec as a tuple, the port's trees against the
    reference's: ``param_specs`` on ``Model.param_shapes()`` (meta tensors,
    the reference's leaf shapes), ``batch_specs`` and ``cache_specs`` at the
    four input shapes (the port's caches from its own ``init_cache`` on the
    meta device, their shapes the reference's), and ``spec_for``."""
    mesh = SPEC_MESHES[mesh_name]()
    cfg = get_config(name)
    jshapes, tshapes = _shapes(name)
    assert [tuple(t.shape) for t in tree_leaves(tshapes)] == \
        [tuple(s.shape) for s in jax.tree.leaves(jshapes)]
    assert all(t.device.type == "meta" for t in tree_leaves(tshapes))
    for fsdp in (True, False):
        for fallback in ("replicate", "head_dim"):
            want = _ref_specs(jsharding.param_specs(jshapes, mesh, fsdp=fsdp,
                                                    attn_fallback=fallback))
            got = _port_specs(tsharding.param_specs(tshapes, mesh, fsdp=fsdp,
                                                    attn_fallback=fallback))
            assert got == want, (fsdp, fallback)
    for shape_name, shape in INPUT_SHAPES.items():
        spec = dict(_inputs(name, shape_name))
        caches = spec.pop("caches", None)
        assert _port_specs(tsharding.batch_specs(_meta(spec), mesh)) == \
            _ref_specs(jsharding.batch_specs(spec, mesh)), shape_name
        if caches is None:
            continue
        tcaches = Model(cfg).init_cache(shape.global_batch, shape.seq_len, device="meta")
        assert [tuple(t.shape) for t in tree_leaves(tcaches)] == \
            [tuple(s.shape) for s in jax.tree.leaves(caches)]
        assert _port_specs(tsharding.cache_specs(tcaches, mesh, cfg)) == \
            _ref_specs(jsharding.cache_specs(caches, mesh, jget_config(name))), shape_name
    for seq_shard in (False, True):
        jctx = jhints._HintCtx(mesh, None, None, seq_shard)
        tctx = thints._HintCtx(mesh, None, None, seq_shard)
        for kind in ("btd", "btd_res", "btv"):
            for B, T in ((s.global_batch, s.seq_len) for s in INPUT_SHAPES.values()):
                for last in (cfg.d_model, cfg.padded_vocab, 7):
                    want = jctx.spec_for(kind, (B, T, last))
                    assert tuple(tctx.spec_for(kind, (B, T, last))) == tuple(want)
        assert tctx.spec_for("btd", (2, 3)) is jctx.spec_for("btd", (2, 3)) is None


def test_hints_and_exports_follow_the_reference():
    """``dist`` exports the reference's 14 names; ``hint`` returns its
    input, and under ``activation_hints`` resolves its spec (an unknown
    kind raises, as in the reference); the port's forward marks the
    reference's three cut points: the decoder's input, every superblock
    slot's residual and the logits."""
    assert tdist.__all__ == jdist.__all__ and len(tdist.__all__) == 14
    assert all(hasattr(tdist, n) for n in tdist.__all__)
    x = torch.zeros(4, 3, 8)
    assert thints.hint(x, "nonsense") is x
    mesh = _dm_mesh()
    with thints.activation_hints(mesh):
        assert thints.hint(x, "btv") is x
        with pytest.raises(ValueError, match="unknown hint kind"):
            thints.hint(x, "nonsense")
    with jhints.activation_hints(mesh):
        with pytest.raises(ValueError, match="unknown hint kind"):
            jhints.hint(jnp.zeros((4, 3, 8)), "nonsense")
    from repro_torch.models import transformer

    cfg = _f32(get_config("gemma3-27b-smoke"))
    params = Model(cfg).init(0, device="cpu")
    seen = []
    orig = transformer.hint

    def spy(v, kind):
        seen.append(kind)
        return orig(v, kind)

    transformer.hint = spy
    try:
        Model(cfg).prefill(params, {"tokens": torch.as_tensor(TOKENS)}, max_len=12)
    finally:
        transformer.hint = orig
    assert seen == ["btd"] + ["btd_res"] * cfg.num_layers + ["btv"]


# --------------------------------------------------------------------------
# the reference's distribution and mesh engine, one subprocess
# --------------------------------------------------------------------------

_REFERENCE = r'''
import dataclasses
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.dist.sharding import param_specs
from repro.models import Model
from repro.serve.engine import Engine, distribute_weights
from repro.train import checkpoint as ck

def mk(shape, names, devices):
    return jax.make_mesh(shape, names, axis_types=(jax.sharding.AxisType.Auto,) * len(names),
                         devices=devices)

out = {}
m = Model(get_config(ARCH))
params = ck.restore_checkpoint(CKPT, 0, m.param_shapes())
mesh = mk((2, 2, 2), ("pod", "data", "model"), jax.devices()[:8])
specs = param_specs(m.param_shapes(), mesh, fsdp=False, attn_fallback="head_dim")
res = distribute_weights(params, mesh, specs=specs)
for i, leaf in enumerate(jax.tree.leaves(res)):
    for shard in leaf.addressable_shards:
        (coord,) = np.argwhere(mesh.devices == shard.device)
        rank = int(np.ravel_multi_index(tuple(coord), mesh.devices.shape))
        data = np.asarray(shard.data)
        out[f"dist{i}_{rank}"] = data.view(np.uint16) if data.dtype.itemsize == 2 else data

mesh4 = mk((2, 2), ("data", "model"), jax.devices()[:4])
for arch in ENGINE_ARCHS:
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    batch = {"tokens": jnp.asarray(TOKENS)}
    params = Model(cfg).init(jax.random.PRNGKey(0))
    single = Engine(cfg, params).generate(batch, steps=STEPS)
    meshed = Engine(cfg, params, mesh=mesh4, distribute=True).generate(batch, steps=STEPS)
    for tag, r in (("single", single), ("mesh", meshed)):
        out[f"{arch}_{tag}_tokens"] = r.tokens
        out[f"{arch}_{tag}_logprobs"] = r.logprobs
np.savez(PATH, **out)
print("PASS")
'''


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """The reference's minitron-8b-smoke (bf16) saved as its own npz
    checkpoint at step 0."""
    d = str(tmp_path_factory.mktemp("tp_ckpt"))
    jckpt.save_checkpoint(d, 0, JModel(jget_config(ARCH)).init(jax.random.PRNGKey(0)))
    return d


@pytest.fixture(scope="module")
def reference(dist, checkpoint, tmp_path_factory):
    path = tmp_path_factory.mktemp("tp_reference") / "reference.npz"
    code = (f"ARCH = {ARCH!r}\nCKPT = {checkpoint!r}\nENGINE_ARCHS = {ENGINE_ARCHS!r}\n"
            f"TOKENS = np.array({TOKENS.tolist()!r})\nSTEPS = {STEPS}\n"
            f"PATH = {str(path)!r}\n")
    dist("import numpy as np\n" + code + _REFERENCE, devices=8, timeout=300,
         env={"OMP_NUM_THREADS": "1"})
    return dict(np.load(path))


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 \
        else t.numpy()


def _restored(ckpt: str):
    like = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype),
                    Model(get_config(ARCH)).param_shapes())
    return tckpt.restore_checkpoint(ckpt, 0, like)


@pytest.mark.parametrize("stage", [False, True], ids=["compiled", "staged"])
def test_distribute_weights_specs_matches_reference_shards(reference, checkpoint, stage):
    """(2, 2, 2) ('pod', 'data', 'model'): the rows of data coordinate 0
    hold the restored weights; after the broadcast along ('pod', 'data')
    and the cut, each rank's row is bit-equal to the reference's shard on
    the device at the same mesh coordinate, and the plans are the
    reference's ``plan_distribution`` of the full tree (v5e constants in
    both), one per (bucket, data level)."""
    mesh = SPEC_MESHES["pod_data_model"]()
    params = _restored(checkpoint)
    specs = tsharding.param_specs(Model(get_config(ARCH)).param_shapes(), mesh, fsdp=False,
                                  attn_fallback="head_dim")
    roots = rank_rows(mesh)[0]
    assert list(roots) == [0, 1]
    stacked = replicate(params, mesh.size, fill_root_only=True, roots=roots)
    for leaf in tree_leaves(stacked):
        leaf[2:] = float("nan")  # what the broadcast must overwrite
    out, plans = distribute_weights(
        stacked, mesh, specs=specs, return_plans=True, double_buffer=stage, compiled=not stage,
        tuner=TTuner(tcm.Hardware(**dataclasses.asdict(jcm.TPU_V5E))))
    n_cut = 0
    for i, (leaf, spec) in enumerate(zip(tree_leaves(out), tree_leaves(specs, tsharding.is_spec),
                                         strict=True)):
        assert leaf.is_contiguous() and leaf.shape[0] == 8
        n_cut += "model" in spec
        for r in range(8):
            np.testing.assert_array_equal(_bits(leaf[r]), reference[f"dist{i}_{r}"],
                                          err_msg=f"leaf {i} rank {r}")
    assert n_cut > 0
    _spec, jplans = jengine.plan_distribution(
        JModel(jget_config(ARCH)).param_shapes(), mesh)
    assert list(plans) == list(jplans) == ["pod", "data"]
    for ax in plans:
        for p, q in zip(plans[ax], jplans[ax], strict=True):
            assert (p.algo, p.num_chunks, p.n, p.M, p.predicted_s, p.wire_bytes()) == \
                (q.algo, q.num_chunks, q.n, q.M, q.predicted_s, q.wire_bytes()), ax


def _jax_and_port_params(arch: str):
    jcfg = _f32(jget_config(arch))
    jparams = JModel(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, jparams, params_from_jax(jax.tree.map(np.asarray, jparams))


def _rank_caches(caches: dict, m: int) -> dict:
    """Model rank ``m``'s caches from the tensor-parallel forward's, whose
    every block holds a list of the ranks' caches, in the unsharded cache
    structure."""
    blocks = caches["blocks"]
    return {"blocks": None if blocks is None else [slot[m] for slot in blocks],
            "tail": [t[m] for t in caches["tail"]]}


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_engine_on_data_model_mesh_matches_reference(reference, arch, monkeypatch):
    """``Engine`` on (2, 2) ('data', 'model'), ``distribute=True``: every
    leaf its rank's ``param_specs`` block of the loaded weights; no
    attention, MLP or embedding call during generation sees more than a
    rank's block; the tokens equal the reference's mesh run and its
    single-layout run, the log-probs within 1e-4 of its mesh run's; each
    model rank's prefill caches are its ``cache_specs`` block of the
    reference's (the config's bf16 cache: within one bf16 step of it, 2^-7
    relative, where the keys and values of two f32 computations round to
    neighbouring bf16 values)."""
    jcfg, jparams, tparams = _jax_and_port_params(arch)
    cfg = _f32(get_config(arch))
    mesh = _dm_mesh()
    engine = Engine(cfg, tree_map(torch.clone, tparams), mesh=mesh, distribute=True,
                    device="cpu")
    specs = tsharding.param_specs(Model(cfg).param_shapes(), mesh, fsdp=False,
                                  attn_fallback="head_dim")
    for leaf, full, spec in zip(tree_leaves(engine.params), tree_leaves(tparams),
                                tree_leaves(specs, tsharding.is_spec), strict=True):
        for r in range(4):
            assert torch.equal(leaf[r], full[tsharding.shard_slices(spec, full.shape, mesh, r)])

    H, KV, F, V = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff, cfg.padded_vocab
    seen = []
    attention, mlp, unembed = tp_lib.attention, tp_lib.mlp, tp_lib.unembed

    def spy(fn, key, dim, want):
        def wrapped(p, *a, **kw):
            seen.append(p[key].shape[dim] == want)
            return fn(p, *a, **kw)
        return wrapped

    monkeypatch.setattr(tp_lib, "attention", spy(attention, "wk", -2, KV // 2))
    monkeypatch.setattr(tp_lib, "mlp", spy(mlp, "w_up", -1, F // 2))
    monkeypatch.setattr(tp_lib, "unembed", spy(unembed, "tokens", 0, V // 2))
    got = engine.generate({"tokens": TOKENS}, steps=STEPS)
    assert seen and all(seen)
    np.testing.assert_array_equal(got.tokens, reference[f"{arch}_mesh_tokens"])
    np.testing.assert_array_equal(got.tokens, reference[f"{arch}_single_tokens"])
    np.testing.assert_allclose(got.logprobs, reference[f"{arch}_mesh_logprobs"], atol=1e-4,
                               rtol=1e-4)

    # the caches: data rank 0's model ranks against the reference's prefill
    _, jcaches = JModel(jcfg).prefill(jparams, {"tokens": jnp.asarray(TOKENS)},
                                      max_len=TOKENS.shape[1] + STEPS)
    full = params_from_jax(jax.tree.map(np.asarray, jcaches))
    cspecs = tsharding.cache_specs(full, mesh, cfg)
    _, caches = engine.prefill(engine.replica(0), {"tokens": torch.as_tensor(TOKENS[:2])},
                               max_len=TOKENS.shape[1] + STEPS)
    for m in range(2):
        mine = tree_leaves(_rank_caches(caches, m))
        for c, f, spec in zip(mine, tree_leaves(full), tree_leaves(cspecs, tsharding.is_spec),
                              strict=True):
            want = f[tsharding.shard_slices(spec, f.shape, mesh, m)]
            assert c.shape == want.shape and c.dtype == want.dtype
            np.testing.assert_allclose(c.float().numpy(), want.float().numpy(), atol=1e-5,
                                       rtol=2**-7)


def test_model_axis_of_one_rank_is_the_data_parallel_engine():
    """(4, 1) ('data', 'model'): the replicas, tokens and log-probs are
    bit-identical to the one-axis engine's on 4 ranks."""
    cfg = _f32(get_config(ARCH))
    params = Model(cfg).init(0, device="cpu")
    runs = []
    for mesh in (tmesh.make_local_mesh(1, n=4, device="cpu"), tmesh.make_mesh(4, device="cpu")):
        engine = Engine(cfg, tree_map(torch.clone, params), mesh=mesh, distribute=True,
                        device="cpu")
        runs.append((engine.params, engine.generate({"tokens": TOKENS}, steps=STEPS)))
    (pa, a), (pb, b) = runs
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(pa), tree_leaves(pb)))
    np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(a.logprobs, b.logprobs)


def _tp_covers(name: str) -> bool:
    """A dense decoder over text (the other families' one-rank forward is
    held by tests/test_torch_tp_families.py)."""
    cfg = get_config(name)
    return (cfg.arch_type == "decoder" and cfg.frontend is None
            and set(cfg.layer_kinds()) == {"attn"})


# every dense decoder family the tensor-parallel forward serves, at its
# smoke widths (the full configs' blocks carry the same flags: QKV bias,
# windows, norms, activation)
TP_FAMILIES = [n for n in NAMES if n.endswith("-smoke") and _tp_covers(n)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", TP_FAMILIES)
def test_tp_forward_on_one_model_rank_is_apply_lm(name, dtype):
    """The tensor-parallel forward on one model rank (its own embedding,
    block and unembedding) gives the unsharded model's bits: the prefill
    logits and caches, then decode steps past the smoke window of 64, so
    that gemma's ring caches wrap. Holds ``tensor_parallel._block`` to
    ``blocks.apply_block`` for every family it serves."""
    assert {"minitron-8b-smoke", "gemma3-27b-smoke", "qwen1.5-32b-smoke"} <= set(TP_FAMILIES)
    cfg = dataclasses.replace(get_config(name), dtype=dtype)
    model = Model(cfg)
    params = model.init(0, device="cpu")
    T, steps = 70, 3
    tokens = torch.as_tensor(np.random.RandomState(3).randint(0, cfg.vocab_size, (2, T)))

    def same(a, b):
        la, lb = tree_leaves(a), tree_leaves(b)
        assert len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))

    with torch.no_grad():
        want, wc = model.prefill(params, {"tokens": tokens}, max_len=T + steps)
        got, gc = tp_lib.apply_lm_tp([params], cfg, tokens=tokens, mode="prefill",
                                     max_len=T + steps)
        same(got, want)
        same(gc, wc)
        for s in range(steps):
            nxt = want[:, -1].argmax(-1, keepdim=True)
            want, wc = model.decode_step(params, nxt, wc, T + s)
            got, gc = tp_lib.apply_lm_tp([params], cfg, tokens=nxt, mode="decode", caches=gc,
                                         cur_pos=T + s)
            same(got, want)
            same(gc, wc)


# paligemma's one kv head, mixtral's experts and whisper's encoder serve on a
# model axis (tests/test_torch_tp_families.py), and so do hymba's and xlstm's
# mixers (tests/test_torch_tp_ssm.py): training them there stays refused
REMAINDER = {
    "hymba_25_heads": ("hymba-1.5b", "train"),
    "xlstm_ssm": ("xlstm-350m-smoke", "train"),
}


@pytest.mark.parametrize("case", REMAINDER)
def test_outside_the_slice_raises_naming_tensor_parallel_remainder(case):
    """What the tensor-parallel forward does not cover raises ``ValueError``
    naming the ROADMAP item: training the recurrent and hybrid families on
    a model axis (hymba-1.5b: its 25 heads and its Mamba; xlstm-350m-smoke:
    its mLSTM and sLSTM). A batch that does not divide the data ranks
    serves (tests/test_torch_tp_layouts.py)."""
    name, how = REMAINDER[case]
    cfg = _f32(get_config(name))
    assert how == "train"
    with pytest.raises(ValueError, match="Tensor-parallel remainder"):
        Trainer(cfg, RunConfig(), mesh=_dm_mesh(), device="cpu")


def test_training_on_a_model_axis_is_refused():
    """On a model axis of more than one rank the explicit sync modes and
    the degraded step stay pure data-parallel and are refused with the
    reference's reason; ``grad_allreduce`` trains there, the
    tensor-parallel forward runs in train mode (the one-axis model's
    logits on one model rank, and a dense model's aux exactly 0), and a
    family it does not cover in training (the SSM mixers) names
    "Tensor-parallel remainder"; a model axis of one rank trains every
    mode."""
    from repro_torch.comm.faults import MeshHealth

    cfg = _f32(get_config(ARCH))
    for mode in ("param_bcast", "tuned_allreduce", "overlap_allreduce", "compressed_allreduce"):
        with pytest.raises(ValueError, match="pure data-parallel"):
            Trainer(cfg, RunConfig(sync_mode=mode), mesh=_dm_mesh(), device="cpu")
    with pytest.raises(ValueError, match="pure data-parallel"):
        Trainer(cfg, RunConfig(), mesh=_dm_mesh(), device="cpu",
                health=MeshHealth(n=2, dead_ranks=(1,)))
    with pytest.raises(ValueError, match="pure data-parallel"):
        tmesh.refuse_model_axis(SPEC_MESHES["production"](), "param_bcast")
    hist = Trainer(cfg, RunConfig(total_steps=2, warmup_steps=0), mesh=_dm_mesh(),
                   device="cpu").train(batch=4, seq=8, steps=2, log_every=1)[2]
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    params = Model(cfg).init(0, device="cpu")
    tokens = torch.as_tensor(TOKENS)
    want = Model(cfg).forward(params, {"tokens": tokens})[0]
    got, aux = tp_lib.apply_lm_tp([params], cfg, tokens=tokens, mode="train")
    assert float(aux) == 0.0 and torch.equal(got, want)
    with pytest.raises(ValueError, match="Tensor-parallel remainder"):
        Trainer(_f32(get_config("xlstm-350m-smoke")), RunConfig(), mesh=_dm_mesh(),
                device="cpu")
    tmesh.refuse_model_axis(tmesh.make_local_mesh(1, n=4, device="cpu"), "the trainer")


# --------------------------------------------------------------------------
# the serving CLI
# --------------------------------------------------------------------------


def _token_lines(out: str) -> list[str]:
    return [ln.split(" (mean logprob")[0] for ln in out.splitlines() if ln.startswith("req")]


def test_serve_cli_prints_the_reference_tokens(checkpoint, capsys, monkeypatch):
    """On the reference's checkpoint and flags, the port's CLI prints the
    reference CLI's tokens (bf16, greedy)."""
    flags = ["--arch", ARCH, "--batch", "4", "--prompt-len", "8", "--steps", "6",
             "--ckpt-dir", checkpoint]
    monkeypatch.setattr(sys, "argv", ["serve"] + flags)
    jserve.main()
    want = capsys.readouterr().out
    tserve.main(flags + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert len(_token_lines(want)) == 4 and _token_lines(got) == _token_lines(want)
    assert f"restored step 0 from {checkpoint}" in got


def test_serve_cli_runs_without_a_checkpoint():
    """``python -m repro_torch.launch.serve --arch minitron-8b-smoke
    --device cpu`` (seeded init) exits 0."""
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH, "--device", "cpu",
         "--steps", "4"],
        capture_output=True, text=True, timeout=240,
        env={**os.environ, "PYTHONPATH": src, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "serving random-init weights" in proc.stdout and len(_token_lines(proc.stdout)) == 4
