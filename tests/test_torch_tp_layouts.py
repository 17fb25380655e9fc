"""Tensor-parallel serving in the reference's remaining serving layouts:
a batch that does not divide the data ranks (the caches' sequence on
'data'), and whisper-large-v3 and xlstm-350m on a model axis of 8, the
port against the reference, on the CPU.

One reference subprocess on 8 host devices computes every result once, in
f32: ``Engine`` with ``distribute=True`` on each case's mesh beside its
single-layout run, and the single-device prefill caches, for
minitron-8b-smoke with one and with three requests on (2, 2) ('data',
'model') (the caches' sequence on 'data', the kv heads on 'model'), with
one request of 63 tokens (67 slots: the cache whole on 'data'), with two
requests on (2, 2, 2) ('pod', 'data', 'model') (the batch on 'data' alone);
paligemma-3b-smoke (one kv head: the sequence on ('data', 'model')),
hymba-1.5b-smoke with 5 query and 1 kv heads (its windowed ring on ('data',
'model'), Mamba's state kept once) and whisper-large-v3-smoke, each with one
request on (2, 2); xlstm-350m-smoke (the mLSTM's 4 heads over 8 ranks) and
whisper-large-v3-smoke at 24 frames (the cross caches' frames on 'model')
and at 20 frames (the cross caches whole), each with two requests on (1,
8). Whisper's QKV biases are redrawn nonzero.

Held per case: every parameter leaf its rank's ``param_specs`` block; no
attention, projection, mixer, MLP or embedding call sees more than its
rank's block (spied); the replicated forward runs once a serving group (on
its model ranks, not again on each data rank: spied); tokens equal to the
reference's mesh and single-layout runs, log-probs within 1e-4 of its mesh
run; each (data, model) rank's prefill caches, cross caches and recurrent
states its ``cache_specs`` block of the reference's prefill caches, and
after each decode step its block of the one-axis port's caches. Besides:
the mLSTM and sLSTM on 8 model ranks against the one-axis mixer, the
serving check over every config at 2, 4 and 8 ranks and what it still
refuses, and a sequence that divides 'data' and 'model' apart but not
together, which both packages refuse.
"""
from __future__ import annotations

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import Model as JModel
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from repro_torch.dist import sharding as tsharding
from repro_torch.launch import mesh as tmesh
from repro_torch.models import Model, ssm
from repro_torch.models import tensor_parallel as tp_lib
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import Engine
from repro_torch.serve.engine import serving_groups

# one intra-op thread: the suite runs in several worker processes at once, and
# the spinning OpenMP threads of each would contend for the same cores
torch.set_num_threads(1)

# case id -> (config, overrides of its fields, mesh shape, requests, prompt
# tokens, serving groups)
CASES = {
    "minitron_one_request": ("minitron-8b-smoke", {}, (2, 2), 1, 64, 1),
    "minitron_three_requests": ("minitron-8b-smoke", {}, (2, 2), 3, 64, 1),
    "minitron_cache_whole_on_data": ("minitron-8b-smoke", {}, (2, 2), 1, 63, 1),
    "minitron_pod_batch_on_data": ("minitron-8b-smoke", {}, (2, 2, 2), 2, 64, 2),
    "paligemma_one_request": ("paligemma-3b-smoke", {}, (2, 2), 1, 64, 1),
    "hymba_5_1_heads_one_request": ("hymba-1.5b-smoke", {"num_heads": 5, "num_kv_heads": 1},
                                    (2, 2), 1, 80, 1),
    "whisper_one_request": ("whisper-large-v3-smoke", {}, (2, 2), 1, 8, 1),
    "xlstm_eight_ranks": ("xlstm-350m-smoke", {}, (1, 8), 2, 40, 1),
    "whisper_eight_ranks": ("whisper-large-v3-smoke", {"frontend_len": 24}, (1, 8), 2, 8, 1),
    "whisper_eight_ranks_cross_whole": ("whisper-large-v3-smoke", {"frontend_len": 20}, (1, 8),
                                        2, 8, 1),
}
STEPS = 4
NAMES = {2: ("data", "model"), 3: ("pod", "data", "model")}

# every QKV bias redrawn nonzero (the configs draw them as zeros), the same
# code in the reference's subprocess and here
_INPUTS = r'''
def nonzero_biases(params):
    rng = np.random.RandomState(7)

    def one(path, leaf):
        if getattr(path[-1], "key", None) in ("bq", "bk", "bv"):
            return jnp.asarray(0.1 * rng.randn(*leaf.shape), leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(one, params)


def case_batch(cfg, B, T, seed):
    """The case's tokens, and its stub patch or frame embeddings."""
    batch = {"tokens": np.random.RandomState(seed).randint(0, 500, (B, T))}
    n = cfg.prefix_len if cfg.frontend == "vision" else cfg.frontend_len
    if n:
        batch["embeds"] = np.random.RandomState(seed + 1).randn(B, n, cfg.d_model).astype(
            np.float32)
    return batch
'''
exec(_INPUTS)

_REFERENCE = r'''
import dataclasses
from repro.configs import get_config
from repro.models import Model
from repro.serve.engine import Engine

def mk(shape, names):
    n = int(np.prod(shape))
    return jax.make_mesh(shape, names, axis_types=(jax.sharding.AxisType.Auto,) * len(names),
                         devices=jax.devices()[:n])

out = {}
for i, (case, (name, over, shape, B, T, _groups)) in enumerate(CASES.items()):
    cfg = dataclasses.replace(get_config(name), dtype="float32", **over)
    params = nonzero_biases(Model(cfg).init(jax.random.PRNGKey(0)))
    batch = {k: jnp.asarray(v) for k, v in case_batch(cfg, B, T, i).items()}
    _, caches = jax.jit(lambda p, b: Model(cfg).prefill(p, b, max_len=T + STEPS))(params, batch)
    for j, leaf in enumerate(jax.tree_util.tree_leaves(caches)):
        out[f"{case}_cache_{j}"] = np.asarray(leaf.astype(jnp.float32))
    for tag, mesh in (("single", None), ("mesh", mk(shape, NAMES[len(shape)]))):
        kw = {} if mesh is None else {"mesh": mesh, "distribute": True}
        # the distribution donates the weights it is handed: each run its own copy
        r = Engine(cfg, jax.tree.map(jnp.copy, params), **kw).generate(batch, steps=STEPS)
        out[f"{case}_{tag}_tokens"] = r.tokens
        out[f"{case}_{tag}_logprobs"] = r.logprobs
np.savez(PATH, **out)
print("PASS")
'''


@pytest.fixture(scope="module")
def reference(dist, tmp_path_factory):
    path = tmp_path_factory.mktemp("tp_layouts") / "reference.npz"
    code = (f"CASES = {CASES!r}\nNAMES = {NAMES!r}\nSTEPS = {STEPS}\n"
            f"PATH = {str(path)!r}\n")
    dist("import numpy as np\nimport jax, jax.numpy as jnp\n" + _INPUTS + code + _REFERENCE,
         devices=8, timeout=400, env={"OMP_NUM_THREADS": "1"})
    return dict(np.load(path))


def _cfgs(case: str):
    name, over, *_ = CASES[case]
    return (dataclasses.replace(jget_config(name), dtype="float32", **over),
            dataclasses.replace(get_config(name), dtype="float32", **over))


def _params(jcfg):
    jparams = nonzero_biases(JModel(jcfg).init(jax.random.PRNGKey(0)))
    return params_from_jax(jax.tree.map(np.asarray, jparams))


def _rank_caches(caches: dict, i: int) -> dict:
    """Rank ``i`` of a serving group's caches (data-major), from the
    tensor-parallel forward's, whose every block holds a list of the group's
    ranks' caches, in the unsharded cache structure."""
    blocks = caches["blocks"]
    return {"blocks": None if blocks is None else [slot[i] for slot in blocks],
            "tail": [t[i] for t in caches["tail"]]}


def _hold_blocks(caches, group, full_leaves, full_tree, mesh, cfg) -> None:
    """Each rank of ``group`` holds its ``cache_specs`` block on the
    engine's ``mesh`` of the whole batch's caches ``full_leaves`` (in the
    flatten order of ``full_tree``): f32 states within 1e-5 (and as much
    relative), the bf16 attention caches within one bf16 step."""
    specs = tree_leaves(tsharding.cache_specs(full_tree, mesh, cfg), tsharding.is_spec)
    for i, row in enumerate(group.ranks.reshape(-1)):
        mine = tree_leaves(_rank_caches(caches, i))
        for c, f, spec in zip(mine, full_leaves, specs, strict=True):
            want = f[tsharding.shard_slices(spec, tuple(f.shape), mesh, int(row))]
            assert tuple(c.shape) == tuple(want.shape), (i, c.shape, want.shape, spec)
            rtol = 1e-5 if c.dtype == torch.float32 else 2**-7
            np.testing.assert_allclose(c.float().numpy(), want.float().numpy(), atol=1e-5,
                                       rtol=rtol)


def _spy_blocks(monkeypatch, cfg, M: int) -> list:
    """Spies on every call that reads a weight during generation: each
    records whether the weights it was handed are its rank's blocks on a
    model axis of ``M`` (the heads, or the head width where they do not
    divide; a width's M-th part elsewhere; the mLSTM's gates whole where
    ``param_specs`` replicates them)."""
    d, H, KV, hd, F, V = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                          cfg.d_ff, cfg.padded_vocab)
    di, N = cfg.ssm_expand * d, cfg.ssm_state
    seen = []

    def spy(owner, name, check):
        fn = getattr(owner, name)

        def wrapped(*a, **kw):
            seen.append((name, check(*a)))
            return fn(*a, **kw)
        monkeypatch.setattr(owner, name, wrapped)

    heads = lambda w, n: w.shape[-2] == n // M if n % M == 0 else w.shape[-1] == hd // M  # noqa: E731
    spy(tp_lib, "attention", lambda p, *a: heads(p["wq"], H) and heads(p["wk"], KV))
    spy(tp_lib, "_qkv", lambda p, *a: heads(p["wq"], H) and heads(p["wk"], KV)
        and heads(p["wv"], KV))
    spy(tp_lib, "_cross_proj", lambda p, x, name: heads(p["w" + name], H if name == "q" else KV))
    spy(tp_lib, "_out_proj", lambda o, w: w.shape[0] == H // M if H % M == 0
        else w.shape[1] == hd // M)
    spy(tp_lib, "mlp", lambda p, *a: p["w_up"].shape[-1] == F // M)
    spy(tp_lib, "unembed", lambda p, *a: p["tokens"].shape[0] == V // M)
    spy(tp_lib, "_embed_shard", lambda t, *a: t.shape[0] == V // M)
    spy(tp_lib, "down_proj", lambda h, w: w.shape[-1] == d // M)
    spy(tp_lib, "_mlstm_proj", lambda p, x: all(p[k].shape[-1] == di // M
                                                for k in ("wq", "wk", "wv", "wg")))
    spy(tp_lib, "_mlstm_gates", lambda p, x: p["wi"].shape[-1] == p["wf"].shape[-1]
        == (H // M if H % M == 0 else H))
    spy(tp_lib, "_slstm_in", lambda p, x: p["w"].shape[-1] == 4 * d // M)
    spy(tp_lib, "_slstm_rec", lambda p, h: p["r"].shape[-1] == 4 * d // H // M)
    spy(tp_lib, "_mamba_in", lambda p, x: p["w_in"].shape[-1] == 2 * di // M)
    spy(tp_lib, "_mamba_xproj", lambda p, xc: p["w_dt"].shape[-1] == di // M
        and p["w_bc"].shape[-1] == 2 * N // M)
    spy(tp_lib, "_a_rows", lambda blocks, lo, hi: hi - lo == di // M
        and all(tuple(b.shape) == (di, N // M) for b in blocks))
    spy(ssm, "_mamba_conv", lambda p, xb, *a: p["conv"].shape[-1] == di // M
        and xb.shape[-1] == di // M)
    return seen


# the calls each case must make besides the embedding and the unembedding
# (``_qkv`` on the heads: decode over the data ranks' slots of the sequence)
_HEADS_ON_DATA = {"attention", "_qkv", "mlp"}
_FALLBACK = {"_qkv", "_out_proj", "mlp"}
WANT = {
    "minitron_one_request": _HEADS_ON_DATA,
    "minitron_three_requests": _HEADS_ON_DATA,
    "minitron_cache_whole_on_data": {"attention", "mlp"},
    "minitron_pod_batch_on_data": {"attention", "mlp"},
    "paligemma_one_request": _FALLBACK,
    "hymba_5_1_heads_one_request": _FALLBACK | {"_mamba_in", "_mamba_xproj", "_a_rows",
                                                "_mamba_conv"},
    "whisper_one_request": _HEADS_ON_DATA | {"_cross_proj", "_out_proj"},
    "xlstm_eight_ranks": {"_mlstm_proj", "_mlstm_gates", "_slstm_in", "_slstm_rec",
                          "down_proj"},
    "whisper_eight_ranks": _FALLBACK | {"_cross_proj"},
    "whisper_eight_ranks_cross_whole": _FALLBACK | {"_cross_proj"},
}


@pytest.mark.parametrize("case", CASES)
def test_engine_serves_layout_as_the_reference(reference, case, monkeypatch):
    """``Engine`` with ``distribute=True`` on the case's mesh: every leaf its
    rank's ``param_specs`` block; no weight-reading call sees more than its
    rank's block; the replicated forward runs once a serving group (the
    embedding's M shards once a prefill and once a step); the tokens equal
    the reference's mesh and single-layout runs, the log-probs within 1e-4
    of its mesh run's; each rank of each serving group holds its
    ``cache_specs`` block on the engine's mesh of the reference's prefill
    caches, and after each of 4 decode steps its block of the one-axis
    port's caches, fed the same tokens."""
    jcfg, cfg = _cfgs(case)
    _, _, shape, B, T, n_groups = CASES[case]
    tparams = _params(jcfg)
    batch = case_batch(cfg, B, T, list(CASES).index(case))
    mesh = tmesh.make_mesh(shape, axis_names=NAMES[len(shape)], device="cpu")
    M = shape[-1]
    engine = Engine(cfg, tree_map(torch.clone, tparams), mesh=mesh, distribute=True,
                    device="cpu")
    specs = tsharding.param_specs(Model(cfg).param_shapes(), mesh, fsdp=False,
                                  attn_fallback="head_dim")
    for leaf, full, spec in zip(tree_leaves(engine.params), tree_leaves(tparams),
                                tree_leaves(specs, tsharding.is_spec), strict=True):
        for r in range(mesh.size):
            assert torch.equal(leaf[r], full[tsharding.shard_slices(spec, full.shape, mesh, r)])

    seen = _spy_blocks(monkeypatch, cfg, M)
    got = engine.generate(batch, steps=STEPS)
    monkeypatch.undo()
    assert seen and all(ok for _, ok in seen), [name for name, ok in seen if not ok]
    calls = collections.Counter(name for name, _ in seen)
    want = WANT[case] | {"unembed", "_embed_shard"}
    assert want <= set(calls), want - set(calls)
    groups = engine.groups(B)
    assert len(groups) == n_groups
    assert calls["_embed_shard"] == calls["unembed"] == n_groups * M * (1 + STEPS)
    if calls["_mlstm_proj"]:  # the replicated gates once a layer, the projections M times
        assert calls["_mlstm_gates"] * (M if cfg.num_heads % M else 1) == calls["_mlstm_proj"]
    np.testing.assert_array_equal(got.tokens, reference[f"{case}_mesh_tokens"])
    np.testing.assert_array_equal(got.tokens, reference[f"{case}_single_tokens"])
    np.testing.assert_allclose(got.logprobs, reference[f"{case}_mesh_logprobs"], atol=1e-4,
                               rtol=1e-4)

    model = Model(cfg)
    offset = cfg.prefix_len if cfg.frontend == "vision" else 0
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    with torch.no_grad():
        one, one_caches = model.prefill(tparams, tb, max_len=T + STEPS)
        leaves, treedef = tree_flatten(one_caches)
        ref = [torch.as_tensor(reference[f"{case}_cache_{i}"]) for i in range(len(leaves))]
        assert f"{case}_cache_{len(leaves)}" not in reference
        ref_tree = tree_unflatten(treedef, ref)
        served = []
        for g in groups:
            share = {k: v[g.lo:g.hi] for k, v in tb.items()}
            _, caches = engine.prefill(engine.shards(g.ranks[0]), share, max_len=T + STEPS,
                                       mesh=g.mesh)
            _hold_blocks(caches, g, ref, ref_tree, mesh, cfg)
            served.append(caches)
        for s in range(STEPS):
            nxt = one[:, -1].argmax(-1, keepdim=True)
            one, one_caches = model.decode_step(tparams, nxt, one_caches, T + offset + s)
            for g, caches in zip(groups, served):
                engine.decode_step(engine.shards(g.ranks[0]), nxt[g.lo:g.hi], caches,
                                   T + offset + s)
                _hold_blocks(caches, g, tree_leaves(one_caches), one_caches, mesh, cfg)


# --------------------------------------------------------------------------
# the layouts the cases reach, read from the port's own rules
# --------------------------------------------------------------------------

# case -> (attention cache's k spec entries, cross cache's k spec, recurrent state's spec)
LAYOUTS = {
    "minitron_one_request": ((None, "data", "model", None), None),
    "minitron_cache_whole_on_data": ((None, None, "model", None), None),
    "minitron_pod_batch_on_data": (("data", None, "model", None), None),
    "paligemma_one_request": ((None, ("data", "model"), None, None), None),
    "whisper_one_request": ((None, "data", "model", None), (None, "data", "model", None)),
    "whisper_eight_ranks": (("data", None, None, None), ("data", "model", None, None)),
    "whisper_eight_ranks_cross_whole": (("data", None, None, None), ("data", None, None, None)),
}


@pytest.mark.parametrize("case", LAYOUTS)
def test_serving_group_caches_follow_cache_specs(case):
    """The layouts the table of cases names, from the port's ``cache_specs``
    on the engine's mesh and the group's mesh: the sequence on 'data' for a
    batch on no data axis (alone, or joint with 'model' over one kv head),
    the cache whole on 'data' at 67 slots, the batch on 'data' alone on (2,
    2, 2), whisper's cross caches' frames on 'data', on 'model' or whole;
    the group mesh's rule gives every group rank the block the engine's
    mesh gives its row."""
    _, cfg = _cfgs(case)
    _, _, shape, B, T, _ = CASES[case]
    mesh = tmesh.make_mesh(shape, axis_names=NAMES[len(shape)], device="meta")
    caches = Model(cfg).init_cache(B, T + STEPS + (cfg.prefix_len if cfg.frontend == "vision"
                                                   else 0), device="meta")
    specs = tsharding.cache_specs(caches, mesh, cfg)
    blk = specs["blocks"][0]
    want_self, want_cross = LAYOUTS[case]
    assert tuple(blk["attn"]["k"])[1:] == want_self
    if want_cross is not None:
        assert tuple(blk["cross"]["k"])[1:] == want_cross
    shape_k = tuple(caches["blocks"][0]["attn"]["k"].shape[1:])
    for g in serving_groups(mesh, B):
        share = (g.hi - g.lo,) + shape_k[1:]
        gspec = tsharding.cache_specs({"k": torch.empty(share, device="meta")}, g.mesh,
                                      cfg)["k"]
        for i, row in enumerate(g.ranks.reshape(-1)):
            mine = tsharding.shard_slices(gspec, share, g.mesh, i)
            full = tsharding.shard_slices(tuple(blk["attn"]["k"])[1:], shape_k, mesh, int(row))
            assert mine[1:] == full[1:] and full[0] == slice(g.lo, g.hi), (case, i, mine, full)


# --------------------------------------------------------------------------
# the mLSTM and the sLSTM on 8 model ranks
# --------------------------------------------------------------------------

STATE_CUT = {"mlstm": {"C": 2, "n": 2}, "slstm": {"c": 1, "n": 1, "h": 1}}
MIXERS = {"mlstm": (ssm.mlstm_seq, ssm.mlstm_step, ("C", "n")),
          "slstm": (ssm.slstm_seq, ssm.slstm_step, ("c", "n", "h"))}


@pytest.mark.parametrize("kind", MIXERS)
def test_tp_mixer_on_eight_ranks_matches_one_axis_mixer(kind, monkeypatch):
    """xlstm-350m-smoke's mLSTM (4 heads of 128: each rank's 64-column
    pieces of q and k half a head, its 16 key rows of every head taken
    across two ranks' pieces, the gates replicated and computed once) and
    sLSTM on 8 model ranks against the one-axis mixer in f32: a 40-token
    prefill and 4 decode steps, outputs within 1e-5, each rank's state its
    block of the one-axis state within 1e-5 after every call."""
    cfg = dataclasses.replace(get_config("xlstm-350m-smoke"), dtype="float32")
    model = Model(cfg)
    params = model.init(0, device="cpu")
    mesh = tmesh.make_mesh((1, 8), axis_names=("data", "model"), device="cpu")
    specs = tsharding.param_specs(model.param_shapes(), mesh, fsdp=False,
                                  attn_fallback="head_dim")
    stacked = tsharding.shard_stacked(params, specs, mesh)
    slot = cfg.block_pattern.index(kind)
    pick = lambda tree: tree_map(lambda t: t[0], tree["decoder"]["blocks"][slot])  # noqa: E731
    ps = [pick(tree_map(lambda t, r=r: t[r], stacked))["ssm"] for r in range(8)]
    p = pick(params)["ssm"]
    x = torch.randn((2, 40, cfg.d_model), generator=torch.Generator().manual_seed(1))
    seq, step, keys = MIXERS[kind]
    fn = tp_lib._MIXERS[kind]
    takes = []
    take = tp_lib.model_axis_take

    def record(parts, dim, spans, f=None):
        takes.append((parts[0].shape[dim], list(spans)))
        return take(parts, dim, spans, f)
    monkeypatch.setattr(tp_lib, "model_axis_take", record)
    with torch.no_grad():
        want, st = seq(p, x, cfg)
        got, states = fn([{"ssm": q} for q in ps], x, cfg, mode="prefill", caches=None)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
        caches = [{"ssm": s} for s in states]
        for i in range(5):
            for m, s in enumerate(states):
                for key, full in zip(keys, st):
                    dim = STATE_CUT[kind][key]
                    n = full.shape[dim] // 8
                    np.testing.assert_allclose(s[key].numpy(),
                                               full.narrow(dim, m * n, n).numpy(),
                                               atol=1e-5, rtol=1e-5)
            if i == 4:
                break
            x1 = torch.randn((2, 1, cfg.d_model), generator=torch.Generator().manual_seed(9 + i))
            want, st = step(p, x1, st, cfg)
            got, states = fn([{"ssm": q} for q in ps], x1, cfg, mode="decode", caches=caches)
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
    if kind == "mlstm":
        di, H = cfg.ssm_expand * cfg.d_model, cfg.num_heads
        hd = di // H
        assert H % 8 and {n for n, _ in takes} == {di // 8} and hd == 2 * (di // 8)
        # rank r's spans: its hd / 8 key rows of each head, 8 ranks x 2 (q, k) a call
        assert all(spans == [(h * hd + r * hd // 8, h * hd + (r + 1) * hd // 8)
                             for h in range(H)]
                   for j, (_, spans) in enumerate(takes[:16]) for r in [j % 8])


# --------------------------------------------------------------------------
# what the serving check admits and refuses
# --------------------------------------------------------------------------


@pytest.mark.parametrize("m", [2, 4, 8])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_serving_check_admits_every_config(name, m):
    """Every config of ``ARCHS`` serves on a model axis of 2, 4 and 8 ranks
    (a dense-GPU node's 8: whisper-large-v3's 20 heads and xlstm-350m's 4
    mLSTM heads through the head-width and key-row cuts)."""
    tp_lib.check_tensor_parallel(get_config(name), m, mode="serve")


REFUSED = {  # case -> (config, overrides, model ranks, what the reason names)
    "mlp_width": ("minitron-8b-smoke", {"d_ff": 510}, 4, "an MLP of width 510"),
    "padded_vocab": ("minitron-8b-smoke", {"vocab_pad_to": 2, "vocab_size": 998}, 4,
                     "a padded vocab of 998"),
    "wide_mlstm": ("xlstm-350m-smoke", {"num_heads": 128, "num_kv_heads": 128}, 2,
                   "an mLSTM of 128 heads"),
    "mamba_state_15": ("hymba-1.5b-smoke", {"ssm_state": 15}, 2,
                       "a Mamba of 512 channels and state 15"),
}


@pytest.mark.parametrize("case", REFUSED)
def test_what_stays_refused_names_the_remainder(case):
    """What still does not serve on a model axis raises ``ValueError``
    naming its reason and the ROADMAP item "Tensor-parallel remainder": an
    MLP width or a padded vocab that does not divide, an mLSTM whose state
    ``cache_specs`` cuts on its heads, a Mamba whose N does not divide."""
    name, over, m, why = REFUSED[case]
    cfg = dataclasses.replace(get_config(name), **over)
    with pytest.raises(ValueError, match="Tensor-parallel remainder") as err:
        tp_lib.check_tensor_parallel(cfg, m, mode="serve")
    assert why in str(err.value)


def test_uneven_joint_sequence_split_is_refused_as_the_reference_refuses_it():
    """paligemma-3b-smoke with one request of 70 tokens on (2, 2): its 90
    slots divide 'data' and 'model' apart, so ``cache_specs`` (the
    reference's rule) puts the sequence on both, and 90 does not divide 4:
    the port raises ``ValueError`` where the reference's ``device_put`` of
    the caches does."""
    cfg = dataclasses.replace(get_config("paligemma-3b-smoke"), dtype="float32")
    mesh = tmesh.make_mesh((2, 2), axis_names=("data", "model"), device="cpu")
    engine = Engine(cfg, Model(cfg).init(0, device="cpu"), mesh=mesh, device="cpu")
    batch = case_batch(cfg, 1, 70, 0)
    spec = tsharding.cache_specs({"k": torch.empty((1, 90, 1, 32), device="meta")}, mesh,
                                 cfg)["k"]
    assert tuple(spec) == (None, ("data", "model"), None, None)
    with pytest.raises(ValueError, match="does not divide"):
        engine.generate(batch, steps=STEPS)
