"""Tensor-parallel serving of the recurrent and hybrid families on ('data',
'model') meshes: xlstm-350m's mLSTM and sLSTM and hymba-1.5b's Mamba heads
beside its windowed attention, the port against the reference, on the CPU.

One reference subprocess on 8 host devices computes every result once, in
f32: ``Engine`` on (2, 2) ('data', 'model') with ``distribute=True`` beside
its single-layout run, for xlstm-350m-smoke, hymba-1.5b-smoke and
hymba-1.5b-smoke with 5 query and 1 kv heads (the head-dim split and the
sequence-split ring cache), each at the reference test's 4 x 8 batch and at
a 4 x 80 prompt (past the smoke chunk of 16 and the window of 64); the last
also on (2, 2, 2) ('pod', 'data', 'model'); and the single-device prefill
caches of every case.

Held per case: every parameter leaf its rank's ``param_specs`` block; no
mixer projection, attention, MLP, embedding or unembedding call sees more
than its rank's block, and no (di, N) ``a_log`` is assembled (spied);
tokens equal to the reference's mesh and single-layout runs, log-probs
within 1e-4 of its mesh run; each model rank's prefill states and attention
cache its ``cache_specs`` block of the reference's prefill caches, and after
each decode step its block of the one-axis port's caches. Besides: each TP
mixer on two model ranks against the one-axis mixer over a prefill and 4
decode steps (the mLSTM at a prompt whose normalizer changes sign, with a
check that summing the ranks' partials after the abs would miss), the
windowed ring cut over the model ranks after the ring has wrapped, and the
serving check's refusals.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import Model as JModel
from repro_torch.configs import RunConfig, get_config
from repro_torch.core.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from repro_torch.dist import sharding as tsharding
from repro_torch.launch import mesh as tmesh
from repro_torch.models import Model, ssm
from repro_torch.models import tensor_parallel as tp_lib
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import Engine
from repro_torch.train.trainer import Trainer

# one intra-op thread: the suite runs in several worker processes at once, and
# the spinning OpenMP threads of each would contend for the same cores
torch.set_num_threads(1)

# case id -> (config, overrides of its fields)
CASES = {
    "xlstm": ("xlstm-350m-smoke", {}),
    "hymba": ("hymba-1.5b-smoke", {}),
    "hymba_5_query_1_kv_heads": ("hymba-1.5b-smoke", {"num_heads": 5, "num_kv_heads": 1}),
}
PROMPTS = {
    "8": np.random.RandomState(0).randint(0, 500, (4, 8)),  # the reference test's batch
    "80": np.random.RandomState(1).randint(0, 500, (4, 80)),
}
POD = ("hymba_5_query_1_kv_heads", "80")
STEPS = 4

_REFERENCE = r'''
import dataclasses
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.models import Model
from repro.serve.engine import Engine

def mk(shape, names):
    n = int(np.prod(shape))
    return jax.make_mesh(shape, names, axis_types=(jax.sharding.AxisType.Auto,) * len(names),
                         devices=jax.devices()[:n])

out = {}
for case, (name, over) in CASES.items():
    cfg = dataclasses.replace(get_config(name), dtype="float32", **over)
    params = Model(cfg).init(jax.random.PRNGKey(0))
    for plen, tokens in PROMPTS.items():
        batch = {"tokens": jnp.asarray(tokens)}
        key = f"{case}_{plen}"
        _, caches = Model(cfg).prefill(params, batch, max_len=tokens.shape[1] + STEPS)
        for i, leaf in enumerate(jax.tree_util.tree_leaves(caches)):
            out[f"{key}_cache_{i}"] = np.asarray(leaf.astype(jnp.float32))
        runs = [("single", None), ("mesh", mk((2, 2), ("data", "model")))]
        if (case, plen) == POD:
            runs.append(("pod", mk((2, 2, 2), ("pod", "data", "model"))))
        for tag, mesh in runs:
            kw = {} if mesh is None else {"mesh": mesh, "distribute": True}
            # the distribution donates the weights it is handed: each run its own copy
            r = Engine(cfg, jax.tree.map(jnp.copy, params), **kw).generate(batch, steps=STEPS)
            out[f"{key}_{tag}_tokens"] = r.tokens
            out[f"{key}_{tag}_logprobs"] = r.logprobs
np.savez(PATH, **out)
print("PASS")
'''


@pytest.fixture(scope="module")
def reference(dist, tmp_path_factory):
    path = tmp_path_factory.mktemp("tp_ssm") / "reference.npz"
    prompts = {k: v.tolist() for k, v in PROMPTS.items()}
    code = (f"CASES = {CASES!r}\nPROMPTS = {{k: np.array(v) for k, v in {prompts!r}.items()}}\n"
            f"POD = {POD!r}\nSTEPS = {STEPS}\nPATH = {str(path)!r}\n")
    dist("import numpy as np\n" + code + _REFERENCE, devices=8, timeout=400,
         env={"OMP_NUM_THREADS": "1"})
    return dict(np.load(path))


def _cfgs(case: str):
    name, over = CASES[case]
    return (dataclasses.replace(jget_config(name), dtype="float32", **over),
            dataclasses.replace(get_config(name), dtype="float32", **over))


def _params(jcfg):
    return params_from_jax(jax.tree.map(np.asarray, JModel(jcfg).init(jax.random.PRNGKey(0))))


def _dm_mesh():
    return tmesh.make_mesh((2, 2), axis_names=("data", "model"), device="cpu")


def _rank_caches(caches: dict, m: int) -> dict:
    """Model rank ``m``'s caches from the tensor-parallel forward's, whose
    every block holds a list of the ranks' caches, in the unsharded cache
    structure."""
    blocks = caches["blocks"]
    return {"blocks": None if blocks is None else [slot[m] for slot in blocks],
            "tail": [t[m] for t in caches["tail"]]}


def _hold_blocks(caches, full_leaves, full_tree, mesh, cfg, *, atol: float) -> None:
    """Each model rank of data rank 0 holds its ``cache_specs`` block of the
    full caches ``full_leaves`` (in the flatten order of ``full_tree``): f32
    states within ``atol`` (and as much relative), the bf16 attention cache
    within one bf16 step."""
    specs = tree_leaves(tsharding.cache_specs(full_tree, mesh, cfg), tsharding.is_spec)
    for m in range(2):
        mine = tree_leaves(_rank_caches(caches, m))
        for c, f, spec in zip(mine, full_leaves, specs, strict=True):
            want = f[tsharding.shard_slices(spec, tuple(f.shape), mesh, m)]
            assert tuple(c.shape) == tuple(want.shape), (c.shape, want.shape)
            rtol = atol if c.dtype == torch.float32 else 2**-7
            np.testing.assert_allclose(c.float().numpy(), want.float().numpy(), atol=atol,
                                       rtol=rtol)


def _spy_blocks(monkeypatch, cfg) -> list:
    """Spies on every call that reads a weight during generation: each
    records whether the weights it was handed are its rank's blocks (half of
    the dim the layout cuts on a model axis of 2), and on every model-axis
    gather, whether it assembled a (di, N) ``a_log``."""
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

    heads = lambda w, n: w.shape[-2] == n // 2 or w.shape[-1] == hd // 2  # noqa: E731
    spy(tp_lib, "attention", lambda p, *a: heads(p["wq"], H) and heads(p["wk"], KV))
    spy(tp_lib, "_qkv", lambda p, *a: heads(p["wq"], H) and p["wk"].shape[-1] == hd // 2)
    spy(tp_lib, "mlp", lambda p, *a: p["w_up"].shape[-1] == F // 2)
    spy(tp_lib, "unembed", lambda p, *a: p["tokens"].shape[0] == V // 2)
    spy(tp_lib, "_embed_shard", lambda t, *a: t.shape[0] == V // 2)
    spy(tp_lib, "down_proj", lambda h, w: w.shape[-1] == d // 2)
    spy(tp_lib, "_mlstm_proj", lambda p, x: all(p[k].shape[-1] == di // 2
                                                for k in ("wq", "wk", "wv", "wg"))
        and p["wi"].shape[-1] == p["wf"].shape[-1] == H // 2)
    spy(tp_lib, "_slstm_in", lambda p, x: p["w"].shape[-1] == 2 * d)
    spy(tp_lib, "_slstm_rec", lambda p, h: p["r"].shape[-1] == 2 * d // H)
    spy(tp_lib, "_mamba_in", lambda p, x: p["w_in"].shape[-1] == di)
    spy(tp_lib, "_mamba_xproj", lambda p, xc: p["w_dt"].shape[-1] == di // 2
        and p["w_bc"].shape[-1] == N)
    spy(tp_lib, "_a_rows", lambda blocks, lo, hi: hi - lo == di // 2
        and all(tuple(b.shape) == (di, N // 2) for b in blocks))
    spy(ssm, "_mamba_conv", lambda p, xb, *a: p["conv"].shape[-1] == di // 2
        and xb.shape[-1] == di // 2)
    gather = tp_lib.model_axis_gather

    def no_whole_a(parts, dim):
        out = gather(parts, dim)
        seen.append(("model_axis_gather", not N or tuple(out.shape) != (di, N)))
        return out
    monkeypatch.setattr(tp_lib, "model_axis_gather", no_whole_a)
    return seen


@pytest.mark.parametrize("plen", PROMPTS)
@pytest.mark.parametrize("case", CASES)
def test_engine_serves_ssm_family_on_data_model_mesh(reference, case, plen, monkeypatch):
    """``Engine`` on (2, 2) ('data', 'model'), ``distribute=True``: every
    leaf its rank's ``param_specs`` block; no weight-reading call sees more
    than its rank's block, no (di, N) ``a_log`` is assembled; the tokens
    equal the reference's mesh and single-layout runs, the log-probs within
    1e-4 of its mesh run's; data rank 0's model ranks hold their
    ``cache_specs`` blocks of the reference's prefill caches (f32 states
    within 1e-5), and after each of 4 decode steps their blocks of the
    one-axis port's caches, fed the same tokens."""
    jcfg, cfg = _cfgs(case)
    tparams = _params(jcfg)
    tokens = PROMPTS[plen]
    key = f"{case}_{plen}"
    mesh = _dm_mesh()
    engine = Engine(cfg, tree_map(torch.clone, tparams), mesh=mesh, distribute=True,
                    device="cpu")
    specs = tsharding.param_specs(Model(cfg).param_shapes(), mesh, fsdp=False,
                                  attn_fallback="head_dim")
    for leaf, full, spec in zip(tree_leaves(engine.params), tree_leaves(tparams),
                                tree_leaves(specs, tsharding.is_spec), strict=True):
        for r in range(4):
            assert torch.equal(leaf[r], full[tsharding.shard_slices(spec, full.shape, mesh, r)])

    seen = _spy_blocks(monkeypatch, cfg)
    got = engine.generate({"tokens": tokens}, steps=STEPS)
    monkeypatch.undo()
    assert seen and all(ok for _, ok in seen), [name for name, ok in seen if not ok]
    want = ({"_mlstm_proj", "_slstm_in", "_slstm_rec"} if case == "xlstm" else
            {"_mamba_in", "_mamba_xproj", "_a_rows", "_mamba_conv", "mlp"})
    if case == "hymba":
        want |= {"attention"}
    elif case != "xlstm":
        want |= {"_qkv"}
    assert want | {"down_proj", "unembed", "_embed_shard"} <= {name for name, _ in seen}
    np.testing.assert_array_equal(got.tokens, reference[f"{key}_mesh_tokens"])
    np.testing.assert_array_equal(got.tokens, reference[f"{key}_single_tokens"])
    np.testing.assert_allclose(got.logprobs, reference[f"{key}_mesh_logprobs"], atol=1e-4,
                               rtol=1e-4)

    T = tokens.shape[1]
    batch0 = torch.as_tensor(tokens[:2])
    model = Model(cfg)
    with torch.no_grad():
        _, caches = engine.prefill(engine.replica(0), {"tokens": batch0}, max_len=T + STEPS)
        one, one_caches = model.prefill(tparams, {"tokens": batch0}, max_len=T + STEPS)
        # the reference's prefill of the whole batch, in the one-axis port's structure
        leaves, treedef = tree_flatten(one_caches)
        ref = [torch.as_tensor(reference[f"{key}_cache_{i}"]) for i in range(len(leaves))]
        assert f"{key}_cache_{len(leaves)}" not in reference
        _hold_blocks(caches, ref, tree_unflatten(treedef, ref), mesh, cfg, atol=1e-5)
        params = engine.replica(0)
        for s in range(STEPS):
            nxt = one[:, -1].argmax(-1, keepdim=True)
            one, one_caches = model.decode_step(tparams, nxt, one_caches, T + s)
            _, caches = engine.decode_step(params, nxt, caches, T + s)
            _hold_blocks(caches, tree_leaves(one_caches), one_caches, _one_data_mesh(), cfg,
                         atol=1e-5)


def _one_data_mesh():
    """A (1, 2) ('data', 'model') mesh: the cut of one data rank's caches."""
    return tmesh.make_mesh((1, 2), axis_names=("data", "model"), device="cpu")


def test_engine_on_pod_data_model_mesh_matches_reference(reference):
    """hymba-1.5b-smoke with 5 query and 1 kv heads on (2, 2, 2) ('pod',
    'data', 'model') at the 80-token prompt, ``distribute=True``: tokens
    equal to the reference's run on that mesh and its single-layout run,
    log-probs within 1e-4."""
    case, plen = POD
    jcfg, cfg = _cfgs(case)
    got = Engine(cfg, _params(jcfg), mesh=tmesh.make_mesh((2, 2, 2), device="cpu"),
                 distribute=True, device="cpu").generate({"tokens": PROMPTS[plen]},
                                                         steps=STEPS)
    np.testing.assert_array_equal(got.tokens, reference[f"{case}_{plen}_pod_tokens"])
    np.testing.assert_array_equal(got.tokens, reference[f"{case}_{plen}_single_tokens"])
    np.testing.assert_allclose(got.logprobs, reference[f"{case}_{plen}_pod_logprobs"],
                               atol=1e-4, rtol=1e-4)


# --------------------------------------------------------------------------
# each mixer on two model ranks against the one-axis mixer
# --------------------------------------------------------------------------

MIXERS = {  # kind -> (config, the one-axis seq and step, the state keys)
    "mlstm": ("xlstm-350m-smoke", ssm.mlstm_seq, ssm.mlstm_step, ("C", "n")),
    "slstm": ("xlstm-350m-smoke", ssm.slstm_seq, ssm.slstm_step, ("c", "n", "h")),
    "hybrid": ("hymba-1.5b-smoke", ssm.mamba_seq, ssm.mamba_step, ("h", "conv")),
}


def _mixer_case(kind: str, seed: int = 0, T: int = 40):
    """One layer's mixer of ``kind`` (f32, seeded), its two model ranks'
    ``param_specs`` blocks of it, and a (2, T) input."""
    name, *_ = MIXERS[kind]
    cfg = dataclasses.replace(get_config(name), dtype="float32")
    model = Model(cfg)
    params = model.init(seed, device="cpu")
    mesh = _one_data_mesh()
    specs = tsharding.param_specs(model.param_shapes(), mesh, fsdp=False,
                                  attn_fallback="head_dim")
    stacked = tsharding.shard_stacked(params, specs, mesh)
    slot = cfg.block_pattern.index(kind)
    pick = lambda tree: tree_map(lambda t: t[0], tree["decoder"]["blocks"][slot])  # noqa: E731
    ps = [pick(tree_map(lambda t, r=r: t[r], stacked))["ssm"] for r in range(2)]
    x = torch.randn((2, T, cfg.d_model), generator=torch.Generator().manual_seed(seed + 1))
    return cfg, pick(params)["ssm"], ps, x


# the dim of each one-axis state that cache_specs cuts: mLSTM's key rows,
# sLSTM's slice of d, Mamba's channels
STATE_CUT = {"mlstm": {"C": 2, "n": 2}, "slstm": {"c": 1, "n": 1, "h": 1},
             "hybrid": {"h": 1, "conv": 2}}


def _state_cut(kind: str, key: str, t: torch.Tensor, m: int) -> torch.Tensor:
    """Model rank ``m``'s block of a one-axis state of ``kind``."""
    dim = STATE_CUT[kind][key]
    n = t.shape[dim] // 2
    return t.narrow(dim, m * n, n)


@pytest.mark.parametrize("kind", MIXERS)
def test_tp_mixer_matches_one_axis_mixer(kind):
    """The TP mixer on two model ranks against the one-axis mixer in f32: a
    40-token prefill (chunks of 16 and a tail of 8) and 4 decode steps, the
    outputs within 1e-5, each rank's state its block of the one-axis state
    within 1e-5 after every call, updated in place by decode."""
    cfg, p, ps, x = _mixer_case(kind)
    _, seq, step, keys = MIXERS[kind]
    fn = tp_lib._MIXERS[kind]
    with torch.no_grad():
        want, st = seq(p, x, cfg)
        got, states = fn([{"ssm": q} for q in ps], x, cfg, mode="prefill", caches=None)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
        caches = [{"ssm": s} for s in states]
        for i in range(5):
            for m, s in enumerate(states):
                for key, full in zip(keys, st):
                    np.testing.assert_allclose(s[key].numpy(),
                                               _state_cut(kind, key, full, m).numpy(),
                                               atol=1e-5, rtol=1e-5)
            if i == 4:
                break
            x1 = torch.randn((2, 1, cfg.d_model), generator=torch.Generator().manual_seed(9 + i))
            want, st = step(p, x1, st, cfg)
            held = [dict(c["ssm"]) for c in caches]
            got, states = fn([{"ssm": q} for q in ps], x1, cfg, mode="decode", caches=caches)
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
            assert all(states[m][k] is held[m][k] for m in range(2) for k in keys)


def test_mlstm_partials_are_summed_before_the_abs(monkeypatch):
    """At a prompt whose normalizer changes sign, and whose two ranks'
    partial normalizers take opposite signs: the TP mLSTM within 1e-5 of the
    one-axis mLSTM, where dividing by the sum of the partials' abs (the
    abs before the sum) lies more than 100x that tolerance away."""
    cfg, p, ps, x = _mixer_case("mlstm", seed=4, T=32)
    partials = []
    partial = ssm._mlstm_partial

    def record(*a):
        out = partial(*a)
        partials.append(out)
        return out
    monkeypatch.setattr(ssm, "_mlstm_partial", record)
    with torch.no_grad():
        want, _ = ssm.mlstm_seq(p, x, cfg)
        whole = partials[:2]  # the one-axis mixer's two chunks
        got, _ = tp_lib._mlstm_tp([{"ssm": q} for q in ps], x, cfg, mode="prefill", caches=None)
        ranks = partials[2:]  # per chunk, rank 0 then rank 1
    nq = torch.cat([q for _, q in whole], dim=-1)
    assert bool((nq > 0).any()) and bool((nq < 0).any())
    q0 = torch.cat([ranks[0][1], ranks[2][1]], dim=-1)
    q1 = torch.cat([ranks[1][1], ranks[3][1]], dim=-1)
    assert bool((q0 * q1 < 0).any())
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)

    # the same chunks, each partial's abs taken before the sum
    B, T, d = x.shape
    di = cfg.ssm_expand * d
    hs = torch.cat([((n0 + n1) / (torch.abs(a0)[..., None] + torch.abs(a1)[..., None] + 1.0))
                    for (n0, a0), (n1, a1) in (ranks[0:2], ranks[2:4])], dim=2)
    g = torch.sigmoid(x @ p["wg"])
    wrong = (g * hs.transpose(1, 2).reshape(B, T, di)) @ p["wo"]
    assert float((wrong - want).abs().max()) > 1e-3


# --------------------------------------------------------------------------
# the windowed ring over the model ranks, after it has wrapped
# --------------------------------------------------------------------------


def test_windowed_ring_cut_over_model_ranks_after_it_wraps():
    """hymba-1.5b-smoke with 5 query and 1 kv heads (the sequence-split
    cache) and an f32 cache: an 88-token prompt over its window of 64 (the
    ring wrapped at prefill: S = 64, slots 0-31 on rank 0, 32-63 on rank 1)
    and 12 decode steps at positions 88-99, slots 24-35, written into both
    ranks: the TP forward's logits within 1e-4 of the one-axis model's,
    each rank's ring (keys, values, positions) its half of the one-axis
    ring within 1e-5 after prefill and every step."""
    cfg = dataclasses.replace(get_config("hymba-1.5b-smoke"), dtype="float32",
                              kv_cache_dtype="float32", num_heads=5, num_kv_heads=1)
    model = Model(cfg)
    params = model.init(5, device="cpu")
    mesh = _one_data_mesh()
    specs = tsharding.param_specs(model.param_shapes(), mesh, fsdp=False,
                                  attn_fallback="head_dim")
    stacked = tsharding.shard_stacked(params, specs, mesh)
    shards = [tree_map(lambda t, r=r: t[r], stacked) for r in range(2)]
    T, steps = 88, 12
    tokens = torch.as_tensor(np.random.RandomState(6).randint(0, cfg.vocab_size, (2, T)))
    written = set()

    def hold(caches, one_caches):
        for m in range(2):
            for blk, whole in zip(_rank_caches(caches, m)["blocks"], one_caches["blocks"]):
                S = whole["attn"]["k"].shape[2]
                assert S == 64 and blk["attn"]["k"].shape[2] == S // 2
                for key in ("k", "v"):
                    np.testing.assert_allclose(
                        blk["attn"][key].numpy(),
                        whole["attn"][key][:, :, m * S // 2:(m + 1) * S // 2].numpy(),
                        atol=1e-5, rtol=1e-5)
                assert torch.equal(blk["attn"]["pos"], whole["attn"]["pos"])

    with torch.no_grad():
        want, wc = model.prefill(params, {"tokens": tokens}, max_len=T + steps)
        got, gc = tp_lib.apply_lm_tp(shards, cfg, tokens=tokens, mode="prefill",
                                     max_len=T + steps)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=1e-4)
        hold(gc, wc)
        for s in range(steps):
            nxt = want[:, -1].argmax(-1, keepdim=True)
            want, wc = model.decode_step(params, nxt, wc, T + s)
            got, gc = tp_lib.apply_lm_tp(shards, cfg, tokens=nxt, mode="decode", caches=gc,
                                         cur_pos=T + s)
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=1e-4)
            hold(gc, wc)
            written.add((T + s) % 64 // 32)
    assert written == {0, 1}


# --------------------------------------------------------------------------
# what the serving check admits and refuses
# --------------------------------------------------------------------------


def test_serving_check_admits_the_mixers_and_training_stays_refused():
    """Serving admits xlstm-350m (on 8: its 4 mLSTM heads cut on their key
    rows) and hymba-1.5b (its 25 / 5 heads through the head-dim split) on
    2, 4 and 8 model ranks; an mLSTM whose state
    ``cache_specs`` would cut off the key dim, a Mamba state whose N does
    not divide, and training either family on a model axis raise naming
    "Tensor-parallel remainder"."""
    for name in ("xlstm-350m", "hymba-1.5b", "xlstm-350m-smoke", "hymba-1.5b-smoke"):
        for m in (2, 4, 8):
            tp_lib.check_tensor_parallel(get_config(name), m, mode="serve")
        with pytest.raises(ValueError, match="Tensor-parallel remainder"):
            tp_lib.check_tensor_parallel(get_config(name), 2, mode="train")
    wide = dataclasses.replace(get_config("xlstm-350m-smoke"), num_heads=128, num_kv_heads=128)
    with pytest.raises(ValueError, match="mLSTM of 128 heads"):
        tp_lib.check_tensor_parallel(wide, 2, mode="serve")
    odd = dataclasses.replace(get_config("hymba-1.5b-smoke"), ssm_state=15)
    with pytest.raises(ValueError, match="Mamba of 512 channels and state 15"):
        tp_lib.check_tensor_parallel(odd, 2, mode="serve")
    with pytest.raises(ValueError, match="Tensor-parallel remainder"):
        Trainer(dataclasses.replace(get_config("hymba-1.5b-smoke"), dtype="float32"),
                RunConfig(), mesh=_dm_mesh(), device="cpu")
