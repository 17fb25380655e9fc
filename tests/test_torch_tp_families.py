"""Tensor-parallel serving of the MoE, vision-prefix and encoder-decoder
families on ('data', 'model') meshes: the port against the reference, on
the CPU.

One reference subprocess on 8 host devices computes every result once:
``Engine`` on (2, 2) ('data', 'model') with ``distribute=True``, in f32, at
the reference test's batch (``tests/test_dist_integration.py``), beside its
single-layout run, for mixtral-8x7b-, qwen3-moe-30b-a3b- and
moonshot-v1-16b-a3b-smoke (expert shards; moonshot's shared experts),
paligemma-3b-smoke (one kv head: ``attn_fallback``'s head-dim split and the
sequence-split cache), whisper-large-v3-smoke (the encoder and cross
attention, its QKV biases redrawn nonzero), minitron-8b-smoke with 5 query
and 1 kv heads (the query heads' head-dim split) and mixtral-8x7b-smoke with
3 experts (expert-FFN shards); and mixtral-8x7b-smoke on (2, 2, 2) ('pod',
'data', 'model').

Held per case: every parameter leaf its rank's ``param_specs`` block; no
attention, MLP, expert, router or embedding call sees more than its rank's
block (spied); tokens equal to the reference's mesh run and its
single-layout run, log-probs within 1e-4 of its mesh run; each model rank's
prefill caches their ``cache_specs`` block of the reference's. Besides: the
tensor-parallel forward on one model rank gives the one-axis model's bits
for each family, and the flash-decoding merge over the sequence-split cache
against ``_sdpa`` over the whole cache.
"""
from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import Model as JModel
from repro_torch.configs import get_config
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.dist import sharding as tsharding
from repro_torch.launch import mesh as tmesh
from repro_torch.models import Model
from repro_torch.models import moe as moe_lib
from repro_torch.models import tensor_parallel as tp_lib
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import AttnSpec, _sdpa, decode_shard
from repro_torch.serve import Engine

# one intra-op thread: the suite runs in several worker processes at once, and
# the spinning OpenMP threads of each would contend for the same cores
torch.set_num_threads(1)

# case id -> (config, overrides of its fields)
CASES = {
    "mixtral_moe": ("mixtral-8x7b-smoke", {}),
    "qwen3_moe": ("qwen3-moe-30b-a3b-smoke", {}),
    "moonshot_shared_experts": ("moonshot-v1-16b-a3b-smoke", {}),
    "paligemma_one_kv_head": ("paligemma-3b-smoke", {}),
    "whisper_encdec": ("whisper-large-v3-smoke", {}),
    "minitron_5_query_1_kv_heads": ("minitron-8b-smoke", {"num_heads": 5, "num_kv_heads": 1}),
    "mixtral_3_experts": ("mixtral-8x7b-smoke", {"num_experts": 3}),
}
TOKENS = np.random.RandomState(0).randint(0, 500, (4, 8))  # the reference test's batch
STEPS = 4

# every QKV bias redrawn nonzero (the configs draw them as zeros), the same
# code in the reference's subprocess and here
_BIASES = r'''
def nonzero_biases(params):
    rng = np.random.RandomState(7)

    def one(path, leaf):
        if getattr(path[-1], "key", None) in ("bq", "bk", "bv"):
            return jnp.asarray(0.1 * rng.randn(*leaf.shape), leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(one, params)
'''
exec(_BIASES)


def _embeds(cfg, batch: int = 4):
    """The stub patch or frame embeddings of the case (None for text)."""
    n = cfg.prefix_len if cfg.frontend == "vision" else cfg.frontend_len
    if not n:
        return None
    return np.random.RandomState(1).randn(batch, n, cfg.d_model).astype(np.float32)


def _cfgs(case: str):
    name, over = CASES[case]
    return (dataclasses.replace(jget_config(name), dtype="float32", **over),
            dataclasses.replace(get_config(name), dtype="float32", **over))


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
    batch = {"tokens": jnp.asarray(TOKENS)}
    n = cfg.prefix_len if cfg.frontend == "vision" else cfg.frontend_len
    if n:
        batch["embeds"] = jnp.asarray(
            np.random.RandomState(1).randn(4, n, cfg.d_model).astype(np.float32))
    params = nonzero_biases(Model(cfg).init(jax.random.PRNGKey(0)))
    runs = [("single", None), ("mesh", mk((2, 2), ("data", "model")))]
    if case == "mixtral_moe":
        runs.append(("pod", mk((2, 2, 2), ("pod", "data", "model"))))
    for tag, mesh in runs:
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
    path = tmp_path_factory.mktemp("tp_families") / "reference.npz"
    code = (f"CASES = {CASES!r}\nTOKENS = np.array({TOKENS.tolist()!r})\nSTEPS = {STEPS}\n"
            f"PATH = {str(path)!r}\n")
    dist("import numpy as np\nimport jax, jax.numpy as jnp\n" + _BIASES + code + _REFERENCE,
         devices=8, timeout=400, env={"OMP_NUM_THREADS": "1"})
    return dict(np.load(path))


def _params(jcfg):
    jparams = nonzero_biases(JModel(jcfg).init(jax.random.PRNGKey(0)))
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams))


def _batch(cfg, lo: int = 0, hi: int = 4) -> dict:
    batch = {"tokens": TOKENS[lo:hi]}
    emb = _embeds(cfg)
    if emb is not None:
        batch["embeds"] = emb[lo:hi]
    return batch


def _rank_caches(caches: dict, m: int) -> dict:
    """Model rank ``m``'s caches from the tensor-parallel forward's, whose
    every block holds a list of the ranks' caches, in the unsharded cache
    structure."""
    blocks = caches["blocks"]
    return {"blocks": None if blocks is None else [slot[m] for slot in blocks],
            "tail": [t[m] for t in caches["tail"]]}


def _spy_blocks(monkeypatch, cfg) -> list:
    """Spies on every call that reads a weight during generation: each
    records whether the weight it was handed is its rank's block (half of
    the dim the layout cuts on a model axis of 2)."""
    H, KV, hd, F, V, E = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff,
                          cfg.padded_vocab, cfg.num_experts)
    seen = []

    def spy(owner, name, check):
        fn = getattr(owner, name)

        def wrapped(*a, **kw):
            seen.append((name, check(*a)))
            return fn(*a, **kw)
        monkeypatch.setattr(owner, name, wrapped)

    heads = lambda w, n: w.shape[-2] == n // 2 or w.shape[-1] == hd // 2  # noqa: E731
    spy(tp_lib, "attention", lambda p, *a: heads(p["wq"], H) and heads(p["wk"], KV)
        and p["wo"].shape[-1] == cfg.d_model and (p["wo"].shape[0] == H // 2
                                                  or p["wo"].shape[1] == hd // 2))
    spy(tp_lib, "_qkv", lambda p, *a: heads(p["wq"], H) and p["wk"].shape[-1] == hd // 2)
    spy(tp_lib, "mlp", lambda p, *a: p["w_up"].shape[-1] == F // 2)
    spy(tp_lib, "unembed", lambda p, *a: p["tokens"].shape[0] == V // 2)
    spy(tp_lib, "_embed_shard", lambda t, *a: t.shape[0] == V // 2)
    spy(moe_lib, "_experts", lambda din, g, u, d: (u.shape[0] == E // 2 if E % 2 == 0
                                                   else u.shape[-1] == F // 2))
    spy(moe_lib, "_shared_out", lambda p, *a: p["shared"]["w_up"].shape[-1]
        == F * cfg.num_shared_experts // 2)
    spy(moe_lib, "router_logits", lambda p, *a: p["router"].shape[-1]
        == (E // 2 if E % 2 == 0 else E))
    return seen


@pytest.mark.parametrize("case", CASES)
def test_engine_serves_family_on_data_model_mesh(reference, case, monkeypatch):
    """``Engine`` on (2, 2) ('data', 'model'), ``distribute=True``: every
    leaf its rank's ``param_specs`` block of the loaded weights; no call
    that reads a weight during generation sees more than its rank's block;
    the tokens equal the reference's mesh run and its single-layout run,
    the log-probs within 1e-4 of its mesh run's; each model rank's prefill
    caches its ``cache_specs`` block of the reference's (the config's bf16
    cache: within one bf16 step of it, 2^-7 relative)."""
    jcfg, cfg = _cfgs(case)
    jparams, tparams = _params(jcfg)
    mesh = tmesh.make_mesh((2, 2), axis_names=("data", "model"), device="cpu")
    engine = Engine(cfg, tree_map(torch.clone, tparams), mesh=mesh, distribute=True,
                    device="cpu")
    specs = tsharding.param_specs(Model(cfg).param_shapes(), mesh, fsdp=False,
                                  attn_fallback="head_dim")
    for leaf, full, spec in zip(tree_leaves(engine.params), tree_leaves(tparams),
                                tree_leaves(specs, tsharding.is_spec), strict=True):
        for r in range(4):
            assert torch.equal(leaf[r], full[tsharding.shard_slices(spec, full.shape, mesh, r)])

    seen = _spy_blocks(monkeypatch, cfg)
    got = engine.generate(_batch(cfg), steps=STEPS)
    monkeypatch.undo()
    assert seen and all(ok for _, ok in seen), [name for name, ok in seen if not ok]
    want = {"mixtral_moe": {"_experts", "router_logits"},
            "moonshot_shared_experts": {"_shared_out"},
            "mixtral_3_experts": {"_experts"},
            "paligemma_one_kv_head": {"_qkv", "mlp"},
            "minitron_5_query_1_kv_heads": {"_qkv"},
            "whisper_encdec": {"attention", "mlp"}}.get(case, set())
    assert want | {"unembed", "_embed_shard"} <= {name for name, _ in seen}
    np.testing.assert_array_equal(got.tokens, reference[f"{case}_mesh_tokens"])
    np.testing.assert_array_equal(got.tokens, reference[f"{case}_single_tokens"])
    np.testing.assert_allclose(got.logprobs, reference[f"{case}_mesh_logprobs"], atol=1e-4,
                               rtol=1e-4)

    # the caches: data rank 0's model ranks against the reference's prefill
    jbatch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
    _, jcaches = JModel(jcfg).prefill(jparams, jbatch, max_len=TOKENS.shape[1] + STEPS)
    full = params_from_jax(jax.tree.map(np.asarray, jcaches))
    cspecs = tsharding.cache_specs(full, mesh, cfg)
    batch0 = {k: torch.as_tensor(v) for k, v in _batch(cfg, 0, 2).items()}
    with torch.no_grad():
        _, caches = engine.prefill(engine.replica(0), batch0, max_len=TOKENS.shape[1] + STEPS)
    split = False
    for m in range(2):
        mine = tree_leaves(_rank_caches(caches, m))
        for c, f, spec in zip(mine, tree_leaves(full), tree_leaves(cspecs, tsharding.is_spec),
                              strict=True):
            want = f[tsharding.shard_slices(spec, f.shape, mesh, m)]
            split |= c.ndim == 5 and c.shape[2] < f.shape[2]
            assert c.shape == want.shape and c.dtype == want.dtype
            np.testing.assert_allclose(c.float().numpy(), want.float().numpy(), atol=1e-5,
                                       rtol=2**-7)
    # the sequence-split cache wherever the kv heads do not divide
    assert split == (cfg.num_kv_heads % 2 == 1)


def test_engine_on_pod_data_model_mesh_matches_reference(reference):
    """mixtral-8x7b-smoke on (2, 2, 2) ('pod', 'data', 'model'),
    ``distribute=True``: tokens equal to the reference's run on that mesh
    and its single-layout run, log-probs within 1e-4."""
    jcfg, cfg = _cfgs("mixtral_moe")
    _, tparams = _params(jcfg)
    mesh = tmesh.make_mesh((2, 2, 2), device="cpu")
    got = Engine(cfg, tparams, mesh=mesh, distribute=True, device="cpu").generate(
        _batch(cfg), steps=STEPS)
    np.testing.assert_array_equal(got.tokens, reference["mixtral_moe_pod_tokens"])
    np.testing.assert_array_equal(got.tokens, reference["mixtral_moe_single_tokens"])
    np.testing.assert_allclose(got.logprobs, reference["mixtral_moe_pod_logprobs"], atol=1e-4,
                               rtol=1e-4)


# --------------------------------------------------------------------------
# one model rank: the one-axis model's bits
# --------------------------------------------------------------------------

ONE_RANK = ("mixtral-8x7b-smoke", "moonshot-v1-16b-a3b-smoke", "paligemma-3b-smoke",
            "whisper-large-v3-smoke", "xlstm-350m-smoke", "hymba-1.5b-smoke")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", ONE_RANK)
def test_tp_forward_on_one_model_rank_is_the_model(name, dtype):
    """The tensor-parallel forward on one model rank gives the one-axis
    model's bits, prefill logits and caches, then decode steps past
    mixtral's and hymba's smoke window of 64: holds the MoE,
    cross-attention, prefix-aware and recurrent TP block (mLSTM, sLSTM,
    hybrid attention beside Mamba) to ``blocks.apply_block``."""
    cfg = dataclasses.replace(get_config(name), dtype=dtype)
    model = Model(cfg)
    params = model.init(0, device="cpu")
    T, steps = 64, 3
    batch = {"tokens": torch.as_tensor(np.random.RandomState(3).randint(0, cfg.vocab_size,
                                                                         (2, T)))}
    emb = _embeds(cfg, 2)
    if emb is not None:
        batch["embeds"] = torch.as_tensor(emb).to(getattr(torch, dtype))
    max_len = T + steps + (cfg.prefix_len if cfg.frontend == "vision" else 0)
    offset = cfg.prefix_len if cfg.frontend == "vision" else 0

    def same(a, b):
        la, lb = tree_leaves(a), tree_leaves(b)
        assert len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))

    with torch.no_grad():
        want, wc = model.prefill(params, batch, max_len=T + steps)
        got, gc = tp_lib.apply_lm_tp([params], cfg, tokens=batch["tokens"],
                                     embeds=batch.get("embeds"), mode="prefill", max_len=max_len)
        same(got, want)
        same(gc, wc)
        for s in range(steps):
            nxt = want[:, -1].argmax(-1, keepdim=True)
            want, wc = model.decode_step(params, nxt, wc, T + offset + s)
            got, gc = tp_lib.apply_lm_tp([params], cfg, tokens=nxt, mode="decode", caches=gc,
                                         cur_pos=T + offset + s)
            same(got, want)
            same(gc, wc)


def test_tp_block_rejects_what_it_does_not_serve():
    """The TP block names the ROADMAP item for a recurrent block in train
    mode (training the SSM mixers on a model axis), refuses the
    expert-parallel dispatch's ``mesh=``, and the serving check refuses
    heads whose count and width both do not divide."""
    cfg = get_config("xlstm-350m-smoke")
    with pytest.raises(ValueError, match="Tensor-parallel remainder"):
        tp_lib._block([{}], torch.zeros(1, 2, cfg.d_model), cfg, "mlstm", None, mode="train")
    cfg = get_config("mixtral-8x7b-smoke")
    with pytest.raises(ValueError, match="einsum dispatch"):
        tp_lib._block([{}], torch.zeros(1, 2, cfg.d_model), cfg, "moe", None, mode="prefill",
                      mesh=object())
    odd = dataclasses.replace(get_config("minitron-8b-smoke"), num_heads=3, num_kv_heads=1,
                              head_dim=33)
    with pytest.raises(ValueError, match="Tensor-parallel remainder"):
        tp_lib.check_tensor_parallel(odd, 2, mode="serve")
    tp_lib.check_tensor_parallel(get_config("paligemma-3b"), 16, mode="serve")
    for m in (2, 4, 8):  # whisper's 20 heads of 64 over 8 ranks: the head-width split
        tp_lib.check_tensor_parallel(get_config("whisper-large-v3"), m, mode="serve")


# --------------------------------------------------------------------------
# the flash-decoding merge
# --------------------------------------------------------------------------


def _decode_case(S: int, filled: int, dtype, seed: int = 0):
    """One decode query (B 2, 4 query heads over 1 kv head of 32: the kv
    heads do not divide 2 model ranks, so ``cache_specs`` cuts the
    sequence) and a full-width cache of S slots whose first ``filled`` hold
    keys."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((2, 1, 4, 32), generator=g).to(dtype)
    cache = {"k": torch.randn((2, S, 1, 32), generator=g).to(dtype),
             "v": torch.randn((2, S, 1, 32), generator=g).to(dtype),
             "pos": torch.where(torch.arange(S) < filled, torch.arange(S), -1).to(torch.int32)}
    return q, cache, cache["pos"] >= 0


@pytest.mark.parametrize("S", [12, 11], ids=["even_split", "odd_replicated"])
def test_merge_matches_softmax_over_the_whole_cache(S):
    """The sequence-split decode (``_cut_cache``: two shards when S divides,
    else the whole cache on each rank) against ``_sdpa`` over the whole
    cache, f32, within 1e-6."""
    q, cache, valid = _decode_case(S, 9, torch.float32)
    shards = tp_lib._cut_cache(cache, 2)
    assert [c["k"].shape[1] for c in shards] == ([6, 6] if S == 12 else [11, 11])
    got = tp_lib._decode_over_shards(q, shards, valid)
    want = _sdpa(q, cache["k"], cache["v"], valid[None, None, :], AttnSpec(4, 1, 32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=1e-6)


def test_merge_with_an_empty_shard_adds_nothing():
    """Rank 1 of a T = 2, S = 8 cache holds no valid slot: its lse is -inf,
    its output 0, nothing is NaN, and the merge is rank 0's shard exactly
    and the one-shard result over the whole cache within 1e-6."""
    q, cache, valid = _decode_case(8, 2, torch.float32)
    shards = tp_lib._cut_cache(cache, 2)
    parts = [decode_shard(q, c["k"], c["v"], valid[r * 4:(r + 1) * 4])
             for r, c in enumerate(shards)]
    o1, l1 = parts[1]
    assert torch.equal(o1, torch.zeros_like(o1)) and bool(torch.isneginf(l1).all())
    got = tp_lib.merge_shards(parts)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, parts[0][0])
    whole = decode_shard(q, cache["k"], cache["v"], valid)[0]
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=1e-6, rtol=1e-6)


def test_merge_in_bf16_within_one_rounding():
    """bf16 query and cache: the merge's f32 result, rounded to bf16, lies
    within one bf16 rounding (2^-8 relative, + 1e-6) of the one-shard f32
    result over the whole cache (the same bf16 score products)."""
    q, cache, valid = _decode_case(16, 13, torch.bfloat16, seed=1)
    got = tp_lib._decode_over_shards(q, tp_lib._cut_cache(cache, 2), valid).to(torch.bfloat16)
    want = decode_shard(q, cache["k"], cache["v"], valid)[0]
    err = (got.float() - want).abs()
    assert bool((err <= 2**-8 * want.abs() + 1e-6).all()), float(err.max())
    assert math.isfinite(float(err.max()))
