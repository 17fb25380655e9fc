"""The recurrent and hybrid families in the port against the reference, on
xlstm-350m-smoke (7 mLSTM : 1 sLSTM, two superblocks of 8) and
hymba-1.5b-smoke (attention of window 64 beside Mamba in every layer, two
superblocks of 1): the configs, the parameter tree carried over bit for
bit and the port's own ``init_lm`` tree, the train-mode logits and loss,
prefill then decode steps (the stacked recurrent states written back in
place), the decode-cache layout and ``Engine.generate`` on 1 and 4
emulated ranks, in f32; bf16 prefill logits; and one hybrid block at a
prompt past the lowered long-prompt threshold (the flash kernel's plain
version in the port, the block-scanned softmax in the reference)."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import Model as JModel
from repro.models import blocks as jb
from repro.models import layers as jl
from repro.serve.engine import Engine as JEngine
from repro_torch.configs import ARCHS
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import Model as TModel
from repro_torch.models import blocks as tb
from repro_torch.models import layers as tl
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import StackLayout
from repro_torch.serve import Engine as TEngine

# one intra-op thread: the suite runs in several worker processes at once, and
# the spinning OpenMP threads of each would contend for the same cores
torch.set_num_threads(1)

FAMILIES = ("xlstm-350m-smoke", "hymba-1.5b-smoke")
# 72 prompt tokens: past hymba-smoke's window of 64 (the ring wraps), and
# the smoke chunk of 16 does not divide it (chunks of 12)
T, STEPS = 72, 3
TOL = dict(atol=1e-4, rtol=1e-4)
F32 = {"dtype": "float32", "kv_cache_dtype": "float32"}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """One family's f32 configs, parameters (the reference's draw, carried
    over), tokens and the reference's results, computed once: train-mode
    logits and loss, prefill and ``STEPS`` greedy decode steps (logits and
    the final caches), and ``Engine.generate``."""
    arch = request.param
    jcfg = dataclasses.replace(j_get_config(arch), **F32)
    tcfg = dataclasses.replace(t_get_config(arch), **F32)
    jm = JModel(jcfg)
    jparams = jm.init(jax.random.PRNGKey(8))
    tparams = params_from_jax(_np(jparams))
    rng = np.random.RandomState(8)
    tokens = rng.randint(0, jcfg.vocab_size - 1, size=(4, T))
    labels = rng.randint(0, jcfg.vocab_size - 1, size=(4, T))
    batch = {"tokens": jnp.asarray(tokens, jnp.int32), "labels": jnp.asarray(labels, jnp.int32)}
    logits, loss = jax.jit(lambda p, b: (jm.forward(p, b)[0], jm.loss(p, b)[0]))(jparams, batch)
    prefill = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t}, max_len=T + STEPS))
    decode = jax.jit(jm.decode_step)
    lg, caches = prefill(jparams, batch["tokens"])
    steps, nxt = [np.asarray(lg)], np.asarray(jnp.argmax(lg[:, -1], -1))[:, None]
    feed = [nxt]
    for i in range(STEPS):
        lg, caches = decode(jparams, jnp.asarray(nxt, jnp.int32), caches,
                            jnp.asarray(T + i, jnp.int32))
        steps.append(np.asarray(lg))
        nxt = np.asarray(jnp.argmax(lg[:, 0], -1))[:, None]
        feed.append(nxt)
    gen = JEngine(jcfg, jparams).generate({"tokens": batch["tokens"]}, steps=STEPS)
    return dict(arch=arch, jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams,
                tokens=tokens, labels=labels, logits=np.asarray(logits), loss=float(loss),
                steps=steps, feed=feed, caches=_np(caches), generate=gen)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_configs_match_reference(name):
    """Every registered config, full and smoke: the fields, the parameter
    count (total and active) and sub-quadratic eligibility."""
    for n in (name, f"{name}-smoke"):
        j, t = j_get_config(n), t_get_config(n)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.param_count() == j.param_count()
        assert t.param_count(active_only=True) == j.param_count(active_only=True)
        assert t.sub_quadratic == j.sub_quadratic


def test_the_families_are_registered():
    assert {"xlstm-350m", "hymba-1.5b"} <= set(ARCHS)
    assert t_get_config("xlstm-350m").layer_kinds().count("slstm") == 3
    assert set(t_get_config("hymba-1.5b").layer_windows()) == {1024}


def test_params_cross_bit_for_bit(family):
    jparams, tparams = family["jparams"], family["tparams"]
    jleaves, tleaves = jax.tree_util.tree_leaves(jparams), tree_leaves(tparams)
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        assert tuple(a.shape) == tuple(b.shape) and str(b.dtype) == f"torch.{a.dtype}"
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_init_lm_tree_matches_reference(family, dtype):
    """The port's own draw has the reference's tree: keys, nesting, shapes,
    dtypes and flatten order (a hybrid block's 0-d ``mix_a``/``mix_m``
    stacked to one value a layer)."""
    jcfg = dataclasses.replace(family["jcfg"], dtype=dtype)
    tcfg = dataclasses.replace(family["tcfg"], dtype=dtype)
    want = jax.eval_shape(lambda: JModel(jcfg).init(jax.random.PRNGKey(0)))
    got = TModel(tcfg).init(0, device="cpu")
    got_np = tree_map(lambda t: np.zeros(t.shape, np.dtype(str(t.dtype)[6:])
                                         if t.dtype != torch.bfloat16 else jnp.bfloat16), got)
    assert jax.tree_util.tree_structure(got_np) == jax.tree_util.tree_structure(want)
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert tuple(g.shape) == w.shape and str(g.dtype) == f"torch.{w.dtype}"


def test_train_forward_and_loss_match(family):
    tm = TModel(family["tcfg"])
    batch = {"tokens": torch.from_numpy(family["tokens"]),
             "labels": torch.from_numpy(family["labels"])}
    with torch.no_grad():
        logits, aux = tm.forward(family["tparams"], batch)
        loss, _ = tm.loss(family["tparams"], batch)
    assert float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), family["logits"], **TOL)
    np.testing.assert_allclose(float(loss), family["loss"], **TOL)


def test_prefill_then_decode_match(family):
    """Prefill, then ``STEPS`` decode steps on the reference's tokens. Each
    superblock's states live in one stacked cache, which decode updates in
    place; with two superblocks, a state that a block returned but did
    not write back would leave the stack stale and the logits off."""
    tcfg = family["tcfg"]
    assert StackLayout(tcfg).num_super == 2 and StackLayout(tcfg).tail == 0
    tm = TModel(tcfg)
    with torch.no_grad():
        lg, caches = tm.prefill(family["tparams"], {"tokens": torch.from_numpy(family["tokens"])},
                                max_len=T + STEPS)
        np.testing.assert_allclose(lg.numpy(), family["steps"][0], **TOL)
        stacked = tree_leaves(caches)
        for i in range(STEPS):
            lg, caches = tm.decode_step(family["tparams"], torch.from_numpy(family["feed"][i]),
                                        caches, T + i)
            np.testing.assert_allclose(lg.numpy(), family["steps"][i + 1], **TOL)
    assert all(a is b for a, b in zip(tree_leaves(caches), stacked)), "decode replaced a cache"
    want = jax.tree_util.tree_leaves(family["caches"])
    got = tree_leaves(caches)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and str(g.dtype) == f"torch.{w.dtype}"
        np.testing.assert_allclose(g.numpy(), w, **TOL)


def test_decode_cache_layout_matches_reference(family):
    """``init_decode_cache`` against the reference's (keys, shapes, dtypes,
    zeros and the empty ring's -1 positions), and the prefill-built cache
    in the same layout."""
    want = JModel(family["jcfg"]).init_cache(3, 20)
    got = TModel(family["tcfg"]).init_cache(3, 20, device="cpu")
    wl, gl = jax.tree_util.tree_leaves(want), tree_leaves(got)
    assert jax.tree_util.tree_structure(tree_map(lambda t: t.numpy(), got)) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(wl, gl):
        assert str(b.dtype) == f"torch.{a.dtype}"
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # stacked slices share no memory: decode writes each row in place
    assert len({t.data_ptr() for t in gl}) == len(gl)
    with torch.no_grad():
        _lg, built = TModel(family["tcfg"]).prefill(
            family["tparams"], {"tokens": torch.from_numpy(family["tokens"][:3, :12])}, max_len=20)
    assert [tuple(t.shape) for t in tree_leaves(built)] == [a.shape for a in wl]


@pytest.mark.parametrize("ranks", [1, 4])
def test_generate_matches_reference(family, ranks):
    want = family["generate"]
    mesh = None if ranks == 1 else make_mesh(ranks, device="cpu")
    engine = TEngine(family["tcfg"], tree_map(torch.clone, family["tparams"]), mesh=mesh,
                     distribute=True, double_buffer=True, device="cpu")
    got = engine.generate({"tokens": family["tokens"]}, steps=STEPS)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.logprobs, want.logprobs, **TOL)
    assert got.prefill_len == want.prefill_len


def test_bf16_prefill_logits_close(family):
    """bf16 rounds at different places in XLA and in torch: besides 5e-2
    absolute, one bf16 step of the value (2^-7 relative), as
    tests/test_torch_serve.py holds the dense model."""
    jcfg, tcfg = j_get_config(family["arch"]), t_get_config(family["arch"])
    # the f32 draw rounded to the bf16 config's leaf dtypes
    shapes = jax.eval_shape(lambda: JModel(jcfg).init(jax.random.PRNGKey(0)))
    jparams = jax.tree.map(lambda a, s: a.astype(s.dtype), family["jparams"], shapes)
    tparams = params_from_jax(_np(jparams))
    tokens = np.random.RandomState(9).randint(0, jcfg.vocab_size - 1, size=(2, 24))
    want, _ = jax.jit(lambda p, t: JModel(jcfg).prefill(p, {"tokens": t}, max_len=24))(
        jparams, jnp.asarray(tokens, jnp.int32))
    with torch.no_grad():
        got, _ = TModel(tcfg).prefill(tparams, {"tokens": torch.from_numpy(tokens)}, max_len=24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-2, rtol=2**-7)


def test_hybrid_block_through_the_flash_route(monkeypatch):
    """One hymba-smoke block at 256 positions with the long-prompt threshold
    lowered to 128 in both packages' layer modules: the port's prefill
    takes ``flash_attention`` (its plain version on the CPU; window 64,
    tiles of 128), the reference's its block-scanned softmax; then decode
    steps on the prefill's cache."""
    monkeypatch.setattr(jl, "CHUNKED_ATTN_MIN_S", 128)
    monkeypatch.setattr(tl, "CHUNKED_ATTN_MIN_S", 128)
    from repro_torch.kernels import flash_attention as fa

    calls = []
    monkeypatch.setattr(fa, "flash_attention_plain",
                        lambda *a, _f=fa.flash_attention_plain, **k: calls.append(k) or _f(*a, **k))
    jcfg = dataclasses.replace(j_get_config("hymba-1.5b-smoke"), **F32)
    tcfg = dataclasses.replace(t_get_config("hymba-1.5b-smoke"), **F32)
    jp = jb.init_block(jax.random.PRNGKey(5), jcfg, "hybrid", 64, dtype=jnp.float32)
    tp = params_from_jax(_np(jp))
    S = 256
    x = np.random.RandomState(5).randn(2, S, jcfg.d_model).astype(np.float32)
    xs = np.random.RandomState(6).randn(2, 2, 1, jcfg.d_model).astype(np.float32)
    jrun = jax.jit(lambda p, x: jb.apply_block(p, x, jcfg, "hybrid", 64, mode="prefill",
                                               max_len=S + 2))
    jy, jc, _ = jrun(jp, jnp.asarray(x))
    ty, tc, _ = tb.apply_block(tp, torch.from_numpy(x), tcfg, "hybrid", 64, mode="prefill",
                               max_len=S + 2)
    assert calls and calls[0]["window"] == 64 and (calls[0]["bq"], calls[0]["bk"]) == (128, 128)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    jstep = jax.jit(lambda p, x, c, pos: jb.apply_block(p, x, jcfg, "hybrid", 64, mode="decode",
                                                        cache=c, cur_pos=pos))
    for i, x1 in enumerate(xs):
        jy, jc, _ = jstep(jp, jnp.asarray(x1), jc, jnp.asarray(S + i, jnp.int32))
        ty, tc, _ = tb.apply_block(tp, torch.from_numpy(x1), tcfg, "hybrid", 64, mode="decode",
                                   cache=tc, cur_pos=S + i)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for g, w in zip(tree_leaves(tc), jax.tree_util.tree_leaves(jc)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_unknown_kind_is_refused():
    cfg = t_get_config("xlstm-350m-smoke")
    with pytest.raises(ValueError, match="unknown block kind"):
        tb.init_block(torch.Generator(), cfg, "rwkv", None)
