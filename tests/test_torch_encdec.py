"""The encoder-decoder family in the port against the reference, on
whisper-large-v3-smoke in f32 (2 encoder and 2 decoder layers over 16 stub
frame embeddings, QKV biases): ``dense``, cross attention, the encoder
layout and the parameter tree, train-mode logits and loss, prefill then
decode steps (the cross keys and values read from the caches), the
decode-cache tree, ``Engine.generate`` on 1 and 4 emulated ranks, the
stub frames of ``batches``, and the registry's names. The reference draws
its QKV biases as zeros, so a port that dropped one would agree with it:
every bias here (self and cross attention, encoder and decoder) is drawn
anew from a numpy seed before both packages read the same tree."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_get_config
from repro.data import pipeline as jpipe
from repro.models import Model as JModel
from repro.models import layers as jl
from repro.models import transformer as jt
from repro.serve.engine import Engine as JEngine
from repro_torch.configs import ARCHS
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.data import pipeline as tpipe
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import Model as TModel
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tt
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import Engine as TEngine

# one intra-op thread: the suite runs in several worker processes at once, and
# the spinning OpenMP threads of each would contend for the same cores
torch.set_num_threads(1)

ARCH = "whisper-large-v3-smoke"
B, T, STEPS = 4, 12, 3
TOL = dict(atol=1e-4, rtol=1e-4)
F32 = {"dtype": "float32", "kv_cache_dtype": "float32"}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def with_biases(tree, seed: int):
    """The numpy tree with every ``bq``/``bk``/``bv`` leaf redrawn from a
    seeded normal (scale 0.5), in the leaf's dtype and shape."""
    rng = np.random.RandomState(seed)

    def draw(path, a):
        if getattr(path[-1], "key", None) in ("bq", "bk", "bv"):
            return (rng.randn(*a.shape) * 0.5).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(draw, tree)


@pytest.fixture(scope="module")
def whisper():
    """The f32 configs, the reference's parameters with seeded biases (in
    both packages), tokens, frames and the reference's results, computed
    once: train-mode logits and loss, prefill and ``STEPS`` greedy decode
    steps (logits and the final caches), and ``Engine.generate``."""
    jcfg = dataclasses.replace(j_get_config(ARCH), **F32)
    tcfg = dataclasses.replace(t_get_config(ARCH), **F32)
    jm = JModel(jcfg)
    np_params = with_biases(_np(jm.init(jax.random.PRNGKey(11))), 11)
    jparams = jax.tree.map(jnp.asarray, np_params)
    tparams = params_from_jax(np_params)
    rng = np.random.RandomState(11)
    tokens = rng.randint(0, jcfg.vocab_size - 1, size=(B, T))
    labels = rng.randint(0, jcfg.vocab_size - 1, size=(B, T))
    embeds = rng.randn(B, jcfg.frontend_len, jcfg.d_model).astype(np.float32)
    batch = {"tokens": jnp.asarray(tokens, jnp.int32), "labels": jnp.asarray(labels, jnp.int32),
             "embeds": jnp.asarray(embeds)}
    logits, loss = jax.jit(lambda p, b: (jm.forward(p, b)[0], jm.loss(p, b)[0]))(jparams, batch)
    prefill = jax.jit(lambda p, t, e: jm.prefill(p, {"tokens": t, "embeds": e},
                                                 max_len=T + STEPS))
    decode = jax.jit(jm.decode_step)
    lg, caches = prefill(jparams, batch["tokens"], batch["embeds"])
    prefill_caches = _np(caches)
    steps, nxt = [np.asarray(lg)], np.asarray(jnp.argmax(lg[:, -1], -1))[:, None]
    feed = [nxt]
    for i in range(STEPS):
        lg, caches = decode(jparams, jnp.asarray(nxt, jnp.int32), caches,
                            jnp.asarray(T + i, jnp.int32))
        steps.append(np.asarray(lg))
        nxt = np.asarray(jnp.argmax(lg[:, 0], -1))[:, None]
        feed.append(nxt)
    gen = JEngine(jcfg, jparams).generate({"tokens": batch["tokens"], "embeds": batch["embeds"]},
                                          steps=STEPS)
    return dict(jcfg=jcfg, tcfg=tcfg, np_params=np_params, tparams=tparams, tokens=tokens,
                labels=labels, embeds=embeds, logits=np.asarray(logits), loss=float(loss),
                steps=steps, feed=feed, prefill_caches=prefill_caches, caches=_np(caches),
                generate=gen)


def test_archs_are_the_references():
    """The registry has the reference's ten names (each config's fields and
    ``param_count`` are held in tests/test_torch_hybrid.py)."""
    assert set(ARCHS) == set(J_ARCHS)
    assert len(ARCHS) == 10


@pytest.mark.parametrize("bias", [False, True])
def test_dense_matches_reference(bias):
    """``init_dense``'s tree (keys, shapes, dtypes) and ``dense`` on the
    reference's parameters, a seeded nonzero bias in place of its zeros."""
    jp = _np(jl.init_dense(jax.random.PRNGKey(3), 48, 40, bias=bias, dtype=jnp.float32))
    tp = tl.init_dense(torch.Generator().manual_seed(3), 48, 40, bias=bias, dtype=torch.float32)
    assert sorted(tp) == sorted(jp)
    for key in jp:
        assert tuple(tp[key].shape) == jp[key].shape and tp[key].dtype == torch.float32
    if bias:
        jp["b"] = np.random.RandomState(3).randn(40).astype(np.float32)
    x = np.random.RandomState(4).randn(2, 5, 48).astype(np.float32)
    want = jl.dense(jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    got = tl.dense(params_from_jax(jp), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_cross_attention_matches_reference(mode):
    """``attention(cross_kv=)`` in every mode: the query's projection and
    its bias, every key seen, no rotation and no cache (k and v come with
    their biases from the caller)."""
    spec = jl.AttnSpec(num_heads=4, num_kv_heads=2, head_dim=16, qkv_bias=True)
    tspec = tl.AttnSpec(num_heads=4, num_kv_heads=2, head_dim=16, qkv_bias=True)
    jp = with_biases(_np(jl.init_attention(jax.random.PRNGKey(5), 64, spec, jnp.float32)), 5)
    rng = np.random.RandomState(5)
    x = rng.randn(2, 1 if mode == "decode" else 7, 64).astype(np.float32)
    k, v = (rng.randn(2, 9, 2, 16).astype(np.float32) for _ in range(2))
    want, wc = jl.attention(jax.tree.map(jnp.asarray, jp), jnp.asarray(x), spec, mode=mode,
                            cross_kv=(jnp.asarray(k), jnp.asarray(v)))
    got, gc = tl.attention(params_from_jax(jp), torch.from_numpy(x), tspec, mode=mode,
                           cross_kv=(torch.from_numpy(k), torch.from_numpy(v)))
    assert wc is None and gc is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_encoder_layout_matches_reference():
    for name in ("whisper-large-v3", ARCH):
        for encoder in (False, True):
            j = jt.StackLayout(j_get_config(name), encoder=encoder)
            t = tt.StackLayout(t_get_config(name), encoder=encoder)
            for attr in ("period", "num_layers", "num_super", "tail", "kinds", "windows"):
                assert getattr(t, attr) == getattr(j, attr), (name, encoder, attr)
    assert tt.StackLayout(t_get_config("whisper-large-v3"), encoder=True).num_super == 32


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_init_lm_tree_matches_reference(dtype):
    """The port's own draw has the reference's tree: ``encoder`` and
    ``enc_norm``, each decoder block's ``norm_x`` and ``cross`` with its
    biases, in the reference's flatten order, shapes and dtypes."""
    jcfg = dataclasses.replace(j_get_config(ARCH), dtype=dtype)
    tcfg = dataclasses.replace(t_get_config(ARCH), dtype=dtype)
    want = jax.eval_shape(lambda: JModel(jcfg).init(jax.random.PRNGKey(0)))
    got = TModel(tcfg).init(0, device="cpu")
    assert {"encoder", "enc_norm"} <= set(got)
    assert {"norm_x", "cross"} <= set(got["decoder"]["blocks"][0])
    assert {"bq", "bk", "bv"} <= set(got["decoder"]["blocks"][0]["cross"])
    assert "cross" not in got["encoder"]["blocks"][0]
    got_np = tree_map(lambda t: np.zeros(t.shape, np.float32), got)
    assert jax.tree_util.tree_structure(got_np) == jax.tree_util.tree_structure(want)
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert tuple(g.shape) == w.shape and str(g.dtype) == f"torch.{w.dtype}"


def test_params_cross_bit_for_bit(whisper):
    want = jax.tree_util.tree_leaves(whisper["np_params"])
    got = tree_leaves(whisper["tparams"])
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(a, b.numpy())
    cross = whisper["tparams"]["decoder"]["blocks"][0]["cross"]
    assert all(bool(cross[name].abs().min() > 0) for name in ("bq", "bk", "bv"))


def test_train_forward_and_loss_match(whisper):
    tm = TModel(whisper["tcfg"])
    batch = {"tokens": torch.from_numpy(whisper["tokens"]),
             "labels": torch.from_numpy(whisper["labels"]),
             "embeds": torch.from_numpy(whisper["embeds"])}
    with torch.no_grad():
        logits, aux = tm.forward(whisper["tparams"], batch)
        loss, _ = tm.loss(whisper["tparams"], batch)
    assert float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), whisper["logits"], **TOL)
    np.testing.assert_allclose(float(loss), whisper["loss"], **TOL)


def test_prefill_then_decode_match(whisper):
    """Prefill builds each decoder layer's self-attention cache and its
    cross keys and values (stacked over the layers); each decode step reads
    the cross entries and hands back the same tensors, with no copy."""
    tm = TModel(whisper["tcfg"])
    batch = {"tokens": torch.from_numpy(whisper["tokens"]),
             "embeds": torch.from_numpy(whisper["embeds"])}
    with torch.no_grad():
        lg, caches = tm.prefill(whisper["tparams"], batch, max_len=T + STEPS)
        np.testing.assert_allclose(lg.numpy(), whisper["steps"][0], **TOL)
        for g, w in zip(tree_leaves(caches), jax.tree_util.tree_leaves(whisper["prefill_caches"])):
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), w, **TOL)
        stacked = tree_leaves(caches)
        for i in range(STEPS):
            lg, caches = tm.decode_step(whisper["tparams"], torch.from_numpy(whisper["feed"][i]),
                                        caches, T + i)
            np.testing.assert_allclose(lg.numpy(), whisper["steps"][i + 1], **TOL)
    assert all(a is b for a, b in zip(tree_leaves(caches), stacked)), "decode replaced a cache"
    for g, w in zip(tree_leaves(caches), jax.tree_util.tree_leaves(whisper["caches"])):
        np.testing.assert_allclose(g.numpy(), w, **TOL)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_decode_cache_tree_matches_reference(dtype):
    """``init_decode_cache``: keys, shapes, dtypes and values of the
    reference's, the zero ``cross`` entries of ``frontend_len`` frames in
    the compute dtype included; and the prefill-built cache in that
    layout."""
    jcfg = dataclasses.replace(j_get_config(ARCH), dtype=dtype)
    tcfg = dataclasses.replace(t_get_config(ARCH), dtype=dtype)
    want = JModel(jcfg).init_cache(3, 20)
    got = TModel(tcfg).init_cache(3, 20, device="cpu")
    assert sorted(got["blocks"][0]) == ["attn", "cross"]
    assert jax.tree_util.tree_structure(tree_map(lambda t: t.numpy(), tree_map(
        lambda t: t.float(), got))) == jax.tree_util.tree_structure(want)
    wl, gl = jax.tree_util.tree_leaves(want), tree_leaves(got)
    for a, b in zip(wl, gl):
        assert tuple(b.shape) == a.shape and str(b.dtype) == f"torch.{a.dtype}"
        np.testing.assert_array_equal(np.asarray(a, np.float32), b.float().numpy())
    assert len({t.data_ptr() for t in gl}) == len(gl)
    tm = TModel(tcfg)
    params = tm.init(1, device="cpu")
    with torch.no_grad():
        _lg, built = tm.prefill(params, next(tpipe.batches(tpipe.make_source(tcfg), tcfg,
                                                           batch=3, seq=8)), max_len=20)
    assert [(tuple(t.shape), t.dtype) for t in tree_leaves(built)] == \
        [(tuple(t.shape), t.dtype) for t in gl]


def test_frames_are_required():
    tcfg = dataclasses.replace(t_get_config(ARCH), **F32)
    tm = TModel(tcfg)
    params = tm.init(0, device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="frame embeddings"):
        tm.forward(params, {"tokens": tokens})
    with pytest.raises(ValueError, match="frame embeddings"):
        tm.prefill(params, {"tokens": tokens}, max_len=8)


@pytest.mark.parametrize("ranks", [1, 4])
def test_generate_matches_reference(whisper, ranks):
    """The frames split over the ranks with the tokens; decode positions
    start after the text (audio shifts nothing). On 4 ranks the weights
    are distributed first, staged, with every whisper leaf bit-equal on
    every rank."""
    want = whisper["generate"]
    mesh = None if ranks == 1 else make_mesh(ranks, device="cpu")
    engine = TEngine(whisper["tcfg"], tree_map(torch.clone, whisper["tparams"]), mesh=mesh,
                     distribute=True, double_buffer=True, device="cpu")
    for leaf, root in zip(tree_leaves(engine.params), tree_leaves(whisper["tparams"])):
        assert torch.equal(leaf, root.expand_as(leaf))
    got = engine.generate({"tokens": whisper["tokens"], "embeds": whisper["embeds"]},
                          steps=STEPS)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.logprobs, want.logprobs, **TOL)
    assert got.prefill_len == want.prefill_len == T


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_batches_frames_match_reference(dtype):
    """The stub frames of ``batches``: (batch, frontend_len, d_model) in the
    config's dtype, the reference's bits, step after step."""
    jcfg = dataclasses.replace(j_get_config(ARCH), dtype=dtype)
    tcfg = dataclasses.replace(t_get_config(ARCH), dtype=dtype)
    jit = jpipe.batches(jpipe.make_source(jcfg, seed=3), jcfg, batch=2, seq=6)
    tit = tpipe.batches(tpipe.make_source(tcfg, seed=3), tcfg, batch=2, seq=6)
    bits = {"bfloat16": (torch.int16, np.int16), "float32": (torch.int32, np.int32)}[dtype]
    for _ in range(2):
        want, got = next(jit), next(tit)
        assert sorted(got) == sorted(want) == ["embeds", "labels", "tokens"]
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
        assert got["embeds"].dtype == getattr(torch, dtype)
        assert tuple(got["embeds"].shape) == (2, jcfg.frontend_len, jcfg.d_model)
        np.testing.assert_array_equal(got["embeds"].view(bits[0]).numpy(),
                                      np.asarray(want["embeds"]).view(bits[1]))
