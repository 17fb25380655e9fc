"""The MHA family with QKV biases in the port against the reference, on
qwen1.5-32b-smoke in f32 (``reduced()`` gives 4 query and 2 kv heads) and
on its MHA variant (as many query heads as kv heads, as the full model's
40 / 40): prefill then decode steps with seeded nonzero QKV biases (the
reference draws zeros, which a dropped bias would match), ``generate``,
the head-blocked decode over a narrower cache at 40 kv heads (five blocks
of 8) and at 7 (one block of 7), a decode over an f8 cache of 8192 slots
(the head-blocked route) against the reference's, a prefill on the flash
route at G = 1, and ``to_tensor``'s f8 arrays bit for bit."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import Model as JModel
from repro.models import blocks as jb
from repro.models import layers as jl
from repro.serve.engine import Engine as JEngine
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.tree import tree_leaves
from repro_torch.models import Model as TModel
from repro_torch.models import blocks as tb
from repro_torch.models import layers as tl
from repro_torch.models.convert import params_from_jax, to_tensor
from repro_torch.serve import Engine as TEngine

# one intra-op thread: the suite runs in several worker processes at once, and
# the spinning OpenMP threads of each would contend for the same cores
torch.set_num_threads(1)

ARCH = "qwen1.5-32b-smoke"
B, T, STEPS = 3, 20, 3
TOL = dict(atol=1e-4, rtol=1e-4)
F32 = {"dtype": "float32", "kv_cache_dtype": "float32"}
# the variants: reduced() as it is, and with the full model's MHA (H == KV)
VARIANTS = {"gqa": {}, "mha": {"num_heads": 2}}


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


def _configs(variant: str, **extra):
    kw = {**F32, **VARIANTS[variant], **extra}
    return (dataclasses.replace(j_get_config(ARCH), **kw),
            dataclasses.replace(t_get_config(ARCH), **kw))


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def qwen(request):
    """One variant's configs, the reference's parameters with seeded
    biases (in both packages), tokens and the reference's results, computed
    once: prefill and ``STEPS`` greedy decode steps (logits and the final
    caches), and ``Engine.generate``."""
    jcfg, tcfg = _configs(request.param)
    jm = JModel(jcfg)
    np_params = with_biases(_np(jm.init(jax.random.PRNGKey(13))), 13)
    jparams = jax.tree.map(jnp.asarray, np_params)
    tokens = np.random.RandomState(13).randint(0, jcfg.vocab_size - 1, size=(B, T))
    prefill = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t}, max_len=T + STEPS))
    decode = jax.jit(jm.decode_step)
    lg, caches = prefill(jparams, jnp.asarray(tokens, jnp.int32))
    steps, nxt = [np.asarray(lg)], np.asarray(jnp.argmax(lg[:, -1], -1))[:, None]
    feed = [nxt]
    for i in range(STEPS):
        lg, caches = decode(jparams, jnp.asarray(nxt, jnp.int32), caches,
                            jnp.asarray(T + i, jnp.int32))
        steps.append(np.asarray(lg))
        nxt = np.asarray(jnp.argmax(lg[:, 0], -1))[:, None]
        feed.append(nxt)
    gen = JEngine(jcfg, jparams).generate({"tokens": jnp.asarray(tokens, jnp.int32)},
                                          steps=STEPS)
    return dict(variant=request.param, jcfg=jcfg, tcfg=tcfg, np_params=np_params,
                tparams=params_from_jax(np_params), tokens=tokens, steps=steps, feed=feed,
                caches=_np(caches), generate=gen)


def test_prefill_then_decode_match(qwen):
    """Prefill, then ``STEPS`` decode steps, with nonzero biases on q, k
    and v; the caches (biased k, v) as the reference's."""
    tm = TModel(qwen["tcfg"])
    blk = qwen["tparams"]["decoder"]["blocks"][0]["attn"]
    assert all(bool(blk[name].abs().min() > 0) for name in ("bq", "bk", "bv"))
    with torch.no_grad():
        lg, caches = tm.prefill(qwen["tparams"], {"tokens": torch.from_numpy(qwen["tokens"])},
                                max_len=T + STEPS)
        np.testing.assert_allclose(lg.numpy(), qwen["steps"][0], **TOL)
        for i in range(STEPS):
            lg, caches = tm.decode_step(qwen["tparams"], torch.from_numpy(qwen["feed"][i]),
                                        caches, T + i)
            np.testing.assert_allclose(lg.numpy(), qwen["steps"][i + 1], **TOL)
    want = jax.tree_util.tree_leaves(qwen["caches"])
    got = tree_leaves(caches)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, **TOL)


def test_generate_matches_reference(qwen):
    got = TEngine(qwen["tcfg"], qwen["tparams"], device="cpu").generate(
        {"tokens": qwen["tokens"]}, steps=STEPS)
    np.testing.assert_array_equal(got.tokens, qwen["generate"].tokens)
    np.testing.assert_allclose(got.logprobs, qwen["generate"].logprobs, **TOL)


def _count_sdpa(monkeypatch, mod):
    """Record the kv heads of every ``_sdpa`` call of module ``mod``."""
    seen = []
    inner = mod._sdpa
    monkeypatch.setattr(mod, "_sdpa", lambda q, k, v, mask, spec: (
        seen.append(k.shape[2]), inner(q, k, v, mask, spec))[1])
    return seen


@pytest.mark.parametrize("KV, G, blocks", [(40, 1, [8] * 5), (7, 2, [7])])
def test_decode_sdpa_headblocked_matches_reference(monkeypatch, KV, G, blocks):
    """The head-blocked softmax over an f8 cache, directly: blocks of at
    most 8 kv heads, the size lowered until it divides KV (40: five blocks
    of 8; 7: one of 7), against the reference's on the same f8 bits and
    against the port's ``_sdpa`` over the cast cache."""
    H, hd, S = KV * G, 16, 48
    rng = np.random.RandomState(KV)
    q = rng.randn(2, 1, H, hd).astype(np.float32)
    k, v = (rng.randn(2, S, KV, hd).astype(ml_dtypes.float8_e5m2) for _ in range(2))
    mask = np.arange(S)[None, None, :] < 41  # the slots that hold tokens
    spec = jl.AttnSpec(num_heads=H, num_kv_heads=KV, head_dim=hd)
    tspec = tl.AttnSpec(num_heads=H, num_kv_heads=KV, head_dim=hd)
    jseen, tseen = _count_sdpa(monkeypatch, jl), _count_sdpa(monkeypatch, tl)
    want = jl._decode_sdpa_headblocked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(mask), spec)
    tk, tv = to_tensor(k), to_tensor(v)
    assert tk.dtype == torch.float8_e5m2
    got = tl._decode_sdpa_headblocked(torch.from_numpy(q), tk, tv, torch.from_numpy(mask), tspec)
    assert tseen == jseen == blocks
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    whole = tl._sdpa(torch.from_numpy(q), tk.float(), tv.float(), torch.from_numpy(mask), tspec)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), **TOL)


def test_f8_cache_decode_matches_reference(monkeypatch):
    """``kv_cache_dtype='float8_e5m2'`` at ``max_len`` 8192 (the reference's
    dry-run override): prefill casts the caches to f8, and every decode step
    takes the head-blocked route (the cache narrower than the compute dtype,
    S >= 8192), logits and f8 cache bits against the reference's."""
    jcfg, tcfg = _configs("mha", kv_cache_dtype="float8_e5m2")
    max_len = tl.HEADBLOCKED_MIN_S
    np_params = with_biases(_np(JModel(jcfg).init(jax.random.PRNGKey(17))), 17)
    jparams = jax.tree.map(jnp.asarray, np_params)
    tokens = np.random.RandomState(17).randint(0, jcfg.vocab_size - 1, size=(2, 16))
    jm, tm = JModel(jcfg), TModel(tcfg)
    wl, wc = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t}, max_len=max_len))(
        jparams, jnp.asarray(tokens, jnp.int32))
    calls = []
    inner = tl._decode_sdpa_headblocked
    monkeypatch.setattr(tl, "_decode_sdpa_headblocked",
                        lambda *a, **k: calls.append(a[1].dtype) or inner(*a, **k))
    tparams = params_from_jax(np_params)
    with torch.no_grad():
        gl, gc = tm.prefill(tparams, {"tokens": torch.from_numpy(tokens)}, max_len=max_len)
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **TOL)
        step = jax.jit(jm.decode_step)
        nxt = np.asarray(jnp.argmax(wl[:, -1], -1))[:, None]
        for i in range(2):
            wl, wc = step(jparams, jnp.asarray(nxt, jnp.int32), wc, jnp.asarray(16 + i, jnp.int32))
            gl, gc = tm.decode_step(tparams, torch.from_numpy(nxt), gc, 16 + i)
            np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **TOL)
            nxt = np.asarray(jnp.argmax(wl[:, 0], -1))[:, None]
    assert calls == [torch.float8_e5m2] * (2 * tcfg.num_layers)
    attn = gc["blocks"][0]["attn"]
    assert attn["k"].dtype == torch.float8_e5m2 and attn["k"].shape[2] == max_len
    for g, w in zip(tree_leaves(gc), jax.tree_util.tree_leaves(_np(wc))):
        assert tuple(g.shape) == w.shape and str(g.dtype) == f"torch.{w.dtype}"
        if g.element_size() == 1:  # the f8 keys and values, bit for bit
            g, w = g.view(torch.uint8), w.view(np.uint8)
        np.testing.assert_array_equal(g.numpy(), w)


def test_mha_block_through_the_flash_route(monkeypatch):
    """One MHA block with biases at 256 positions, the long-prompt threshold
    lowered to 128 in both packages' layer modules: the port's prefill takes
    ``flash_attention`` (its plain version on the CPU) at a group of 1, the
    reference's its block-scanned softmax."""
    monkeypatch.setattr(jl, "CHUNKED_ATTN_MIN_S", 128)
    monkeypatch.setattr(tl, "CHUNKED_ATTN_MIN_S", 128)
    from repro_torch.kernels import flash_attention as fa

    calls = []
    monkeypatch.setattr(fa, "flash_attention_plain",
                        lambda *a, _f=fa.flash_attention_plain, **k: calls.append(a[0].shape[2]
                                                                                  // a[1].shape[2])
                        or _f(*a, **k))
    jcfg, tcfg = _configs("mha")
    jp = with_biases(_np(jb.init_block(jax.random.PRNGKey(19), jcfg, "attn", None,
                                       dtype=jnp.float32)), 19)
    x = np.random.RandomState(19).randn(2, 256, jcfg.d_model).astype(np.float32)
    jy, _jc, _ = jax.jit(lambda p, x: jb.apply_block(p, x, jcfg, "attn", None, mode="prefill",
                                                     max_len=258))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    ty, _tc, _ = tb.apply_block(params_from_jax(jp), torch.from_numpy(x), tcfg, "attn", None,
                                mode="prefill", max_len=258)
    assert calls == [1]
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)


@pytest.mark.parametrize("name", ["float8_e5m2", "float8_e4m3fn"])
def test_to_tensor_carries_f8_bit_for_bit(name):
    """Every one of the 256 bit patterns of an ml_dtypes f8 array (NaNs and
    infinities included) crosses as the torch f8 type with the same bits,
    in memory of its own."""
    raw = np.arange(256, dtype=np.uint8).reshape(16, 16)
    a = raw.view(getattr(ml_dtypes, name))
    t = to_tensor(a)
    assert t.dtype == getattr(torch, name) and tuple(t.shape) == (16, 16)
    np.testing.assert_array_equal(t.view(torch.uint8).numpy(), raw)
    t.view(torch.uint8).zero_()
    assert raw[1, 0] == 16, "to_tensor shared the array's memory"
