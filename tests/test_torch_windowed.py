"""Sliding-window attention of the port against the reference, on
gemma3-27b-smoke (5 local layers of window 64 : 1 global, 12 layers):
masks, ring-buffer caches, the parameters carried over bit for bit, then
prefill, decode and ``Engine.generate`` in f32, on the dense path and on
the long-prompt path (the flash kernel's plain version in the port, the
block-scanned softmax in the reference)."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import Model as JModel
from repro.models import layers as jl
from repro.serve.engine import Engine as JEngine
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import Model as TModel
from repro_torch.models import layers as tl
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import Engine as TEngine

# one intra-op thread: the suite runs in several worker processes at once, and
# the spinning OpenMP threads of each would contend for the same cores
torch.set_num_threads(1)

ARCH = "gemma3-27b-smoke"
STEPS = 6
SHORT = 80     # > window 64: the ring wraps; < CHUNKED_ATTN_MIN_S: dense softmax
LONG = 256     # above the lowered threshold below: the long-prompt path
LOW_MIN_S = 128


def _configs():
    kw = {"dtype": "float32", "kv_cache_dtype": "float32"}
    return (dataclasses.replace(j_get_config(ARCH), **kw),
            dataclasses.replace(t_get_config(ARCH), **kw))


@pytest.fixture(scope="module")
def gemma():
    jcfg, tcfg = _configs()
    jparams = JModel(jcfg).init(jax.random.PRNGKey(4))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    rng = np.random.RandomState(4)
    tokens = {T: rng.randint(0, jcfg.vocab_size - 1, size=(4, T)) for T in (SHORT, LONG)}
    return jcfg, tcfg, jparams, tparams, tokens


def _lower_threshold(monkeypatch):
    """The long-prompt path at a CPU-sized prompt: the threshold lowered in
    both packages' layer modules for this test only."""
    monkeypatch.setattr(jl, "CHUNKED_ATTN_MIN_S", LOW_MIN_S)
    monkeypatch.setattr(tl, "CHUNKED_ATTN_MIN_S", LOW_MIN_S)


def test_config_matches_reference():
    for name in ("gemma3-27b", ARCH):
        j, t = j_get_config(name), t_get_config(name)
        assert {f.name: getattr(t, f.name) for f in dataclasses.fields(t)} == \
            {f.name: getattr(j, f.name) for f in dataclasses.fields(t)}
    assert t_get_config(ARCH).attn_pattern == (64, 64, 64, 64, 64, None)


@pytest.mark.parametrize("causal, window, prefix", [
    (True, 64, 0), (True, 16, 8), (False, 16, 0), (False, 16, 8), (True, None, 8),
    (True, 1, 0),
])
def test_masks_match_reference(causal, window, prefix):
    kw = dict(num_heads=4, num_kv_heads=2, head_dim=8, window=window, causal=causal)
    js, ts = jl.AttnSpec(**kw), tl.AttnSpec(**kw)
    T = 96
    want = np.asarray(jl.full_mask(T, js, prefix))
    np.testing.assert_array_equal(tl.full_mask(T, ts, "cpu", prefix).numpy(), want)
    i, j = np.arange(T), np.arange(32, 64)
    np.testing.assert_array_equal(
        tl._mask_block(ts, prefix, torch.from_numpy(i), torch.from_numpy(j)).numpy(),
        np.asarray(jl._mask_block(js, prefix, jnp.asarray(i), jnp.asarray(j))))


@pytest.mark.parametrize("T, window", [(100, 64), (64, 64), (40, 64), (130, 32), (12, None)])
def test_fill_cache_ring_bit_for_bit(T, window):
    rng = np.random.RandomState(T)
    k, v = (rng.randn(2, T, 2, 8).astype(np.float32) for _ in range(2))
    kw = dict(num_heads=4, num_kv_heads=2, head_dim=8, window=window)
    want = jl._fill_cache(jnp.asarray(k), jnp.asarray(v), jl.AttnSpec(**kw), T)
    got = tl._fill_cache(torch.from_numpy(k), torch.from_numpy(v), tl.AttnSpec(**kw), T)
    for name in ("k", "v", "pos"):
        assert got[name].dtype == {"pos": torch.int32}.get(name, torch.float32)
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))


@pytest.mark.parametrize("T", [12, 70])
def test_windowed_layer_decode_matches_reference(T):
    """Prefill then decode steps across the ring's wrap, layer by layer:
    outputs within 1e-5, the ring's positions bit for bit."""
    rng = np.random.RandomState(T)
    B, D, H, KV, hd, W = 2, 32, 4, 2, 8, 16
    kw = dict(num_heads=H, num_kv_heads=KV, head_dim=hd, window=W)
    js, ts = jl.AttnSpec(**kw), tl.AttnSpec(**kw)
    p = {k: (rng.randn(*s) * 0.3).astype(np.float32) for k, s in
         (("wq", (D, H, hd)), ("wk", (D, KV, hd)), ("wv", (D, KV, hd)), ("wo", (H, hd, D)))}
    jp = {k: jnp.asarray(a) for k, a in p.items()}
    tp = {k: torch.from_numpy(a) for k, a in p.items()}
    x = rng.randn(B, T, D).astype(np.float32)
    jy, jc = jl.attention(jp, jnp.asarray(x), js, mode="prefill")
    ty, tc = tl.attention(tp, torch.from_numpy(x), ts, mode="prefill")
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    from repro.models.blocks import _grow_cache as j_grow
    from repro_torch.models.blocks import _grow_cache as t_grow

    jc, tc = j_grow(jc, T + 12, js), t_grow(tc, T + 12, ts)
    assert tc["k"].shape[1] == W
    j_decode = jax.jit(lambda p, x, c, pos: jl.attention(p, x, js, mode="decode", cache=c,
                                                         cur_pos=pos))
    for i in range(12):
        xt = rng.randn(B, 1, D).astype(np.float32)
        jy, jc = j_decode(jp, jnp.asarray(xt), jc, jnp.asarray(T + i, jnp.int32))
        ty, tc = tl.attention(tp, torch.from_numpy(xt), ts, mode="decode", cache=tc,
                              cur_pos=T + i)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
        np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), atol=1e-5, rtol=1e-5)


def test_params_cross_bit_for_bit(gemma):
    _jcfg, _tcfg, jparams, tparams, _ = gemma
    jleaves, tleaves = jax.tree_util.tree_leaves(jparams), tree_leaves(tparams)
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        assert tuple(a.shape) == tuple(b.shape) and str(b.dtype) == f"torch.{a.dtype}"
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # a port-initialized tree has the reference's structure and shapes
    fresh = tree_leaves(TModel(_tcfg).init(0, device="cpu"))
    assert [tuple(t.shape) for t in fresh] == [tuple(a.shape) for a in jleaves]


def test_decode_cache_layout_matches_reference(gemma):
    jcfg, tcfg, *_ = gemma
    want = JModel(jcfg).init_cache(3, 100)
    got = TModel(tcfg).init_cache(3, 100, device="cpu")
    wl, gl = jax.tree_util.tree_leaves(want), tree_leaves(got)
    assert [tuple(a.shape) for a in wl] == [tuple(b.shape) for b in gl]
    for a, b in zip(wl, gl):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _prefill_decode(gemma, T: int):
    jcfg, tcfg, jparams, tparams, tokens = gemma
    tok = tokens[T]
    jm, tm = JModel(jcfg), TModel(tcfg)
    # jitted once per test, after any threshold patch: the reference's eager
    # decode would compile its layer scan again at every step
    j_prefill = jax.jit(lambda p, b: jm.prefill(p, b, max_len=T + STEPS))
    j_step = jax.jit(jm.decode_step)
    jlog, jc = j_prefill(jparams, {"tokens": jnp.asarray(tok, jnp.int32)})
    with torch.no_grad():
        tlog, tc = tm.prefill(tparams, {"tokens": torch.from_numpy(tok)}, max_len=T + STEPS)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4, rtol=1e-4)
    jleaves, tleaves = jax.tree_util.tree_leaves(jc), tree_leaves(tc)
    assert [tuple(a.shape) for a in jleaves] == [tuple(b.shape) for b in tleaves]
    for a, b in zip(jleaves, tleaves):
        if b.dtype == torch.int32:  # ring positions
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        else:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4, rtol=1e-4)
    nxt = np.asarray(jnp.argmax(jlog[:, -1], -1))[:, None]
    for i in range(STEPS):
        jlog, jc = j_step(jparams, jnp.asarray(nxt, jnp.int32), jc, T + i)
        with torch.no_grad():
            tlog, tc = tm.decode_step(tparams, torch.from_numpy(nxt.copy()), tc, T + i)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4, rtol=1e-4)
        nxt = np.asarray(jnp.argmax(jlog[:, 0], -1))[:, None]


def test_prefill_and_decode_match_dense_path(gemma, monkeypatch):
    import repro_torch.kernels.flash_attention as fa

    monkeypatch.setattr(fa, "flash_attention", lambda *a, **k: pytest.fail("kernel called"))
    _prefill_decode(gemma, SHORT)


def test_prefill_and_decode_match_long_path(gemma, monkeypatch):
    import repro_torch.kernels.flash_attention as fa

    _lower_threshold(monkeypatch)
    calls = []
    real = fa.flash_attention

    def spy(q, k, v, **kw):
        calls.append(kw["window"])
        return real(q, k, v, **kw)

    monkeypatch.setattr(fa, "flash_attention", spy)
    _prefill_decode(gemma, LONG)
    assert calls == [64, 64, 64, 64, 64, None] * 2  # every layer's prefill


_REFERENCE_GENERATE: dict = {}


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("T", [SHORT, LONG])
def test_generate_matches_reference(gemma, ranks, T, monkeypatch):
    jcfg, tcfg, jparams, tparams, tokens = gemma
    if T == LONG:
        _lower_threshold(monkeypatch)
    tok = tokens[T]
    if T not in _REFERENCE_GENERATE:  # the reference's single-device run, once per prompt
        _REFERENCE_GENERATE[T] = JEngine(jcfg, jparams).generate(
            {"tokens": jnp.asarray(tok, jnp.int32)}, steps=STEPS)
    want = _REFERENCE_GENERATE[T]
    engine = TEngine(tcfg, tree_map(torch.clone, tparams), mesh=make_mesh(ranks, device="cpu"),
                     distribute=True, device="cpu")
    got = engine.generate({"tokens": tok}, steps=STEPS)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.logprobs, want.logprobs, atol=1e-4, rtol=1e-4)
    assert got.prefill_len == want.prefill_len == T
