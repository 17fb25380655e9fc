"""The port's serving slice against the reference on minitron-8b-smoke:
the reference's JAX-initialised parameters carried over bit for bit, then
prefill, decode, ``Engine.generate`` and the weight broadcast compared."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import Model as JModel
from repro.serve.engine import Engine as JEngine
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.kernels import chunked_copy as cc
from repro_torch.kernels import combine_update as cu
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import Model as TModel
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import Engine as TEngine
from repro_torch.serve import distribute_weights, replicate

T, STEPS = 12, 6


def _configs(dtype: str):
    kw = {"dtype": dtype, "kv_cache_dtype": dtype}
    return (dataclasses.replace(j_get_config("minitron-8b-smoke"), **kw),
            dataclasses.replace(t_get_config("minitron-8b-smoke"), **kw))


@pytest.fixture(scope="module")
def f32():
    jcfg, tcfg = _configs("float32")
    jparams = JModel(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    tokens = np.random.RandomState(0).randint(0, jcfg.vocab_size - 1, size=(4, T))
    return jcfg, tcfg, jparams, tparams, tokens


def test_params_cross_bit_for_bit(f32):
    _jcfg, _tcfg, jparams, tparams, _ = f32
    jl = jax.tree_util.tree_leaves(jparams)
    tl = tree_leaves(tparams)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape) and str(b.dtype) == f"torch.{a.dtype}"
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_prefill_and_decode_logits_match(f32):
    jcfg, tcfg, jparams, tparams, tokens = f32
    jm, tm = JModel(jcfg), TModel(tcfg)
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(tokens, jnp.int32)}, max_len=T + STEPS)
    with torch.no_grad():
        tl, tc = tm.prefill(tparams, {"tokens": torch.from_numpy(tokens)}, max_len=T + STEPS)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None]
    for i in range(3):
        jl, jc = jm.decode_step(jparams, jnp.asarray(nxt, jnp.int32), jc, T + i)
        with torch.no_grad():
            tl, tc = tm.decode_step(tparams, torch.from_numpy(nxt), tc, T + i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
        nxt = np.asarray(jnp.argmax(jl[:, 0], -1))[:, None]


@pytest.mark.parametrize("ranks", [1, 2, 4])
def test_generate_matches_reference(f32, ranks):
    jcfg, tcfg, jparams, tparams, tokens = f32
    want = JEngine(jcfg, jparams).generate({"tokens": jnp.asarray(tokens, jnp.int32)},
                                           steps=STEPS)
    mesh = None if ranks == 1 else make_mesh(ranks, device="cpu")
    engine = TEngine(tcfg, tree_map(torch.clone, tparams), mesh=mesh, distribute=True,
                     double_buffer=True, device="cpu")
    got = engine.generate({"tokens": tokens}, steps=STEPS)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.logprobs, want.logprobs, atol=1e-4, rtol=1e-4)
    assert got.prefill_len == want.prefill_len


def test_bf16_prefill_logits_close():
    jcfg, tcfg = _configs("bfloat16")
    jparams = JModel(jcfg).init(jax.random.PRNGKey(1))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    tokens = np.random.RandomState(1).randint(0, jcfg.vocab_size - 1, size=(2, T))
    jl, _ = JModel(jcfg).prefill(jparams, {"tokens": jnp.asarray(tokens, jnp.int32)}, max_len=T)
    with torch.no_grad():
        tl, _ = TModel(tcfg).prefill(tparams, {"tokens": torch.from_numpy(tokens)}, max_len=T)
    # bf16 rounds at different places in XLA and in torch, and the logits
    # come out of a bf16 product: besides 5e-2 absolute, allow one bf16 step
    # of the value itself (2^-7 relative), which a logit near 10 needs
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=5e-2, rtol=2**-7)


def _bits(t):
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def _nan_stack(params, n):
    stacked = replicate(params, n, fill_root_only=True)
    for leaf in tree_leaves(stacked):
        leaf[1:] = float("nan")
    return stacked


@pytest.mark.parametrize("n", [3, 4])
def test_distribute_weights_fills_every_replica(f32, n, monkeypatch):
    _jcfg, _tcfg, _jparams, tparams, _ = f32
    # bf16 leaves as well as the f32 norm scales
    params = {"w": tree_map(lambda t: t.to(torch.bfloat16), tparams), "s": tparams}
    mesh = make_mesh(n, device="cpu")
    calls = {"copy": 0, "merge": 0}
    plain_copy, plain_merge = cc.chunked_copy_plain, cu.fused_combine_update_plain

    def spy_copy(*a, **k):
        calls["copy"] += 1
        return plain_copy(*a, **k)

    def spy_merge(*a, **k):
        calls["merge"] += 1
        return plain_merge(*a, **k)

    monkeypatch.setattr(cc, "chunked_copy_plain", spy_copy)
    monkeypatch.setattr(cu, "fused_combine_update_plain", spy_merge)
    reset_launch_counts()
    outs = {}
    for double_buffer in (False, True):
        for compiled in (None, True):
            out = distribute_weights(_nan_stack(params, n), mesh, algo="pipelined_chain",
                                     bucket_bytes=64 << 10, double_buffer=double_buffer,
                                     compiled=compiled)
            for leaf in tree_leaves(out):
                for r in range(1, n):
                    assert torch.equal(_bits(leaf[r]), _bits(leaf[0]))
            outs[double_buffer, compiled] = out
    ref = tree_leaves(outs[False, None])
    for key, out in outs.items():
        for a, b in zip(ref, tree_leaves(out)):
            assert torch.equal(_bits(a), _bits(b)), key
    for a, b in zip(tree_leaves(params), ref):
        assert torch.equal(_bits(a), _bits(b[0]))
    # the compiled, double-buffered runs went through both kernel wrappers;
    # on the CPU they take the plain versions, so no CUDA launch is counted
    assert calls["copy"] > 0 and calls["merge"] > 0
    assert launch_counts() == {"chunked_copy": 0, "fused_combine": 0}


def test_default_policy_plans_and_graph(f32):
    from repro_torch.serve import distribution_stream_graph

    _jcfg, _tcfg, _jparams, tparams, _ = f32
    mesh = make_mesh(4, device="cpu")
    stacked = replicate(tparams, 4, fill_root_only=False)
    graph, spec, plans = distribution_stream_graph(stacked, mesh, double_buffer=True)
    entry = graph.entry("distribute")
    assert entry.overlap_depth == 2 and entry.order == tuple(range(spec.num_buckets))
    assert len(plans["data"]) == spec.num_buckets
    assert entry.wire_bytes() == sum(p.wire_bytes() for p in plans["data"])


def test_entry_points_need_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    _jcfg, tcfg = _configs("float32")
    params = TModel(tcfg).init(0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        TEngine(tcfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        TModel(tcfg).init(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(2)
    with pytest.raises(NotImplementedError, match="A.10"):
        distribute_weights(replicate(params, 2, fill_root_only=False),
                           make_mesh(2, device="cpu"), drain_dir="/nonexistent")


@pytest.mark.parametrize("KV", [2, 4])
def test_attention_layer_matches_reference(KV):
    """Prefill, the chunked softmax and decode appends of the port's
    attention layer against the reference's, in f32, grouped (GQA) and
    with one KV head per query head."""
    from repro.models import layers as jl
    from repro_torch.models import layers as tl

    rng = np.random.RandomState(3)
    B, T, D, H, hd = 2, 8, 32, 4, 8
    jspec = jl.AttnSpec(num_heads=H, num_kv_heads=KV, head_dim=hd)
    tspec = tl.AttnSpec(num_heads=H, num_kv_heads=KV, head_dim=hd)
    p = {k: rng.randn(*s).astype(np.float32) * 0.3 for k, s in
         (("wq", (D, H, hd)), ("wk", (D, KV, hd)), ("wv", (D, KV, hd)), ("wo", (H, hd, D)))}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    x = rng.randn(B, T, D).astype(np.float32)
    jy, jc = jl.attention(jp, jnp.asarray(x), jspec, mode="prefill")
    ty, tc = tl.attention(tp, torch.from_numpy(x), tspec, mode="prefill")
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
    for k in ("k", "v", "pos"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), atol=1e-5, rtol=1e-5)
    for i in range(3):
        xt = rng.randn(B, 1, D).astype(np.float32)
        jy, jc = jl.attention(jp, jnp.asarray(xt), jspec, mode="decode", cache=jc,
                              cur_pos=jnp.asarray(T + i, jnp.int32))
        ty, tc = tl.attention(tp, torch.from_numpy(xt), tspec, mode="decode", cache=tc,
                              cur_pos=T + i)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
    # the block-scanned softmax the prefill takes from S = 4096 on
    q = rng.randn(1, 128, H, hd).astype(np.float32)
    k = rng.randn(1, 128, KV, hd).astype(np.float32)
    v = rng.randn(1, 128, KV, hd).astype(np.float32)
    want = jl._chunked_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jspec, 0, block=32)
    got = tl._chunked_sdpa(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           tspec, 0, block=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_windowed_attention_is_refused():
    """Sliding-window layers are not ported: a config with them raises
    rather than serving global attention in their place."""
    cfg = dataclasses.replace(t_get_config("minitron-8b-smoke"), attn_pattern=(4, None))
    with pytest.raises(NotImplementedError, match="A.11"):
        TModel(cfg).init(0, device="cpu")


def test_decode_cache_layout_matches_reference(f32):
    jcfg, tcfg, *_ = f32
    want = JModel(jcfg).init_cache(3, 20)
    got = TModel(tcfg).init_cache(3, 20, device="cpu")
    wl, tl_ = jax.tree_util.tree_leaves(want), tree_leaves(got)
    assert [tuple(a.shape) for a in wl] == [tuple(b.shape) for b in tl_]
    for a, b in zip(wl, tl_):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
