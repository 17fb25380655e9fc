"""The port's flash attention against the reference's Pallas kernel
(interpret mode on the CPU) and its oracle, the model-level dispatch that
sends long prefill through it, and the wrapper's contract."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro.models import layers as jl
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import layers as tl

# one intra-op thread: the suite runs in several worker processes at once, and
# the spinning OpenMP threads of each would contend for the same cores
torch.set_num_threads(1)

# the reference's own cases (tests/test_kernels.py):
# B, T, S, H, KV, hd, causal, window, prefix, bq, bk
CASES = [
    (2, 128, 128, 4, 2, 32, True, None, 0, 64, 64),
    (1, 256, 256, 4, 1, 64, True, 64, 0, 64, 64),
    (2, 128, 128, 2, 2, 32, True, None, 32, 64, 32),
    (1, 128, 128, 4, 4, 32, False, None, 0, 128, 128),
    (1, 64, 64, 8, 2, 16, True, 32, 16, 32, 32),
]
# and cases where the tile skipping decides the result: a prefix longer than
# a q tile (a later prefix tile is skipped, as the reference kernel skips it)
# and a window narrower than a tile, non-causal
EXTRA = [
    (1, 128, 128, 2, 1, 16, True, None, 96, 32, 32),
    (1, 128, 128, 2, 2, 16, False, 8, 0, 32, 16),
]
# head width 256 (PaliGemma's): a skipped prefix tile, partial row and key
# tiles, a window with a prefix
WIDE = [
    (1, 128, 128, 2, 1, 256, True, None, 96, 32, 32),
    (1, 80, 80, 2, 1, 256, True, None, 0, 16, 16),
    (1, 192, 192, 2, 1, 256, True, 40, 48, 64, 32),
]
TOL = {"float32": 2e-4, "bfloat16": 3e-2}  # the reference test's tolerances


def _inputs(case, dt: str, seed: int):
    B, T, S, H, KV, hd = case[:6]
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(B, T, H, hd), rng.randn(B, S, KV, hd), rng.randn(B, S, KV, hd)]
    j = [jnp.asarray(a, jnp.dtype(dt)) for a in arrs]
    # the port sees exactly the reference's values (bf16 crosses through f32)
    t = [torch.from_numpy(np.array(x, np.float32)).to(getattr(torch, dt)) for x in j]
    return j, t


@pytest.mark.parametrize("case", CASES + EXTRA + WIDE)
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_plain_matches_reference_kernel(case, dt):
    causal, window, prefix, bq, bk = case[6:]
    (jq, jk, jv), (q, k, v) = _inputs(case, dt, seed=sum(case[:6]))
    kw = dict(causal=causal, window=window, prefix=prefix)
    got = fa.flash_attention_plain(q, k, v, bq=bq, bk=bk, **kw)
    assert got.dtype == q.dtype and got.shape == q.shape
    kernel = np.asarray(ops.flash_attention(jq, jk, jv, bq=bq, bk=bk, **kw), np.float32)
    np.testing.assert_allclose(got.float().numpy(), kernel, rtol=TOL[dt], atol=TOL[dt])
    if case in CASES:  # the oracle attends to every allowed key; see EXTRA
        oracle = np.asarray(ref.flash_attention_ref(jq, jk, jv, **kw), np.float32)
        np.testing.assert_allclose(got.float().numpy(), oracle, rtol=TOL[dt], atol=TOL[dt])
    # the wrapper on CPU tensors is the plain version
    assert torch.equal(fa.flash_attention(q, k, v, bq=bq, bk=bk, **kw), got)


def test_prefix_tile_skipping_follows_the_kernel():
    """With a prefix longer than a q tile, the reference kernel skips prefix
    keys in later tiles; the port's plain version skips the same ones."""
    case = EXTRA[0]
    (jq, jk, jv), (q, k, v) = _inputs(case, "float32", seed=7)
    kw = dict(causal=True, window=None, prefix=96)
    got = fa.flash_attention_plain(q, k, v, bq=32, bk=32, **kw).numpy()
    oracle = np.asarray(ref.flash_attention_ref(jq, jk, jv, **kw))
    assert np.abs(got[:, :32] - oracle[:, :32]).max() > 1e-2  # rows 0-31 miss keys 32-95
    np.testing.assert_allclose(got[:, 96:], oracle[:, 96:], rtol=2e-4, atol=2e-4)


def test_prefix_lm_prefill_keeps_every_prefix_key(monkeypatch):
    """A prefill whose prefix (256) is longer than a 128-row query tile, at
    4096 keys: the port's layer sends it to the kernel with query tiles that
    cover the prefix, so rows 0-127 see prefix keys 128-255 as the mask
    allows. The kernel's output against the port's block loop on the same
    q, k, v, and the layer against the reference layer's prefill (its block
    loop), every row, f32."""
    rng = np.random.RandomState(13)
    B, T, D, H, KV, hd, P = 1, 4096, 32, 2, 1, 16, 256
    kw = dict(num_heads=H, num_kv_heads=KV, head_dim=hd)
    p = {k: (rng.randn(*s) * 0.3).astype(np.float32) for k, s in
         (("wq", (D, H, hd)), ("wk", (D, KV, hd)), ("wv", (D, KV, hd)), ("wo", (H, hd, D)))}
    x = rng.randn(B, T, D).astype(np.float32)
    seen = []
    real = fa.flash_attention

    def spy(q, k, v, **kw):
        out = real(q, k, v, **kw)
        seen.append((q, k, v, kw, out))
        return out

    ts = tl.AttnSpec(**kw)
    monkeypatch.setattr(fa, "flash_attention", spy)
    with torch.no_grad():
        y, _ = tl.attention({k: torch.from_numpy(a) for k, a in p.items()},
                            torch.from_numpy(x), ts, mode="prefill", prefix_len=P)
    (q, k, v, kwargs, out), = seen
    assert kwargs["prefix"] == P and kwargs["bq"] >= P
    want = tl._chunked_sdpa(q, k, v, ts, P)
    np.testing.assert_allclose(out[:, :128].numpy(), want[:, :128].numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    jy, _ = jl.attention({k: jnp.asarray(a) for k, a in p.items()}, jnp.asarray(x),
                         jl.AttnSpec(**kw), mode="prefill", prefix_len=P)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("T, prefix, tiles", [
    (4096, 0, (128, 128)), (4096, 100, (128, 128)), (4096, 256, (256, 128)),
    (4096, 300, (512, 128)), (3072, 520, (768, 128)), (96, 16, (128, 128)),
])
def test_prefill_tiles_cover_the_prefix(T, prefix, tiles):
    """The least multiple of 128 at least as long as the prefix that
    divides T (a shorter T is one tile), and no tile of keys the kernel
    skips holds a key that the mask allows."""
    assert tl.prefill_tiles(T, prefix) == tiles
    bq, bk = min(tiles[0], T), min(tiles[1], T)
    i = torch.arange(T)
    kept = torch.tensor([[fa.tile_relevant(q0, k0, bq, bk, causal=True, window=None,
                                           prefix=prefix) for k0 in range(0, T, bk)]
                         for q0 in range(0, T, bq)])
    kept = kept.repeat_interleave(bq, 0).repeat_interleave(bk, 1)
    assert not (fa._mask(i, i, True, None, prefix) & ~kept).any()


def test_prefill_tiles_refuse_a_prefix_no_tile_covers():
    with pytest.raises(ValueError, match="prefix of 300"):
        tl.prefill_tiles(4160, 300)


@pytest.mark.parametrize("window", [None, 64])
def test_plain_matches_model_chunked_path(window):
    """As the reference's test_flash_matches_model_attention_path: the
    kernel's plain version against the port's windowed block loop."""
    rng = np.random.RandomState(11)
    B, T, H, KV, hd = 1, 256, 4, 2, 32
    q, k, v = (torch.from_numpy(rng.randn(B, T, n, hd).astype(np.float32))
               for n in (H, KV, KV))
    spec = tl.AttnSpec(num_heads=H, num_kv_heads=KV, head_dim=hd, window=window)
    a = tl._chunked_sdpa(q, k, v, spec, prefix_len=0, block=64)
    b = fa.flash_attention_plain(q, k, v, causal=True, window=window, bq=64, bk=64)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=2e-4)


def _layer(seed: int, window):
    rng = np.random.RandomState(seed)
    D, H, KV, hd = 32, 4, 2, 16
    spec = tl.AttnSpec(num_heads=H, num_kv_heads=KV, head_dim=hd, window=window)
    p = {k: torch.from_numpy((rng.randn(*s) * 0.3).astype(np.float32)) for k, s in
         (("wq", (D, H, hd)), ("wk", (D, KV, hd)), ("wv", (D, KV, hd)), ("wo", (H, hd, D)))}
    x = torch.from_numpy(rng.randn(1, tl.CHUNKED_ATTN_MIN_S, D).astype(np.float32))
    return spec, p, x


@pytest.mark.parametrize("window", [None, 1024])
def test_long_prefill_goes_through_the_kernel(monkeypatch, window):
    spec, p, x = _layer(5, window)
    calls = []
    real = fa.flash_attention

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), kw))
        return real(q, k, v, **kw)

    def no_block_loop(*a, **k):
        raise AssertionError("prefill took the block loop")

    monkeypatch.setattr(fa, "flash_attention", spy)
    monkeypatch.setattr(tl, "_chunked_sdpa", no_block_loop)
    with torch.no_grad():
        y, cache = tl.attention(p, x, spec, mode="prefill")
    assert calls == [((1, 4096, 4, 16), {"causal": True, "window": window, "prefix": 0,
                                         "bq": 128, "bk": 128})]
    assert y.shape == x.shape and torch.isfinite(y).all()
    assert cache["k"].shape[1] == (window or 4096)


def test_long_train_keeps_the_differentiable_loop(monkeypatch):
    spec, p, x = _layer(6, 1024)
    calls = []
    real = tl._chunked_sdpa

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    def no_kernel(*a, **k):
        raise AssertionError("train took the kernel, which has no backward")

    monkeypatch.setattr(tl, "_chunked_sdpa", spy)
    monkeypatch.setattr(fa, "flash_attention", no_kernel)
    p = {k: t.requires_grad_() for k, t in p.items()}
    y, cache = tl.attention(p, x, spec, mode="train")
    assert cache is None and calls == [1]
    y.square().mean().backward()
    assert p["wq"].grad is not None and torch.isfinite(p["wq"].grad).all()
    assert p["wq"].grad.abs().sum() > 0


def test_short_prefill_stays_dense(monkeypatch):
    spec, p, x = _layer(7, None)
    monkeypatch.setattr(fa, "flash_attention", lambda *a, **k: pytest.fail("kernel called"))
    with torch.no_grad():
        y, _ = tl.attention(p, x[:, :128], spec, mode="prefill")
    assert y.shape == (1, 128, 32)


@pytest.mark.parametrize("shapes, kw, match", [
    (((1, 64, 4, 16), (1, 64, 3, 16), (1, 64, 3, 16)), {}, "H % KV"),
    (((1, 64, 4, 16), (1, 64, 2, 8), (1, 64, 2, 8)), {}, "head width"),
    (((1, 64, 4, 16), (1, 64, 2, 16), (1, 32, 2, 16)), {}, "k and v"),
    (((64, 4, 16), (64, 2, 16), (64, 2, 16)), {}, "B,T,H,hd"),
    (((1, 96, 4, 16), (1, 96, 2, 16), (1, 96, 2, 16)), {"bq": 64}, "tiles must divide"),
    (((1, 64, 4, 16), (1, 96, 2, 16), (1, 96, 2, 16)), {"bk": 64}, "tiles must divide"),
    (((1, 64, 4, 16), (1, 64, 2, 16), (1, 64, 2, 16)), {"window": -1}, "window"),
])
def test_wrapper_refuses_bad_shapes(shapes, kw, match):
    q, k, v = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError, match=match):
        fa.flash_attention(q, k, v, **kw)


def test_tiles_shrink_to_short_sequences():
    """bq = min(bq, T) and bk = min(bk, S), as in the reference."""
    rng = np.random.RandomState(2)
    q, k, v = (torch.from_numpy(rng.randn(1, 48, 2, 16).astype(np.float32)) for _ in range(3))
    a = fa.flash_attention(q, k, v, bq=128, bk=128)
    b = fa.flash_attention_plain(q, k, v, bq=48, bk=48)
    assert torch.equal(a, b)


def test_attention_flops_count_the_kept_tiles():
    """The flops of the pairs the masks allow in the kept tiles (4*hd a
    pair), masked pairs of a kept tile left out."""
    # causal: the lower triangle with its diagonal; window 128: 128 keys a
    # row, fewer in the first 127 rows
    assert fa.attention_flops(512, 512, 2, 16, bq=128, bk=128) == 4 * 16 * (512 * 513 // 2) * 2
    assert fa.attention_flops(512, 512, 1, 16, window=128) == \
        4 * 16 * (128 * 129 // 2 + 384 * 128)
    assert fa.attention_flops(512, 512, 1, 16, causal=False) == 4 * 16 * 512 * 512
    # against a brute force over every (query, key) pair
    i = torch.arange(256)
    for causal, window, prefix, bq, bk in ((True, 40, 0, 32, 64), (True, 100, 48, 64, 32),
                                           (False, 70, 0, 32, 32), (True, None, 96, 64, 64)):
        kept = torch.tensor([[fa.tile_relevant(q0, k0, bq, bk, causal=causal, window=window,
                                               prefix=prefix) for k0 in range(0, 256, bk)]
                             for q0 in range(0, 256, bq)])
        kept = kept.repeat_interleave(bq, 0).repeat_interleave(bk, 1)
        pairs = int((kept & fa._mask(i, i, causal, window, prefix)).sum())
        assert fa.attention_flops(256, 256, 3, 16, 2, causal=causal, window=window,
                                  prefix=prefix, bq=bq, bk=bk) == 4 * 16 * pairs * 3 * 2


def test_kept_q_tiles_form_one_run():
    """The plain version applies a kv tile to one run of q tiles: for every
    kv tile, the q tiles that keep it are contiguous (or there are none)."""
    for causal in (True, False):
        for window in (None, 0, 1, 40, 128, 1000):
            for prefix in (0, 16, 96, 300):
                for bq, bk in ((32, 32), (64, 16), (16, 64), (128, 128)):
                    for k0 in range(0, 512, bk):
                        rel = [fa.tile_relevant(q0, k0, bq, bk, causal=causal, window=window,
                                                prefix=prefix) for q0 in range(0, 512, bq)]
                        runs = sum(1 for a, b in zip([False] + rel, rel) if b and not a)
                        assert runs <= 1, (causal, window, prefix, bq, bk, k0, rel)
