"""The sm90 flash kernel's host side on the CPU: its tile table, its route,
and its arithmetic emulated tile by tile (the kernel itself runs only on
the card: tests/test_torch_kernels_gpu.py). The emulation is held against
the plain version, which tests/test_torch_flash.py holds against the
reference's Pallas kernel, and once against that kernel directly."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro_torch import kernels
from repro_torch.kernels import flash_attention as fa

# one intra-op thread: the suite runs in several worker processes at once, and
# the spinning OpenMP threads of each would contend for the same cores
torch.set_num_threads(1)

# B, T, S, H, KV, hd, causal, window, prefix, bq, bk: the reference's cases
# (tests/test_kernels.py), then tile skipping, partial tiles, head widths 128,
# 256 and 64
CASES = [
    (2, 128, 128, 4, 2, 32, True, None, 0, 64, 64),
    (1, 256, 256, 4, 1, 64, True, 64, 0, 64, 64),
    (2, 128, 128, 2, 2, 32, True, None, 32, 64, 32),
    (1, 128, 128, 4, 4, 32, False, None, 0, 128, 128),
    (1, 64, 64, 8, 2, 16, True, 32, 16, 32, 32),
    (1, 128, 128, 2, 1, 16, True, None, 96, 32, 32),   # a prefix tile skipped
    (1, 96, 96, 4, 2, 128, True, 40, 0, 32, 32),       # a partial row block
    (1, 80, 80, 2, 1, 64, True, None, 0, 16, 16),      # partial row and key tiles
    (2, 256, 256, 4, 2, 128, True, None, 0, 64, 64),
    (1, 384, 384, 2, 2, 128, True, 100, 48, 64, 32),
    (1, 256, 256, 2, 2, 128, False, 0, 0, 64, 64),     # window 0: the last row has no key
    (1, 128, 128, 2, 1, 128, True, 0, 0, 32, 32),      # causal window 0: no row has a key
    (1, 320, 192, 2, 1, 128, True, None, 160, 64, 64),  # a prefix longer than bq, T != S
    # head width 256, 64-key kernel tiles: a skipped prefix tile, partial row
    # and key tiles, a window with a prefix, paligemma's tiles over its prefix
    (1, 128, 128, 2, 1, 256, True, None, 96, 32, 32),
    (1, 80, 80, 2, 1, 256, True, None, 0, 16, 16),
    (1, 96, 96, 4, 2, 256, True, 40, 0, 32, 32),
    (1, 384, 384, 2, 1, 256, True, 100, 48, 64, 32),
    (1, 512, 512, 4, 1, 256, True, None, 256, 256, 128),
    # head width 64 on 128 x 128 kernel tiles: an odd group (hymba-1.5b's
    # 25 / 5 has a group of 5), a window with a prefix, partial row and key
    # tiles under caller tiles below 128, window 0, a window over an odd group
    (1, 256, 256, 10, 2, 64, True, None, 0, 128, 128),
    (1, 384, 384, 2, 1, 64, True, 100, 48, 64, 32),
    (1, 200, 200, 5, 1, 64, True, None, 0, 40, 40),
    (1, 256, 256, 2, 2, 64, False, 0, 0, 64, 64),
    (1, 512, 512, 5, 1, 64, True, 128, 0, 128, 128),
]
# the serving paths at 4096 positions: a gemma3-27b layer's prefill (caller
# tiles 128 x 128, the kernel's own), a paligemma-3b layer's (the prefix of
# 256 under caller tiles 256 x 128, kernel tiles 128 x 64) and a hymba-1.5b
# layer's (width 64, window 1024, tiles 128 x 128):
# (hd, window, prefix, bq, bk, kernel tiles kept, kernel tiles of class 2)
PATH = [
    (128, None, 0, 128, 128, 528, 32),
    (128, 1024, 0, 128, 128, 252, 32 + 24),  # the diagonal and the window's far edge
    # Caller tile (a, b) is kept when 128 b <= 256 a + 255: b <= 2a + 1. Kernel
    # q-tile A lies in caller tile A // 2 and k-tile K in K // 2, so A loads
    # K <= 4 (A // 2) + 3: 4 (A // 2) + 4 tiles, 2 x (4 + 8 + ... + 64) = 1088
    # over A < 32. A loaded tile is class 1 when every key is a prefix key
    # (K <= 3) or at most the tile's first row (64 K + 63 <= 128 A: K <= 2A - 1).
    # Class 2: none at A = 0, 1; from A = 2 on, 4 (keys 4 (A // 2) .. +3) at
    # an even A and 2 at an odd one: 15 x 4 + 15 x 2 = 90.
    (256, None, 256, 256, 128, 1088, 90),
    # q tile A keeps k tiles A - 8 .. A: 1 + 2 + ... + 8 over A < 8, 9 a row
    # after, 36 + 24 x 9 = 252; class 2 the diagonal (32) and the window's far
    # edge (24), as at width 128
    (64, 1024, 0, 128, 128, 252, 32 + 24),
]
LIMIT_REL, LIMIT_ABS = 2.0**-8, 1e-5  # chip_smoke.py's bf16 limit: one bf16 rounding


def _bf16_share(got, want32) -> float:
    return float(((got.float() - want32).abs() / (LIMIT_REL * want32.abs() + LIMIT_ABS)).max())


def _kept_pairs(T, S, causal, window, prefix, bq, bk) -> torch.Tensor:
    """(T, S): the pairs in caller tiles that the reference keeps."""
    rel = torch.tensor([[fa.tile_relevant(q0, k0, bq, bk, causal=causal, window=window,
                                          prefix=prefix) for k0 in range(0, S, bk)]
                        for q0 in range(0, T, bq)])
    return rel.repeat_interleave(bq, 0).repeat_interleave(bk, 1)


def _tile(hd: int) -> tuple[int, int]:
    """The sm90 kernel's tile at this head width (widths it does not take:
    width 128's, the tile the table is checked at)."""
    return fa.SM90_TILES.get(hd, fa.SM90_TILES[128])


def _per_tile(x: torch.Tensor, tile, fill: bool, reduce) -> torch.Tensor:
    """(T, S) booleans reduced over the sm90 kernel's tiles, padded with
    ``fill`` to whole tiles."""
    kq, kk = tile
    T, S = x.shape
    nqt, nkt = -(-T // kq), -(-S // kk)
    pad = torch.full((nqt * kq, nkt * kk), fill)
    pad[:T, :S] = x
    return reduce(reduce(pad.view(nqt, kq, nkt, kk), 3), 1)


def _classes_hold(T, S, causal, window, prefix, bq, bk, tile) -> torch.Tensor:
    kq, kk = tile
    cls = fa.tile_classes(T, S, causal=causal, window=window, prefix=prefix, bq=bq, bk=bk,
                          kq=kq, kk=kk)
    kept = _kept_pairs(T, S, causal, window, prefix, bq, bk)
    allowed = kept & fa._mask(torch.arange(T), torch.arange(S), causal, window, prefix)
    # a tile is loaded exactly when it holds a pair that the reference processes
    assert torch.equal(cls > 0, _per_tile(kept, tile, False, lambda t, d: t.any(d)))
    # class 1 exactly where every pair is kept and allowed (rows past T are
    # never written; a key past S is never allowed)
    full = torch.zeros((cls.shape[0] * kq, cls.shape[1] * kk), dtype=torch.bool)
    full[T:] = True
    full[:T, :S] = allowed
    assert torch.equal(cls == 1, _per_tile(full, tile, True, lambda t, d: t.all(d)))
    return cls


@pytest.mark.parametrize("case", CASES)
def test_tile_classes_cover_the_processed_pairs(case):
    causal, window, prefix, bq, bk = case[6:]
    _classes_hold(case[1], case[2], causal, window, prefix, min(bq, case[1]), min(bk, case[2]),
                  _tile(case[5]))


@pytest.mark.parametrize("hd, window, prefix, bq, bk, tiles, element", PATH)
def test_tile_classes_at_the_serving_path(hd, window, prefix, bq, bk, tiles, element):
    cls = _classes_hold(4096, 4096, True, window, prefix, bq, bk, fa.SM90_TILES[hd])
    assert int((cls > 0).sum()) == tiles
    assert int((cls == 2).sum()) == element


def test_route_picks_the_kernel_by_dtype_and_head_width(monkeypatch):
    """Read without a launch: the route of CUDA (here: meta) tensors, and no
    fallback from either kernel's wrapper."""
    want = {(torch.bfloat16, 128): "flash_attention_sm90", (torch.float32, 128): "flash_attention",
            (torch.bfloat16, 64): "flash_attention_sm90", (torch.float32, 64): "flash_attention",
            (torch.bfloat16, 32): "flash_attention",
            (torch.float32, 16): "flash_attention", (torch.float16, 128): "flash_attention",
            (torch.bfloat16, 256): "flash_attention_sm90", (torch.float32, 256): "flash_attention",
            (torch.float16, 256): "flash_attention"}
    calls = []
    monkeypatch.setattr(fa, "flash_sm90", lambda *a, **k: calls.append("flash_attention_sm90"))
    monkeypatch.setattr(fa, "flash_fwd", lambda *a, **k: calls.append("flash_attention"))
    for (dt, hd), name in want.items():
        assert fa.kernel_route(dt, hd) == name
        q = torch.empty((1, 256, 4, hd), dtype=dt, device="meta")
        kv = torch.empty((1, 256, 2, hd), dtype=dt, device="meta")
        fa.flash_attention(q, kv, kv)
        assert calls.pop() == name
    monkeypatch.undo()
    before = kernels.launch_counts()
    q, kv = torch.zeros((1, 128, 4, 128)), torch.zeros((1, 128, 2, 128))
    with pytest.raises(ValueError, match="cuda"):
        fa.flash_sm90(q.bfloat16(), kv.bfloat16(), kv.bfloat16())
    with pytest.raises(ValueError, match="cuda"):
        fa.flash_fwd(q, kv, kv)
    assert kernels.launch_counts() == before


def _emulate_sm90(q, k, v, *, causal=True, window=None, prefix=0, bq=128, bk=128,
                  p_terms="two"):
    """The sm90 kernel's arithmetic on the CPU: its tiles at this head width
    (128 x 128 at widths 64 and 128, 128 x 64 at 256) walked with tile_classes, S = q k^T
    in f32 with the scale after the dot, class 1 unmasked, class 2 with the
    reference's element rule (-inf outside a kept caller tile and past S,
    -1e30 where masked), the online softmax with the row sum from the f32 p,
    then P V with p as ``two`` bf16 terms (the kernel), one bf16 term, or
    f32; the output rounded to q's dtype."""
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G, (kq, kk) = H // KV, _tile(hd)
    bq, bk = min(bq, T), min(bk, S)
    cls = fa.tile_classes(T, S, causal=causal, window=window, prefix=prefix, bq=bq, bk=bk,
                          kq=kq, kk=kk)
    kept = _kept_pairs(T, S, causal, window, prefix, bq, bk)
    allowed = fa._mask(torch.arange(T), torch.arange(S), causal, window, prefix)
    qf = q.float().reshape(B, T, KV, G, hd).permute(0, 2, 3, 1, 4)   # B KV G T hd
    kf, vf = (t.float().permute(0, 2, 1, 3)[:, :, None] for t in (k, v))  # B KV 1 S hd
    out = torch.zeros_like(qf)
    for a in range(cls.shape[0]):
        i = torch.arange(a * kq, min(a * kq + kq, T))
        m = torch.full((B, KV, G, len(i)), fa.NEG_INF)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, KV, G, len(i), hd))
        for b in range(cls.shape[1]):
            if cls[a, b] == 0:
                continue
            j = torch.arange(b * kk, min(b * kk + kk, S))
            s = (qf[..., i, :] @ kf[..., j, :].transpose(-1, -2)) * hd**-0.5
            if cls[a, b] == 2:
                s = torch.where(kept[i][:, j], torch.where(allowed[i][:, j], s, fa.NEG_INF),
                                -torch.inf)  # keys past S: not in j at all, as -inf
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            if p_terms == "f32":
                pv = p @ vf[..., j, :]
            else:
                hi = p.bfloat16().float()
                pv = hi @ vf[..., j, :]
                if p_terms == "two":
                    pv = pv + (p - hi).bfloat16().float() @ vf[..., j, :]
            acc = acc * corr[..., None] + pv
            m = m_new
        out[..., i, :] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, H, hd).to(q.dtype)


def _inputs(shape_q, shape_kv, seed, dt):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(*s).astype(np.float32)).to(dt)
            for s in (shape_q, shape_kv, shape_kv)]


@pytest.mark.parametrize("case", CASES)
def test_emulated_kernel_processes_the_plain_versions_pairs(case):
    """The tile walk (classes 0/1/2, -inf and -1e30) in f32 gives the plain
    version's result within the reference test's f32 tolerance; in bf16
    (p in two terms) within one bf16 rounding of it."""
    B, T, S, H, KV, hd, causal, window, prefix, bq, bk = case
    kw = dict(causal=causal, window=window, prefix=prefix, bq=bq, bk=bk)
    q, k, v = _inputs((B, T, H, hd), (B, S, KV, hd), sum(case[:6]), torch.float32)
    want = fa.flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(_emulate_sm90(q, k, v, p_terms="f32", **kw), want,
                               rtol=2e-4, atol=2e-4)
    q, k, v = (t.bfloat16() for t in (q, k, v))
    want = fa.flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    assert _bf16_share(_emulate_sm90(q, k, v, **kw), want) <= 1.0


def test_emulated_kernel_matches_reference_kernel():
    """One case at each of the kernel's head widths (128 x 128 tiles, then
    128 x 64 at width 256, then width 64's odd group) straight against the
    reference's Pallas kernel (interpret mode), at the reference test's f32
    tolerance."""
    for i in (9, 16, 18):
        B, T, S, H, KV, hd, causal, window, prefix, bq, bk = CASES[i]
        kw = dict(causal=causal, window=window, prefix=prefix, bq=bq, bk=bk)
        q, k, v = _inputs((B, T, H, hd), (B, S, KV, hd), i, torch.float32)
        want = ops.flash_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)), **kw)
        np.testing.assert_allclose(_emulate_sm90(q, k, v, p_terms="f32", **kw).numpy(),
                                   np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("seed, hd", [(0, 128), (1, 128), (2, 128), (3, 64)],
                         ids=["0", "1", "2", "64-3"])
def test_p_in_two_bf16_terms_keeps_the_bf16_limit(seed, hd):
    """Why P V takes p as p_hi + p_lo: the bf16 output is held within one
    bf16 rounding of the plain version's f32 result (2^-8 |plain| + 1e-5),
    which the output's own rounding nearly fills. Two bf16 terms carry p to
    about 2^-17 and stay within the limit, as f32 p does; a single bf16
    rounding of p adds an error of the output rounding's order and exceeds
    it many times over. Causal, T 1024, head widths 128 and 64."""
    q, k, v = _inputs((1, 1024, 2, hd), (1, 1024, 1, hd), seed, torch.bfloat16)
    want = fa.flash_attention_plain(q.float(), k.float(), v.float())
    share = {t: _bf16_share(_emulate_sm90(q, k, v, p_terms=t), want)
             for t in ("two", "f32", "one")}
    assert share["two"] <= 1.0 and share["f32"] <= 1.0, share
    assert share["one"] > 10.0, share
