"""The CUDA kernels against their plain versions on a card (``gpu`` marker;
skipped where ``torch.cuda.is_available()`` is false). Imports no JAX, so it
runs on a machine that has only PyTorch and the CUDA toolkit:
``python -m pytest -m gpu tests/test_torch_kernels_gpu.py``."""
from __future__ import annotations

import pytest
import torch

from repro_torch.kernels import combine_update as cu
from repro_torch.kernels.chunked_copy import chunked_copy, chunked_copy_plain


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain(dt):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    cur = torch.randn((7, 1029), generator=gen, device="cuda").to(dt)
    recv = torch.randn((7, 1029), generator=gen, device="cuda").to(dt)
    mode = torch.tensor([[0], [1], [2], [0], [2], [1], [0]], dtype=torch.int32, device="cuda")
    cur[0, 0] = -0.0
    cur[3, 1] = float("nan")
    k = cu.fused_combine(cur.clone(), recv, mode)
    p = cu.fused_combine_plain(cur.clone(), recv, mode)
    bits = {2: torch.int16, 4: torch.int32}[cur.element_size()]
    assert torch.equal(k.view(bits), p.view(bits))

    buf = torch.randn((3, 5, 1024), generator=gen, device="cuda").to(dt)
    rv = torch.randn((3, 2, 1024), generator=gen, device="cuda").to(dt)
    ints = lambda v: torch.tensor(v, dtype=torch.int32, device="cuda")  # noqa: E731
    args = (ints([0, 3, 1]), ints([0, 1, 0]), ints([2, 2, 0]))
    for combine in (0, 1):
        k = cu.fused_combine_update(buf.clone(), rv, *args, combine)
        p = cu.fused_combine_update_plain(buf.clone(), rv, *args, combine)
        assert torch.equal(k.view(bits), p.view(bits))

    x = torch.randn(100_003, generator=gen, device="cuda").to(dt)
    for v in (x, x[1:]):
        assert torch.equal(chunked_copy(v).view(bits), chunked_copy_plain(v).view(bits))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [1, 7, 1029, 16_421])
def test_fused_combine_at_every_row_offset(dt, C):
    """Both merge entry points at odd widths (a head-only row up to a body
    of two tiles and more), the buffer and recv at every pair of base
    offsets mod 16 that the dtype allows: bit-equal to the plain version,
    KEEP rows (-0.0, NaN payloads) and the bytes around the buffer
    unwritten, one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    es = torch.empty((), dtype=dt).element_size()
    bits = {2: torch.int16, 4: torch.int32}[es]
    n, K, B = 4, 6, 3
    ints = lambda v: torch.tensor(v, dtype=torch.int32, device="cuda")  # noqa: E731
    start, lo, hi = ints([1, 2, 1, 3]), ints([1, 0, 2, 1]), ints([2, 3, 3, 1])
    gen = torch.Generator(device="cuda").manual_seed(C)
    init = torch.randn((n, K, C), generator=gen, device="cuda").to(dt)
    vals = torch.randn((n, B, C), generator=gen, device="cuda").to(dt)
    moving = torch.zeros(n * K, dtype=torch.bool, device="cuda")
    for r, (s, a, b) in enumerate(zip(start.tolist(), lo.tolist(), hi.tolist())):
        moving[r * K + s + a:r * K + s + b] = True
    flat = init.view(n * K, C)
    flat[~moving, 0] = -0.0
    flat[~moving, C // 2] = float("nan")
    flat.view(bits)[~moving, C - 1] = 0x7FC3 if dt == torch.bfloat16 else 0x7FC01234
    size = n * K * C * es
    buf_pool = torch.empty(size + 32, dtype=torch.int8, device="cuda")
    recv_pool = torch.zeros(n * B * C * es + 32, dtype=torch.int8, device="cuda")
    modes = ints([2, 0, 1, 0, 2, 1]).reshape(6, 1)
    for do in range(0, 16, es):
        for so in range(0, 16, es):
            recv = recv_pool[so:so + n * B * C * es].view(dt).view(n, B, C)
            recv.copy_(vals)
            for combine in (0, 1):
                buf_pool.fill_(0x5A)
                buf = buf_pool[do:do + size].view(dt).view(n, K, C)
                buf.copy_(init)
                want = buf_pool.clone()
                cu.fused_combine_update_plain(want[do:do + size].view(dt).view(n, K, C), recv,
                                              start, lo, hi, combine)
                before = cu.fused_combine_update.launches
                cu.fused_combine_update(buf, recv, start, lo, hi, combine)
                assert cu.fused_combine_update.launches == before + 1
                assert torch.equal(buf_pool, want), (do, so, combine)
            buf_pool.fill_(0x5A)
            cur = buf_pool[do:do + 6 * C * es].view(dt).view(6, C)
            cur.copy_(vals.view(-1, C)[:6].flip(0))
            cur[1, 0], cur[3, 0] = -0.0, float("nan")
            want = buf_pool.clone()
            cu.fused_combine_plain(want[do:do + 6 * C * es].view(dt).view(6, C),
                                   recv.view(-1, C)[:6], modes)
            cu.fused_combine(cur, recv.view(-1, C)[:6], modes)
            assert torch.equal(buf_pool, want), (do, so)
    torch.cuda.synchronize()


def _same_or_both_nan(a, b) -> bool:
    """Bit-equal, where a NaN may carry any payload on either side."""
    if a.dtype == torch.float8_e4m3fn:
        nan = a.float().isnan() & b.float().isnan()
    else:
        nan = a.isnan() & b.isnan()
    bits = {1: torch.int8, 4: torch.int32}[a.element_size()]
    return bool(((a.view(bits) == b.view(bits)) | nan).all())


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quantize_kernels_match_plain(fmt):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import quantize as qk

    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((5, 1000), generator=gen, device="cuda") * 3
    x[1, :256] = 0.0
    x[2, 0], x[2, 1], x[2, 2:10] = 1e30, -1e30, 1e-30
    x[3, 300] = float("nan")
    x[4, :256] = (torch.arange(256, device="cuda") - 128) * 0.5
    rows = torch.tensor([4, 0, 2], dtype=torch.int64, device="cuda")
    for src, kw in ((x, {}), (x[:, 1:], {}), (x, {"rows": rows}), (x[:0], {})):
        v, s = qk.quantize_blocks(src, fmt, **kw)
        pv, ps = qk.quantize_blocks_plain(src, fmt, **kw)
        assert v.shape == pv.shape and s.shape == ps.shape
        assert _same_or_both_nan(v, pv) and _same_or_both_nan(s, ps)
        cols = src.shape[1]
        d = qk.dequantize_blocks(v, s, out_cols=cols)
        pd = qk.dequantize_blocks_plain(pv, ps, out_cols=cols)
        assert _same_or_both_nan(d, pd)
        if v.shape[0]:
            out = torch.zeros((7, cols), device="cuda")
            land = torch.arange(v.shape[0], dtype=torch.int64, device="cuda") + 1
            qk.dequantize_blocks(v, s, out_cols=cols, out=out, rows=land)
            assert _same_or_both_nan(out[1:1 + v.shape[0]], pd)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [1, 15, 17, 100_003])
def test_chunked_copy_at_every_byte_offset(dt, n):
    """One launch copies ``n`` elements from every source byte offset mod 16
    to every destination one that the dtype allows (all 16 for int8): the
    bytes land bit for bit, equal to the plain version, and no byte around
    the destination changes. The wrapper counts one launch a copy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import chunked_copy as cc

    es = torch.empty((), dtype=dt).element_size()
    nbytes = n * es
    gen = torch.Generator(device="cuda").manual_seed(n)
    src_pool = torch.randint(-128, 128, (nbytes + 32,), dtype=torch.int8, device="cuda",
                             generator=gen)
    dst_pool = torch.empty(nbytes + 32, dtype=torch.int8, device="cuda")
    for so in range(0, 16, es):
        x = src_pool[so:so + nbytes].view(dt)
        for do in range(0, 16, es):
            dst_pool.fill_(0x5A)
            cc._launch(dst_pool[do:do + nbytes].view(dt), x)
            want = torch.full_like(dst_pool, 0x5A)
            want[do:do + nbytes] = src_pool[so:so + nbytes]
            assert torch.equal(dst_pool, want), (so, do)
        before = cc.chunked_copy.launches
        got = cc.chunked_copy(x)
        assert cc.chunked_copy.launches == before + 1
        assert torch.equal(got.view(torch.int8), cc.chunked_copy_plain(x).view(torch.int8))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_dequantize_at_every_row_offset(fmt):
    """Dequantize into rows at every offset mod 4 floats (four base offsets
    times four pitch classes), with and without ``rows=``, at widths below
    ``Cp`` (1024) down to a head-only row: bit-equal to the plain version
    (NaN block and +-1e30 block included), nothing written outside the
    addressed rows' ``out_cols`` columns."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import quantize as qk

    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((4, 1000), generator=gen, device="cuda") * 3
    x[1, :256] = 0.0
    x[2, 0], x[2, 1], x[2, 2:10] = 1e30, -1e30, 1e-30
    x[3, 300] = float("nan")
    v, s = qk.quantize_blocks_plain(x, fmt)
    land = torch.tensor([5, 1, 3, 6], dtype=torch.int64, device="cuda")
    for cols in (1000, 999, 771, 256, 17, 2):
        want = qk.dequantize_blocks_plain(v, s, out_cols=cols)
        assert _same_or_both_nan(qk.dequantize_blocks(v, s, out_cols=cols), want)
        for base in range(4):
            for pitch in range(cols, cols + 4):
                for rows, nrows, at in ((None, 4, [0, 1, 2, 3]), (land, 7, land.tolist())):
                    pool = torch.full((nrows * pitch + base + 4,), 7.0, device="cuda")
                    out = pool[base:base + nrows * pitch].view(nrows, pitch)[:, :cols]
                    qk.dequantize_blocks(v, s, out_cols=cols, out=out, rows=rows)
                    assert _same_or_both_nan(out[at], want), (cols, base, pitch, rows)
                    keep = torch.ones_like(pool, dtype=torch.bool)
                    for r in at:
                        start = base + r * pitch
                        keep[start:start + cols] = False
                    assert (pool[keep] == 7.0).all(), (cols, base, pitch, rows)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_inkernel_replay_matches_plain(dt):
    """One launch per replay, bit-equal to the plain replay, on an odd and
    an aligned width, over a chain, a fused allreduce and a schedule in
    which two ranks swap a chunk (the staged class-rounds)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.comm import schedules as tcs
    from repro_torch.core import schedules as ts
    from repro_torch.kernels import inkernel_collective as ik

    T = ts.Transfer
    swap = ts.Schedule("swap", 3, 0, 2, (ts.Round((T(0, 1, 0, 1, True), T(1, 0, 0, 1, True))),
                                         ts.Round((T(1, 2, 0, 2),))), kind="allreduce")
    gen = torch.Generator(device="cuda").manual_seed(0)
    bits = {2: torch.int16, 4: torch.int32}[torch.empty((), dtype=dt).element_size()]
    for sched in (ts.build("pipelined_chain", 4, 1, num_chunks=5),
                  tcs.build_op("allreduce", "fused_rsb", 4, 0, num_chunks=6), swap):
        low = ts.lower_schedule(sched)
        for cols in (1029, 1024):
            buf = torch.randn((sched.n, sched.num_chunks, cols), generator=gen,
                              device="cuda").to(dt)
            before = ik.inkernel_replay_shared.launches
            k = ik.inkernel_replay_shared(low, buf.clone())
            assert ik.inkernel_replay_shared.launches == before + 1
            p = ik.inkernel_replay_shared_plain(low, buf.clone())
            assert torch.equal(k.view(bits), p.view(bits)), (sched.name, cols)
    torch.cuda.synchronize()


def _mark_kept_rows(buf, tables) -> None:
    """-0.0, and NaN with a payload where the sum cannot reach it (f32, or
    a replay that only copies: PyTorch rounds a bf16 sum with a NaN to
    another payload), in every row that no class-round writes."""
    written = {(dst, int(tables.recv_start[c, s, dst]) + i)
               for c, perm in enumerate(tables.perms) for s in range(tables.num_rounds)
               for _src, dst in perm
               for i in range(int(tables.lo[c, s, dst]), int(tables.hi[c, s, dst]))}
    nan_ok = buf.dtype == torch.float32 or not tables.combine.any()
    bits = buf.view({2: torch.int16, 4: torch.int32}[buf.element_size()])
    for r in range(tables.n):
        for k in range(tables.num_chunks):
            if (r, k) not in written:
                buf[r, k, 0] = -0.0
                if nan_ok and buf.shape[2] > 1:
                    bits[r, k, 1] = 0x7FC3 if buf.dtype == torch.bfloat16 else 0x7FC01234


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_inkernel_rdma_matches_plain(dt):
    """The device-initiated replay: one launch per replay, bit-equal to its
    plain version and to the shared-buffer kernel, with -0.0 and NaN in kept
    rows, over a chain, a fused allreduce, a ring and a schedule in which
    two ranks swap a chunk (a STAGED class-round, whose puts read rows it
    merges, then a DIRECT one, in one launch), at widths under which the
    DIRECT spans take every start offset of source against destination
    mod 16 bytes (bf16 0-7 elements, f32 0-3), and at a width of 3 (spans
    shorter than a vector)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.comm import schedules as tcs
    from repro_torch.core import schedules as ts
    from repro_torch.kernels import inkernel_collective as ik

    T = ts.Transfer
    swap = ts.Schedule("swap", 3, 0, 2, (ts.Round((T(0, 1, 0, 1, True), T(1, 0, 0, 1, True))),
                                         ts.Round((T(1, 2, 0, 2),))), kind="allreduce")
    gen = torch.Generator(device="cuda").manual_seed(1)
    es = torch.empty((), dtype=dt).element_size()
    bits = {2: torch.int16, 4: torch.int32}[es]
    shifts = set()
    staged = 0
    for sched in (ts.build("pipelined_chain", 4, 1, num_chunks=5),
                  tcs.build_op("allreduce", "fused_rsb", 4, 0, num_chunks=6),
                  tcs.build_op("allreduce", "ring_allreduce", 8, 0), swap):
        low = ts.lower_schedule(sched)
        tables = ts.pack_tables(low)
        staged += int((ik.round_modes(tables) == ik.STAGED).sum())
        for cols in (3, 1024, 1029, 1030, 1031):
            shifts |= ik._direct_shifts(tables, cols, es)
            buf = torch.randn((sched.n, sched.num_chunks, cols), generator=gen,
                              device="cuda").to(dt)
            _mark_kept_rows(buf, tables)
            before = ik.rdma_replay.launches
            k = ik.rdma_replay(low, buf.clone())
            assert ik.rdma_replay.launches == before + 1
            p = ik.rdma_replay_plain(low, buf.clone())
            s = ik.inkernel_replay_shared(low, buf.clone())
            torch.cuda.synchronize()
            assert torch.equal(k.view(bits), p.view(bits)), (sched.name, cols)
            assert torch.equal(k.view(bits), s.view(bits)), (sched.name, cols)
    assert shifts == set(range(16 // es)), shifts
    assert staged > 0


def _flash_inputs(case, dt, seed):
    B, T, S, H, KV, hd = case[:6]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=gen, device="cuda").to(dt)
            for shape in ((B, T, H, hd), (B, S, KV, hd), (B, S, KV, hd))]


@pytest.mark.gpu
@pytest.mark.parametrize("kernel, dt", [("flash_attention", torch.float32),
                                        ("flash_attention", torch.bfloat16),
                                        ("flash_attention_sm90", torch.bfloat16)])
@pytest.mark.parametrize("case", [
    # B, T, S, H, KV, hd, causal, window, prefix, bq, bk
    (2, 128, 128, 4, 2, 32, True, None, 0, 64, 64),
    (1, 256, 256, 4, 1, 64, True, 64, 0, 64, 64),
    (1, 96, 96, 4, 2, 128, True, 40, 16, 32, 32),
    (1, 80, 80, 2, 2, 16, False, 24, 0, 16, 16),
    (2, 384, 384, 4, 2, 128, True, 100, 48, 64, 32),
    (1, 256, 256, 2, 2, 128, False, 0, 0, 64, 64),
    # head width 256 (both kernels; the sm90 one on 64-key tiles): a skipped
    # prefix tile, partial row and key tiles, a window with a prefix,
    # paligemma's caller tiles over its prefix
    (1, 128, 128, 2, 1, 256, True, None, 96, 32, 32),
    (1, 80, 80, 2, 1, 256, True, None, 0, 16, 16),
    (1, 384, 384, 2, 1, 256, True, 100, 48, 64, 32),
    (1, 512, 512, 4, 1, 256, True, None, 256, 256, 128),
    # head width 64 (both kernels): an odd group with a window, partial row
    # and key tiles under caller tiles below 128, window 0
    (1, 512, 512, 10, 2, 64, True, 128, 0, 128, 128),
    (1, 200, 200, 5, 1, 64, True, None, 0, 40, 40),
    (1, 256, 256, 2, 2, 64, False, 0, 0, 64, 64),
])
def test_flash_attention_matches_plain(kernel, dt, case):
    """Each kernel: one launch per call on its own counter, and within the
    tolerances of the plain version's f32 result (the kernels sum in another
    order): f32 as the reference's test, 2e-4; bf16 within one bf16
    rounding, 2^-8 |plain| + 1e-5. The sm90 kernel takes widths 64, 128 and
    256 and refuses 16 and 32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch import kernels
    from repro_torch.kernels import flash_attention as fa

    B, T, S, H, KV, hd, causal, window, prefix, bq, bk = case
    if kernel == "flash_attention_sm90" and hd not in fa.SM90_HEAD_DIMS:
        with pytest.raises(ValueError, match="head widths"):
            fa.flash_sm90(*_flash_inputs(case, dt, 0))
        return
    q, k, v = _flash_inputs(case, dt, T + hd)
    kw = dict(causal=causal, window=window, prefix=prefix, bq=bq, bk=bk)
    fn = {"flash_attention": fa.flash_fwd, "flash_attention_sm90": fa.flash_sm90}[kernel]
    before = kernels.launch_counts()
    got = fn(q, k, v, **kw)
    after = kernels.launch_counts()
    assert {n: after[n] - before[n] for n in after if after[n] != before[n]} == {kernel: 1}
    want = fa.flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    if dt == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    else:
        assert float(((got.float() - want).abs() / (2**-8 * want.abs() + 1e-5)).max()) <= 1.0
    if fa.kernel_route(dt, hd) == kernel:  # the public entry point takes this kernel
        assert torch.equal(fa.flash_attention(q, k, v, **kw), got)
    with pytest.raises(ValueError, match="contiguous"):
        fn(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [None, 1024])
def test_flash_sm90_at_the_serving_path_shape(window):
    """A gemma3-27b layer's prefill at 4096 tokens (phase 4c of
    chip_smoke.py): the route is the sm90 kernel, within one bf16 rounding
    of the plain version's f32 result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch import kernels
    from repro_torch.kernels import flash_attention as fa

    q, k, v = _flash_inputs((1, 4096, 4096, 32, 16, 128), torch.bfloat16, 3)
    kw = dict(causal=True, window=window, prefix=0)
    kernels.reset_launch_counts()
    got = fa.flash_attention(q, k, v, **kw)
    counts = kernels.launch_counts()
    assert counts["flash_attention_sm90"] == 1 and counts["flash_attention"] == 0
    want = fa.flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    assert float(((got.float() - want).abs() / (2**-8 * want.abs() + 1e-5)).max()) <= 1.0


@pytest.mark.gpu
def test_flash_sm90_at_the_hybrid_path_shape():
    """A hymba-1.5b layer's prefill at 4096 tokens (phase 12a of
    chip_smoke.py): q (1, 4096, 25, 64) over 5 kv heads (a group of 5),
    window 1024, caller tiles 128 x 128. One launch of the sm90 kernel and
    none of the CUDA-core one, within one bf16 rounding of the plain
    version's f32 result; a misaligned or a non-contiguous input raises and
    launches nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch import kernels
    from repro_torch.kernels import flash_attention as fa

    q, k, v = _flash_inputs((1, 4096, 4096, 25, 5, 64), torch.bfloat16, 5)
    kw = dict(causal=True, window=1024, prefix=0, bq=128, bk=128)
    kernels.reset_launch_counts()
    got = fa.flash_attention(q, k, v, **kw)
    counts = kernels.launch_counts()
    assert counts["flash_attention_sm90"] == 1 and counts["flash_attention"] == 0, counts
    want = fa.flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    assert float(((got.float() - want).abs() / (2**-8 * want.abs() + 1e-5)).max()) <= 1.0
    misaligned = torch.empty(q.numel() + 8, dtype=q.dtype, device="cuda")[1:1 + q.numel()]
    misaligned = misaligned.view(q.shape).copy_(q)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention(misaligned, k, v, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2), v, **kw)
    after = kernels.launch_counts()
    assert after["flash_attention_sm90"] == 1 and after["flash_attention"] == 0, after


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_flash_fwd_at_the_vlm_path_shape(dt):
    """A paligemma-3b layer's prefill at 4096 positions (phase 4d of
    chip_smoke.py): q (1, 4096, 8, 256), k/v (1, 4096, 1, 256), the prefix
    of 256 under query tiles of 256. The route is the sm90 kernel in bf16
    (within one bf16 rounding of the plain version's f32 result) and the
    CUDA-core kernel in f32 (within 2e-4). A bf16 call on a misaligned or a
    non-contiguous tensor raises and launches nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch import kernels
    from repro_torch.kernels import flash_attention as fa

    q, k, v = _flash_inputs((1, 4096, 4096, 8, 1, 256), dt, 4)
    kw = dict(causal=True, window=None, prefix=256, bq=256, bk=128)
    kernels.reset_launch_counts()
    got = fa.flash_attention(q, k, v, **kw)
    counts = kernels.launch_counts()
    route = "flash_attention_sm90" if dt == torch.bfloat16 else "flash_attention"
    want_counts = {"flash_attention_sm90": 0, "flash_attention": 0, route: 1}
    assert {n: counts[n] for n in want_counts} == want_counts
    assert fa.kernel_route(dt, 256) == route
    want = fa.flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    if dt == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
        return
    assert float(((got.float() - want).abs() / (2**-8 * want.abs() + 1e-5)).max()) <= 1.0
    misaligned = torch.empty(q.numel() + 8, dtype=q.dtype, device="cuda")[1:1 + q.numel()]
    misaligned = misaligned.view(q.shape).copy_(q)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention(misaligned, k, v, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, **kw)
    after = kernels.launch_counts()
    assert after["flash_attention_sm90"] == 1 and after["flash_attention"] == 0, after


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_param_updates_match_plain(dt):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import param_update as pu

    gen = torch.Generator(device="cuda").manual_seed(2)
    w = torch.randn(70_001, generator=gen, device="cuda").to(dt)
    u = torch.randn(70_001, generator=gen, device="cuda").to(dt)
    bits = {2: torch.int16, 4: torch.int32}[w.element_size()]
    for ws, us in ((w, u), (w[1:], u[1:])):
        for a in (0.25, 0.01):
            assert torch.equal(pu.mix(ws, us, a).view(bits), pu.mix_plain(ws, us, a).view(bits))
            assert torch.equal(pu.scaled_add(ws, us, a).view(bits),
                               pu.scaled_add_plain(ws, us, a).view(bits))
    torch.cuda.synchronize()
