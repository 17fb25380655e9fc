#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. card: name and power limit (``nvidia-smi``); build the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` with ``nvcc`` for sm_90a, one process per
   source, all at once; calibrate the per-transfer and per-launch times the
   H100 cost profile quotes.
2. kernels, each held bit for bit against its plain PyTorch version, with
   CUDA-event times, the bound (bytes / 3.35 TB/s), the plain version's time
   and a one-call PyTorch yardstick where one exists: the merge and the copy
   at the serving path's shapes, the quantize pair at the training path's
   hop shape, the merge again at the training path's rounds, and the
   in-kernel replay (also against the numpy simulator) at small shapes over
   every builder and at the path shapes, beside the compiled executor's
   replay of the same plan.
3. serving, default policy: minitron-8b at full width (8 of 32 layers,
   bf16, seeded random weights) on an emulated data axis of 4 ranks;
   ``Engine(distribute=True, double_buffer=True)`` broadcasts the weights,
   then ``generate`` serves batch 4, prompt 128, 32 decode steps; a warm
   re-run of the same loop times prefill and the decode steps apart.
4. compiled replay: the same weights broadcast again from NaN-filled
   replicas with the pinned pipelined chain and the compiled executor.
4b. tuned in-kernel replay: a tuner table built on the card (each serving
   bucket's analytic plan, timed as one in-kernel replay, recorded with
   ``exec_path='inkernel'``, saved, loaded), then
   ``distribute_weights(tuner=...)`` from NaN-filled replicas: replicas
   bit-equal to phase 3's, one in-kernel launch per bucket plan, no merge
   launches.
5. a small-input reference: the port's f32 smoke model on the card against
   the same model on the CPU.
6. training: minitron-8b at full width (1 of 32 layers, bf16, seeded
   weights) on 4 emulated data ranks, global batch 8 x 512 tokens, 3 steps
   in each sync mode from the same weights and batches: grad_allreduce,
   param_bcast, tuned_allreduce (compiled executor: fused_combine), and
   compressed_allreduce over bf16 (the passthrough), int8 and fp8 wires
   (compiled: the quantize kernels); then param_bcast and tuned_allreduce
   again with the synced gradient rows compared; then tuned_allreduce with
   ``RunConfig.tuner_table`` naming two tables that differ only in
   ``exec_path`` (compiled, then inkernel). Checks: equal step-0 losses,
   bit-equal synced rows in the two reruns, the bf16 wire's parameters
   bit-identical to tuned_allreduce's, the in-kernel table's parameters
   bit-identical to the compiled table's (with no merge launch and one
   in-kernel launch per bucket plan and step), the bf16-wire modes' last
   losses and per-step grad norms close to grad_allreduce's (the plain
   mean, which runs none of the port's kernels), int8's last loss within
   5e-3 of tuned_allreduce's, finite losses; then one f32 smoke
   param_bcast run on the card against the CPU.

Launch counts are zeroed right before each path and read right after it:
phases 3-4 (the serving path), phase 4b's distribution (the tuned serving
path) and phase 6's runs (the training path); the launches that compare
kernels with their plain versions, and the replays timed to fill the tuner
tables, are not counted. The last three lines of output are the kernels
JSON, the card, and ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BATCH, PROMPT, STEPS, RANKS, LAYERS = 4, 128, 32, 4, 8
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LAYERS = 8, 512, 3, 1
TRAIN_MODES = (  # (label, RunConfig fields)
    ("grad_allreduce", {"sync_mode": "grad_allreduce"}),
    ("param_bcast", {"sync_mode": "param_bcast"}),
    ("tuned_allreduce", {"sync_mode": "tuned_allreduce", "compiled_collectives": True}),
    ("compressed_bf16", {"sync_mode": "compressed_allreduce", "wire_format": "bf16",
                         "compiled_collectives": True}),
    ("compressed_int8", {"sync_mode": "compressed_allreduce", "wire_format": "int8",
                         "compiled_collectives": True}),
    ("compressed_fp8", {"sync_mode": "compressed_allreduce", "wire_format": "fp8",
                        "compiled_collectives": True}),
)
TRAIN_RUN = {"learning_rate": 1e-3, "warmup_steps": 1, "total_steps": TRAIN_STEPS, "seed": 0}
ROW_CHECKED = ("param_bcast", "tuned_allreduce")  # rerun with the synced rows compared


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bits(torch, t):
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def same_bits(torch, a, b) -> bool:
    return bool(torch.equal(bits(torch, a), bits(torch, b)))


def max_abs_err(torch, a, b) -> float:
    a, b = a.float(), b.float()
    both_nan = torch.isnan(a) & torch.isnan(b)
    return float(torch.where(both_nan, 0.0, (a - b).abs()).max())


def calibrate(torch) -> dict:
    """Per-transfer and per-launch times of the emulated mesh (the ``ts``
    and ``t_launch`` of the H100 cost profile): one point-to-point transfer
    of a 1 KiB block between two ranks through the unrolled executor, and
    one fused_combine launch on a 1 KiB block."""
    from repro_torch.comm.executors import execute_collective
    from repro_torch.core.schedules import chain
    from repro_torch.kernels.combine_update import fused_combine_update

    buf = torch.randn((2, 1, 512), device="cuda").to(torch.bfloat16)
    sched = chain(2)
    ts_ms = time_ms(torch, lambda: execute_collective(sched, buf), reps=2000, warmup=50)
    recv = torch.randn((2, 1, 512), device="cuda").to(torch.bfloat16)
    zero = torch.zeros(2, dtype=torch.int32, device="cuda")
    one = torch.ones(2, dtype=torch.int32, device="cuda")
    tl_ms = time_ms(torch, lambda: fused_combine_update(buf, recv, zero, zero, one, 0),
                    reps=2000, warmup=50)
    return {"ts_s": ts_ms * 1e-3, "t_launch_s": tl_ms * 1e-3}


def check_fused_combine(torch) -> dict:
    """fused_combine at (8, 262144) and (1, 16384000), bf16 and f32, with
    -0.0 and NaN payloads in KEEP rows; then fused_combine_update at the
    round shape phase 4 gives it on the embedding bucket, which is the
    kernel's line in the kernels JSON."""
    from repro_torch.kernels import combine_update as cu

    gen = torch.Generator(device="cuda").manual_seed(1)
    for shape in ((8, 262144), (1, 16384000)):
        for dt in (torch.bfloat16, torch.float32):
            B, C = shape
            cur = torch.randn(shape, generator=gen, device="cuda").to(dt)
            recv = torch.randn(shape, generator=gen, device="cuda").to(dt)
            modes = [0, 1, 2, 0, 1, 2, 0, 2][:B] if B > 1 else [2]
            mode = torch.tensor(modes, dtype=torch.int32, device="cuda").reshape(B, 1)
            for r, m in enumerate(modes):
                if m == cu.KEEP:
                    cur[r, 0] = -0.0
                    cur[r, 1] = float("nan")
                    bits(torch, cur)[r, 2] = 0x7FC3 if dt == torch.bfloat16 else 0x7FC01234
            k = cu.fused_combine(cur.clone(), recv, mode)
            p = cu.fused_combine_plain(cur.clone(), recv, mode)
            torch.cuda.synchronize()
            assert same_bits(torch, k, p), f"fused_combine {shape} {dt} differs from plain"
            work = cur.clone()
            ms = time_ms(torch, lambda: cu.fused_combine(work, recv, mode))
            log(f"kernel fused_combine {shape} {str(dt)[6:]}: bit-equal to plain, "
                f"{ms:.4f} ms")

    # one round of phase 4's compiled pipelined chain on the embedding bucket,
    # chunked as the planner chunks it: ranks 1..3 overwrite one chunk each
    from repro_torch.comm import plan_cached
    from repro_torch.configs import get_config

    cfg = get_config("minitron-8b")
    N = cfg.padded_vocab * cfg.d_model
    chunks = plan_cached("bcast", N * 2, RANKS, algo="pipelined_chain").num_chunks
    n, K, C = RANKS, 2, -(-N // chunks)
    buf = torch.randn((n, K, C), generator=gen, device="cuda").to(torch.bfloat16)
    recv = torch.randn((n, 1, C), generator=gen, device="cuda").to(torch.bfloat16)
    start = torch.tensor([0, 0, 1, 1], dtype=torch.int32, device="cuda")
    lo = torch.tensor([0, 0, 0, 0], dtype=torch.int32, device="cuda")
    hi = torch.tensor([0, 1, 1, 1], dtype=torch.int32, device="cuda")
    k = cu.fused_combine_update(buf.clone(), recv, start, lo, hi, 0)
    p = cu.fused_combine_update_plain(buf.clone(), recv, start, lo, hi, 0)
    torch.cuda.synchronize()
    assert same_bits(torch, k, p), "fused_combine_update differs from plain"
    err = max_abs_err(torch, k, p)
    work = buf.clone()
    ms = time_ms(torch, lambda: cu.fused_combine_update(work, recv, start, lo, hi, 0))
    plain_ms = time_ms(torch, lambda: cu.fused_combine_update_plain(work, recv, start, lo, hi, 0),
                       reps=5)
    moved = 3 * 2 * C * 2  # 3 destination rows: read recv, write the row
    line = {"name": "fused_combine", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/combine_update.cu",
            "replaces": "src/repro/kernels/combine_update.py:52",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None, "shape": [n, K, C], "dtype": "bfloat16"}
    log(f"kernel fused_combine_update ({n}, {K}, {C}) bf16 overwrite round "
        f"({chunks} chunks): bit-equal, {ms:.4f} ms (bound {line['bound_ms']:.4f} ms, "
        f"plain {plain_ms:.4f} ms)")
    return line


def check_fused_combine_training(torch) -> None:
    """fused_combine_update at the training path's round shapes, bit for
    bit against its plain version: on the embedding bucket, one accumulate
    and one overwrite round of the int8 compressed allreduce plan (f32 at
    the plan's odd chunk width) and of the tuned bf16 allreduce plan, each
    with the start/lo/hi rows of its lowered plan's round tables."""
    import numpy as np

    from repro_torch.comm import plan_cached
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.kernels import combine_update as cu

    cfg = get_config("minitron-8b")
    N = cfg.padded_vocab * cfg.d_model
    algo = RunConfig().allreduce_algo
    gen = torch.Generator(device="cuda").manual_seed(5)
    for label, dt, fmt in (("compressed int8", torch.float32, "int8"),
                           ("tuned", torch.bfloat16, None)):
        esize = 4 if dt == torch.float32 else 2
        plan = plan_cached("allreduce", N * esize, RANKS, algo=algo, wire_format=fmt)
        low = plan.lowered()
        K = low.num_chunks
        C = -(-N // K)
        buf = torch.randn((RANKS, K, C), generator=gen, device="cuda").to(dt)
        ref = buf.clone()
        for combine, name in ((1, "accumulate"), (0, "overwrite")):
            cls, r = next((c, r) for c in low.classes for r in range(low.num_rounds)
                          if int(c.combine[r]) == combine and (c.hi[r] > c.lo[r]).any())
            tab = torch.from_numpy(np.stack([cls.recv_start[r], cls.lo[r], cls.hi[r]])).to(
                device="cuda", dtype=torch.int32)
            recv = torch.randn((RANKS, cls.block, C), generator=gen, device="cuda").to(dt)
            cu.fused_combine_update(buf, recv, tab[0], tab[1], tab[2], combine)
            cu.fused_combine_update_plain(ref, recv, tab[0], tab[1], tab[2], combine)
            torch.cuda.synchronize()
            assert same_bits(torch, buf, ref), \
                f"fused_combine_update {label} {name} round differs from plain"
            ms = time_ms(torch, lambda: cu.fused_combine_update(buf, recv, tab[0], tab[1],
                                                                tab[2], combine), reps=10)
            ref.copy_(buf)
            rows = int((cls.hi[r] - cls.lo[r]).sum())
            bound = rows * C * esize * (3 if combine else 2) / HBM_BYTES_PER_S * 1e3
            log(f"kernel fused_combine_update ({RANKS}, {K}, {C}) {str(dt)[6:]} {label} "
                f"{plan.algo} {name} round ({rows} rows): bit-equal, {ms:.4f} ms "
                f"(bound {bound:.4f} ms)")
        del buf, ref, recv


def check_chunked_copy(torch) -> dict:
    from repro_torch.kernels.chunked_copy import chunked_copy, chunked_copy_plain

    gen = torch.Generator(device="cuda").manual_seed(2)
    small = torch.randn(1003, generator=gen, device="cuda")
    for x in (small, small[1:]):  # ragged, and 4 bytes off 16-byte alignment
        assert same_bits(torch, chunked_copy(x), chunked_copy_plain(x))
    log("kernel chunked_copy (1003,) and (1002,) f32 unaligned: bit-equal to plain")
    N = 1_048_576_000 + 37
    x = torch.randn(N, generator=gen, device="cuda").to(torch.bfloat16)
    k = chunked_copy(x)
    p = chunked_copy_plain(x)
    torch.cuda.synchronize()
    assert same_bits(torch, k, p), "chunked_copy differs from plain"
    err = max_abs_err(torch, k, p)
    del k, p
    ms = time_ms(torch, lambda: chunked_copy(x), reps=10)
    plain_ms = time_ms(torch, lambda: chunked_copy_plain(x), reps=10)
    library_ms = time_ms(torch, lambda: x.clone(), reps=10)
    line = {"name": "chunked_copy", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/chunked_copy.cu",
            "replaces": "src/repro/kernels/chunked_copy.py:37",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": 2 * N * 2 / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": library_ms, "shape": [N], "dtype": "bfloat16"}
    log(f"kernel chunked_copy ({N},) bf16: bit-equal, {ms:.4f} ms "
        f"(bound {line['bound_ms']:.4f} ms, plain {plain_ms:.4f} ms, clone {library_ms:.4f} ms)")
    return line


def _quant_bits_equal(torch, a, b) -> tuple[bool, int]:
    """(bit-equal where not both NaN, count of both-NaN positions whose
    payload bits differ)."""
    nan = (a.float().isnan() & b.float().isnan())
    view = {1: torch.uint8, 4: torch.int32}[a.element_size()]
    same = a.view(view) == b.view(view)
    return bool((same | nan).all()), int((nan & ~same).sum())


def embed_wire_block() -> tuple[int, int]:
    """(rows, width) of one compressed hop on the training path's largest
    bucket, the embedding's: the planner's int8 allreduce plan chunks it,
    and a class round quantizes the rows its active pairs merge."""
    from repro_torch.comm import plan_cached
    from repro_torch.configs import get_config

    cfg = get_config("minitron-8b")
    N = cfg.padded_vocab * cfg.d_model
    plan = plan_cached("allreduce", N * 4, RANKS, wire_format="int8")
    low = plan.lowered()
    rows = max(sum(int(cls.hi[s, d] - cls.lo[s, d]) for _src, d in cls.perm)
               for cls in low.classes for s in range(low.num_rounds))
    return rows, -(-N // plan.schedule.num_chunks)


def check_quantize(torch) -> list[dict]:
    """quantize_blocks / dequantize_blocks against their plain versions, bit
    for bit, int8 and fp8: a ragged width, the training path's odd width,
    an all-zero block, +-1e30 and 1e-30, a NaN block, zero rows; then
    times at the embedding bucket's hop shape (the kernels JSON lines)."""
    from repro_torch.kernels import quantize as qk

    gen = torch.Generator(device="cuda").manual_seed(4)
    rows, C = embed_wire_block()
    small = torch.randn((3, 1000), generator=gen, device="cuda") * 3
    small[1, :256] = 0.0
    small[2, 0], small[2, 1], small[2, 2:10] = 1e30, -1e30, 1e-30
    small[0, 300] = float("nan")
    wide = torch.randn((rows, C), generator=gen, device="cuda")
    wide[0, 256:512] = 0.0
    wide[1, 1:3] = 1e30
    wide[-1, C - 5] = float("nan")
    nan_payload = 0
    for fmt in ("int8", "fp8"):
        for x in (small, small[:, 1:], small[:0], wide):
            v, s = qk.quantize_blocks(x, fmt)
            pv, ps = qk.quantize_blocks_plain(x, fmt)
            torch.cuda.synchronize()
            for a, b in ((v, pv), (s, ps)):
                ok, differ = _quant_bits_equal(torch, a, b)
                assert ok and a.shape == b.shape, f"quantize_blocks {fmt} {tuple(x.shape)} differs"
                nan_payload += differ
            d = qk.dequantize_blocks(v, s, out_cols=x.shape[1])
            pd = qk.dequantize_blocks_plain(pv, ps, out_cols=x.shape[1])
            torch.cuda.synchronize()
            ok, differ = _quant_bits_equal(torch, d, pd)
            assert ok and d.shape == pd.shape, f"dequantize_blocks {fmt} {tuple(x.shape)} differs"
            nan_payload += differ
    log(f"kernel quantize/dequantize int8+fp8 at (3, 1000), (3, 999), (0, 1000), "
        f"({rows}, {C}): bit-equal to plain ({nan_payload} NaN positions with other "
        "payload bits)")

    one_way = rows * C * (4 + 1 + 4 / 256)  # f32 in, a byte and 1/256 scale out
    v, s = qk.quantize_blocks(wide, "int8")
    pv, ps = qk.quantize_blocks_plain(wide, "int8")
    out = torch.empty_like(wide)
    d = qk.dequantize_blocks(v, s, out_cols=C, out=out)
    pd = qk.dequantize_blocks_plain(pv, ps, out_cols=C)
    torch.cuda.synchronize()
    lines = []
    for name, err, fn, plain, src in (
        ("quantize_blocks", max_abs_err(torch, v, pv), lambda: qk.quantize_blocks(wide, "int8"),
         lambda: qk.quantize_blocks_plain(wide, "int8"), "quantize.py:73"),
        ("dequantize_blocks", max_abs_err(torch, d, pd),
         lambda: qk.dequantize_blocks(v, s, out_cols=C, out=out),
         lambda: qk.dequantize_blocks_plain(pv, ps, out_cols=C), "quantize.py:101"),
    ):
        ms = time_ms(torch, fn, reps=10)
        plain_ms = time_ms(torch, plain, reps=3, warmup=1)
        line = {"name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/quantize.cu",
                "replaces": f"src/repro/kernels/{src}",
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": one_way / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                "library_ms": None, "shape": [rows, C], "dtype": "float32/int8"}
        log(f"kernel {name} ({rows}, {C}) int8: {ms:.4f} ms (bound {line['bound_ms']:.4f} ms, "
            f"plain {plain_ms:.4f} ms)")
        lines.append(line)
    return lines


def _small_schedules(n: int, K: int) -> list:
    """Every builder of the port at (n, K), and for n == 3 two hand-made
    schedules in which ranks swap a chunk (overwrite and accumulate): the
    class-rounds that stage through the landing scratch."""
    from repro_torch.comm import schedules as tcs
    from repro_torch.core import schedules as ts

    out = [
        ts.build("direct", n), ts.build("chain", n),
        ts.build("pipelined_chain", n, 1 % n, num_chunks=K), ts.build("binomial", n),
        tcs.build_op("reduce", "binomial_reduce", n, 0),
        tcs.build_op("reduce", "pipelined_reduce_chain", n, 0, num_chunks=K),
        tcs.build_op("allreduce", "fused_rsb", n, 0, num_chunks=K),
        tcs.build_op("allgather", "ring_allgather", n, 0),
        tcs.build_op("reduce_scatter", "ring_reduce_scatter", n, 0),
    ]
    if n >= 3:
        out.append(tcs.build_op("allreduce", "ring_allreduce", n, 0))
    if n >= 4:
        out.append(ts.build("bidir_chain", n, 0, num_chunks=K))
    if n >= 4 and n & (n - 1) == 0:
        out += [ts.build("scatter_allgather", n), ts.build("knomial", n, k=4)]
    if n == 3:
        T = ts.Transfer
        for comb in (False, True):
            out.append(ts.Schedule("swap", 3, 0, 2, (
                ts.Round((T(0, 1, 0, 1, comb), T(1, 0, 0, 1, comb))),
                ts.Round((T(1, 2, 0, 2, comb),)),
                ts.Round((T(2, 0, 1, 1, comb), T(0, 2, 1, 1, comb), T(1, 0, 0, 1, comb))),
            ), kind="allreduce" if comb else "bcast"))
    return out


def _mark_kept_rows(torch, buf, tables) -> int:
    """-0.0 (and NaN, where the replay only copies or the type is f32) in
    the first columns of every row that no class-round writes. The bf16
    sum of a NaN rounds to another payload in PyTorch than in the kernel,
    so bf16 NaNs go only where nothing accumulates. Returns the rows
    marked."""
    written = set()
    for c, perm in enumerate(tables.perms):
        for s in range(tables.num_rounds):
            for _src, dst in perm:
                r0 = int(tables.recv_start[c, s, dst])
                written.update((dst, r0 + i) for i in range(int(tables.lo[c, s, dst]),
                                                             int(tables.hi[c, s, dst])))
    nan_ok = buf.dtype == torch.float32 or not tables.combine.any()
    kept = [(r, k) for r in range(tables.n) for k in range(tables.num_chunks)
            if (r, k) not in written]
    for r, k in kept:
        buf[r, k, 0] = -0.0
        if nan_ok and buf.shape[2] > 2:
            buf[r, k, 1] = float("nan")
            bits(torch, buf)[r, k, 2] = 0x7FC3 if buf.dtype == torch.bfloat16 else 0x7FC01234
    return len(kept)


def _sim_check(torch, low, x, cols) -> None:
    """Replay integer-valued ``x`` (exact in f32 and bf16) with the kernel
    and hold the columns ``cols`` against the port's numpy simulator; the
    replay acts on whole rows, so any column subset is a full check."""
    from repro_torch.core.simulator import simulate_lowered
    from repro_torch.kernels.inkernel_collective import inkernel_replay_shared

    before = x[:, :, cols].float().cpu().numpy()
    inkernel_replay_shared(low, x)
    torch.cuda.synchronize()
    want = simulate_lowered(low, list(before))
    got = x[:, :, cols].float().cpu().numpy()
    for r in range(x.shape[0]):
        assert (got[r] == want[r]).all(), (low.name, r, "kernel differs from simulate_lowered")


def check_inkernel(torch) -> dict:
    """inkernel_replay against its plain version and the numpy simulator,
    bit for bit: every builder at n in {2, 3, 4, 8}, K in {1, 4, 5}, widths
    37 (element path) and 64 (vector path), bf16 and f32, with -0.0 and NaN
    in kept rows, and the swap schedules; then at the path shapes (the
    serving chain of phase 4, phase 4b's analytic plan and the training
    fused_rsb plan on the embedding bucket), with the compiled executor's
    replay of the same plan on the same buffer timed beside it. The
    training plan is the kernel's line in the kernels JSON."""
    import ctypes

    from repro_torch.comm import plan_cached
    from repro_torch.comm.executors import execute_compiled
    from repro_torch.configs import get_config
    from repro_torch.core.schedules import lower_schedule, pack_tables
    from repro_torch.kernels import _build
    from repro_torch.kernels import inkernel_collective as ik

    gen = torch.Generator(device="cuda").manual_seed(6)
    lib = _build.load("inkernel_collective")
    lib.repro_inkernel_grid.argtypes = [ctypes.c_int, ctypes.c_int]
    grids = {f"{d}/{'vec' if v else 'elem'}": lib.repro_inkernel_grid(code, v)
             for d, code in (("f32", 0), ("bf16", 1)) for v in (1, 0)}
    log(f"kernel inkernel_replay: cooperative grids (blocks of 256) {grids}")
    cases = staged = marked = 0
    for n in (2, 3, 4, 8):
        for K in (1, 4, 5):
            for sched in _small_schedules(n, K):
                low = lower_schedule(sched)
                tables = pack_tables(low)
                staged += int((ik.round_modes(tables) == ik.STAGED).sum())
                for dt in (torch.bfloat16, torch.float32):
                    for cols in (37, 64):
                        shape = (n, low.num_chunks, cols)
                        buf = torch.randn(shape, generator=gen, device="cuda").to(dt)
                        marked += _mark_kept_rows(torch, buf, tables)
                        k = ik.inkernel_replay_shared(low, buf.clone())
                        p = ik.inkernel_replay_shared_plain(low, buf.clone())
                        torch.cuda.synchronize()
                        assert same_bits(torch, k, p), (sched.name, n, K, dt, cols)
                        ints = torch.empty(shape, device="cuda", dtype=dt).random_(-4, 5,
                                                                                  generator=gen)
                        _sim_check(torch, low, ints, list(range(cols)))
                        cases += 1
    assert staged > 0, "no small case exercised the staged path"
    log(f"kernel inkernel_replay: {cases} small cases bit-equal to plain and to "
        f"simulate_lowered ({staged} staged class-rounds, {marked} kept rows marked)")

    cfg = get_config("minitron-8b")
    N = cfg.padded_vocab * cfg.d_model
    line = None
    for label, op, algo in (("serving chain (phase 4)", "bcast", "pipelined_chain"),
                            ("serving analytic (phase 4b)", "bcast", "auto"),
                            ("training fused_rsb (phase 6)", "allreduce", "auto")):
        plan = plan_cached(op, N * 2, RANKS, algo=algo)
        low = plan.lowered()
        tables = pack_tables(low)
        K, C = low.num_chunks, -(-N // low.num_chunks)
        buf = torch.randn((RANKS, K, C), generator=gen, device="cuda", dtype=torch.bfloat16)
        kept = _mark_kept_rows(torch, buf, tables)
        k = ik.inkernel_replay_shared(low, buf.clone())
        p = ik.inkernel_replay_shared_plain(low, buf.clone())
        torch.cuda.synchronize()
        assert same_bits(torch, k, p), f"inkernel_replay {label} differs from plain"
        err = 0.0  # bit-equal (a float copy of 4.2e9 elements would not fit beside them)
        del p
        c = execute_compiled(low, buf.clone())
        torch.cuda.synchronize()
        assert same_bits(torch, k, c), f"inkernel_replay {label} differs from execute_compiled"
        del c, buf
        ms = time_ms(torch, lambda: ik.inkernel_replay_shared(low, k), reps=5, warmup=1)
        compiled_ms = time_ms(torch, lambda: execute_compiled(low, k), reps=3, warmup=1)
        plain_ms = time_ms(torch, lambda: ik.inkernel_replay_shared_plain(low, k),
                           reps=2, warmup=1)
        k.random_(-4, 5, generator=gen)
        _sim_check(torch, low, k, list(range(64)) + list(range(C - 64, C)))
        del k
        torch.cuda.empty_cache()
        moved = ik.replay_bytes(tables, C, 2)
        bound = moved / HBM_BYTES_PER_S * 1e3
        modes = ik.round_modes(tables)
        ran, stage = int((modes != ik.SKIP).sum()), int((modes == ik.STAGED).sum())
        log(f"kernel inkernel_replay {label}: {plan.algo}, ({RANKS}, {K}, {C}) bf16, "
            f"{low.num_rounds} rounds x {low.num_classes} classes ({ran} class-rounds, "
            f"{stage} staged, {ran - 1 + stage} grid barriers), {kept} kept rows marked: "
            f"bit-equal to plain, to execute_compiled and (64 + 64 columns) to "
            f"simulate_lowered; {ms:.4f} ms (bound {bound:.4f} ms for {moved / 1e9:.3f} GB, "
            f"compiled {compiled_ms:.4f} ms, plain {plain_ms:.4f} ms)")
        if op == "allreduce":
            line = {"name": "inkernel_replay", "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/inkernel_collective.cu",
                    "replaces": "src/repro/kernels/inkernel_collective.py:136",
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound, "bound_by": "bytes", "library_ms": None,
                    "compiled_ms": compiled_ms, "plan": f"{plan.algo} K={K}",
                    "shape": [RANKS, K, C], "dtype": "bfloat16"}
    return line


def replicas_equal(torch, stacked, root=None) -> bool:
    from repro_torch.core.tree import tree_leaves

    roots = None if root is None else tree_leaves(root)
    for i, leaf in enumerate(tree_leaves(stacked)):
        ref = leaf[:1] if roots is None else roots[i][None]
        if not bool((bits(torch, leaf) == bits(torch, ref)).all()):
            return False
    return True


def serve(torch) -> tuple[dict, object]:
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    from repro_torch.serve import Engine

    cfg = dataclasses.replace(get_config("minitron-8b"), num_layers=LAYERS)
    params = Model(cfg).init(seed=0, device="cuda")
    n_params = sum(t.numel() for t in tree_leaves(params))
    mesh = make_mesh(RANKS, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = Engine(cfg, params, mesh=mesh, distribute=True, double_buffer=True)
    torch.cuda.synchronize()
    dist_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    assert counts["chunked_copy"] > 0, counts
    # every row, the root's included, against the weights that were loaded
    assert replicas_equal(torch, engine.params, params), "a replica differs from the loaded weights"
    del params

    rng = np.random.RandomState(0)
    tokens = rng.randint(0, cfg.vocab_size - 1, size=(BATCH, PROMPT))
    t0 = time.perf_counter()
    res = engine.generate({"tokens": tokens}, steps=STEPS)
    gen_s = time.perf_counter() - t0
    assert res.tokens.shape == (BATCH, STEPS) and res.logprobs.shape == (BATCH, STEPS)
    assert ((res.tokens >= 0) & (res.tokens < cfg.padded_vocab)).all()
    assert np.isfinite(res.logprobs).all() and (res.logprobs <= 0).all()
    peak = torch.cuda.max_memory_allocated()

    prefill_s, decode_s = time_prefill_decode(torch, engine, tokens)
    out = {
        "params": n_params, "replica_bytes": n_params * 2,
        "distribute_s": dist_s, "chunked_copy_launches": counts["chunked_copy"],
        "generate_s": gen_s, "prefill_ms_per_rank": prefill_s / RANKS * 1e3,
        "decode_tokens_per_s": BATCH * STEPS / decode_s,
        "max_memory_allocated": peak, "first_tokens": res.tokens[:, :4].tolist(),
    }
    log(f"serve: {n_params} params, distribution {dist_s:.3f} s "
        f"({counts['chunked_copy']} chunked_copy launches), generate {gen_s:.3f} s (cold, "
        f"whole call); warm: prefill {out['prefill_ms_per_rank']:.2f} ms/rank, "
        f"decode steps {out['decode_tokens_per_s']:.1f} tok/s; peak {peak / 2**30:.2f} GiB")
    return out, engine


def time_prefill_decode(torch, engine, tokens) -> tuple[float, float]:
    """A warm re-run of ``generate``'s greedy loop, rank by rank on each
    rank's replica, with prefill and the decode steps (``decode_step`` and
    the argmax) timed in separate windows, each closed by a synchronize.
    Returns the seconds of all ranks' prefills and of all their decode
    steps."""
    tok = torch.as_tensor(tokens, device="cuda")
    prefill_s = decode_s = 0.0
    with torch.no_grad():
        for r, part in enumerate(torch.tensor_split(tok, RANKS)):
            params = engine.replica(r)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = engine.model.prefill(params, {"tokens": part},
                                                  max_len=PROMPT + STEPS)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            nxt = torch.argmax(logits[:, -1], dim=-1)
            for i in range(STEPS):
                logits, caches = engine.model.decode_step(params, nxt[:, None], caches,
                                                          PROMPT + i)
                nxt = torch.argmax(logits[:, 0], dim=-1)
            torch.cuda.synchronize()
            prefill_s += t1 - t0
            decode_s += time.perf_counter() - t1
    return prefill_s, decode_s


def compiled_replay(torch, root, mesh) -> tuple[dict, dict]:
    """``root``: phase 3's root replica (a copy; the engine is gone). Row 0
    of the new stack is that copy, so the replicas are held against it.
    Returns the phase's numbers and the distributed tree."""
    from repro_torch import kernels
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.serve import distribute_weights, replicate

    stacked = replicate(root, RANKS, fill_root_only=True)
    root.clear()  # row 0 of the stack holds it now
    for leaf in tree_leaves(stacked):
        leaf[1:].fill_(float("nan"))
    before = kernels.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, plans = distribute_weights(stacked, mesh, algo="pipelined_chain", compiled=True,
                                    double_buffer=True, return_plans=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    after = kernels.launch_counts()
    launched = after["fused_combine"] - before["fused_combine"]
    assert launched > 0, (before, after)
    assert replicas_equal(torch, out, tree_map(lambda t: t[0], stacked)), \
        "compiled replicas differ from phase 3's"
    rounds = sum(p.lowered().num_rounds for ps in plans.values() for p in ps)
    log(f"compiled: pipelined_chain over {len(plans['data'])} buckets, {rounds} rounds, "
        f"{launched} fused_combine launches, {secs:.3f} s, replicas bit-equal to phase 3")
    return {"distribute_s": secs, "fused_combine_launches": launched, "rounds": rounds}, out


def record_inkernel_table(torch, tuner, buckets, op: str, extras: list[dict]) -> list:
    """For each bucket ``(bytes, elements, dtype)``: the analytic plan's
    algo and chunk count, one timed in-kernel replay of it on a scratch
    buffer of the bucket's chunked shape (after one warm-up replay), and a
    ``record`` into each tuner of ``tuner`` with the matching ``extras``.
    Returns ``(algo, chunks, rounds, classes, ms)`` per bucket."""
    from repro_torch.comm import plan_cached
    from repro_torch.kernels.inkernel_collective import inkernel_replay_shared

    rows = []
    for M, elems, dtype in buckets:
        plan = plan_cached(op, M, RANKS)
        low = plan.lowered()
        buf = torch.zeros((RANKS, low.num_chunks, -(-elems // low.num_chunks)), dtype=dtype,
                          device="cuda")
        ms = time_ms(torch, lambda: inkernel_replay_shared(low, buf), reps=1, warmup=1)
        del buf
        for t, ex in zip(tuner, extras):
            t.record(M, RANKS, plan.algo, plan.num_chunks, ms * 1e-3, op=op, extras=ex)
        rows.append((plan.algo, plan.num_chunks, low.num_rounds, low.num_classes, ms))
    torch.cuda.empty_cache()
    return rows


def tuned_inkernel(torch, stacked, mesh) -> dict:
    """Phase 4b: a tuner table built on the card (every serving bucket's
    analytic plan, timed as one in-kernel replay, recorded with
    ``exec_path='inkernel'``, saved and loaded back), then
    ``distribute_weights(tuner=...)`` from NaN-filled replicas. ``stacked``
    is phase 4's result: row 0 holds phase 3's weights. Launch counts are
    zeroed right before the distribution and read right after."""
    from repro_torch import kernels
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.core.tuner import Tuner
    from repro_torch.serve import distribute_weights
    from repro_torch.serve.engine import plan_distribution

    spec, _plans = plan_distribution(stacked, mesh)
    tuner = Tuner()
    buckets = list(zip(spec.bucket_bytes(), spec.bucket_sizes, spec.bucket_dtypes))
    rows = record_inkernel_table(torch, [tuner], buckets, "bcast", [{"exec_path": "inkernel"}])
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "serve_table.json")
        tuner.save(path)
        loaded = Tuner.load(path)
    root = tree_map(lambda t: t[0], stacked)
    for leaf in tree_leaves(stacked):
        leaf[1:].fill_(float("nan"))
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, plans = distribute_weights(stacked, mesh, tuner=loaded, double_buffer=True,
                                    return_plans=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = kernels.launch_counts()
    replayed = sum(1 for p in plans["data"] if p.lowered() is not None
                   and p.lowered().num_rounds > 0)
    assert all(p.decision.exec_path == "inkernel" for p in plans["data"]), plans
    assert counts["fused_combine"] == 0, counts
    assert counts["inkernel_replay"] == replayed > 0, (counts, replayed)
    assert replicas_equal(torch, out, root), "in-kernel replicas differ from phase 3's"
    log(f"tuned in-kernel: table of {len(tuner.table)} entries from {len(rows)} buckets "
        f"(algo, chunks, rounds, classes, replay ms: {rows}); distribution {secs:.3f} s, "
        f"{counts['inkernel_replay']} inkernel_replay launches for {replayed} bucket plans, "
        f"{counts['chunked_copy']} chunked_copy, 0 fused_combine; replicas bit-equal to "
        "phase 3")
    return {"distribute_s": secs, "counts": counts, "plans": replayed, "buckets": rows}


def small_reference(torch) -> float:
    """The f32 smoke model on the card against the same model on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.models import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("minitron-8b-smoke"), dtype="float32",
                              kv_cache_dtype="float32")
    model = Model(cfg)
    cpu = model.init(seed=3, device="cpu")
    gpu = tree_map(lambda t: t.cuda(), cpu)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        a, _ = model.prefill(cpu, {"tokens": tokens}, max_len=20)
        b, _ = model.prefill(gpu, {"tokens": tokens.cuda()}, max_len=20)
    err = float((a - b.cpu()).abs().max())
    assert math.isfinite(err) and err < 1e-3, err
    log(f"reference: smoke f32 prefill logits, card vs CPU, max abs diff {err:.3e} (tol 1e-3)")
    return err


def train_mode(torch, cfg, mesh, fields: dict, check_rows: bool = False):
    """One Trainer run of TRAIN_STEPS steps from the seeded weights.
    Returns the final parameters and the run's record."""
    from repro_torch import kernels
    from repro_torch.configs import RunConfig
    from repro_torch.core.tree import tree_leaves
    from repro_torch.train.trainer import Trainer

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = kernels.launch_counts()
    trainer = Trainer(cfg, RunConfig(**TRAIN_RUN, **fields), mesh=mesh, check_rows=check_rows)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt, hist = trainer.train(batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS,
                                      log_every=1)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    after = kernels.launch_counts()
    del opt, trainer
    losses = [h["loss"] for h in hist]
    assert all(math.isfinite(x) for x in losses), (fields, losses)
    step_s = (hist[-1]["time_s"] - hist[0]["time_s"]) / (TRAIN_STEPS - 1)
    record = {
        "losses": losses, "grad_norms": [h["grad_norm"] for h in hist],
        "first_step_s": hist[0]["time_s"], "step_s": step_s,
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_s, "run_s": total_s,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches": {k: after[k] - before[k] for k in after},
        "params": sum(t.numel() for t in tree_leaves(params)),
    }
    if check_rows:
        record["grad_rows_differ"] = [int(h["grad_rows_differ"]) for h in hist]
    return params, record


def train_tables(torch, d: str) -> tuple[dict, int]:
    """Two tuner tables for phase 6 from the same measured points: every
    training bucket's analytic allreduce plan, timed as one in-kernel replay
    on the card, recorded once with ``exec_path='compiled'`` and once with
    ``'inkernel'``; saved under ``d``. Returns the paths by exec path and
    the bucket plans a step replays."""
    from repro_torch.comm import plan_cached
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.core import bucketing
    from repro_torch.core.tuner import Tuner
    from repro_torch.models import Model

    cfg = dataclasses.replace(get_config("minitron-8b"), num_layers=TRAIN_LAYERS)
    params = Model(cfg).init(seed=0, device="cuda")
    spec = bucketing.plan_buckets(params, RunConfig(**TRAIN_RUN).bcast_bucket_bytes)
    del params
    torch.cuda.empty_cache()
    tuners = {"compiled": Tuner(), "inkernel": Tuner()}
    buckets = list(zip(spec.bucket_bytes(), spec.bucket_sizes, spec.bucket_dtypes))
    rows = record_inkernel_table(torch, list(tuners.values()), buckets, "allreduce",
                                 [{"exec_path": e} for e in tuners])
    paths = {}
    for exec_path, t in tuners.items():
        paths[exec_path] = os.path.join(d, f"train_{exec_path}.json")
        t.save(paths[exec_path])
    loaded = Tuner.load(paths["inkernel"])
    plans = [plan_cached("allreduce", M, RANKS, tuner=loaded) for M, _e, _d in buckets if M]
    replayed = sum(1 for p in plans if p.lowered().num_rounds > 0)
    log(f"train tables: {len(buckets)} buckets (algo, chunks, rounds, classes, replay ms: "
        f"{rows}); {replayed} bucket plans a step")
    return paths, replayed


def train(torch, table_runs: list, plans_per_step: int) -> dict:
    """Phase 6: each sync mode trains 3 steps from the same seeded weights
    and batches; then param_bcast and tuned_allreduce again with the synced
    rows compared (``check_rows``, left out of the timed runs because it
    adds passes over the synced gradients); then ``table_runs``, the
    tuned_allreduce runs whose tuner tables route every bucket plan to the
    compiled and to the in-kernel executor. Returns per-mode numbers;
    raises on any failed check."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.mesh import make_mesh

    cfg = dataclasses.replace(get_config("minitron-8b"), num_layers=TRAIN_LAYERS)
    mesh = make_mesh(RANKS, device="cuda")
    out, tuned, tabled = {}, None, None
    runs = [(label, fields, False) for label, fields in TRAIN_MODES]
    runs += [(label + "+check_rows", dict(TRAIN_MODES)[label], True) for label in ROW_CHECKED]
    runs += [(label, fields, False) for label, fields in table_runs]
    for label, fields, check_rows in runs:
        params, r = train_mode(torch, cfg, mesh, fields, check_rows)
        if label == "tuned_allreduce":
            tuned = tree_leaves(params)
        elif label == "compressed_bf16":
            assert all(same_bits(torch, a, b) for a, b in zip(tuned, tree_leaves(params))), \
                "the bf16 wire's parameters differ from tuned_allreduce's"
            tuned = None
        elif label == "table_compiled":
            tabled = tree_leaves(params)
            assert r["launches"]["inkernel_replay"] == 0 < r["launches"]["fused_combine"], r
        elif label == "table_inkernel":
            assert all(same_bits(torch, a, b) for a, b in zip(tabled, tree_leaves(params))), \
                "the in-kernel table's parameters differ from the compiled table's"
            tabled = None
            assert r["launches"]["fused_combine"] == 0, r
            assert r["launches"]["inkernel_replay"] == plans_per_step * TRAIN_STEPS, \
                (r["launches"], plans_per_step)
        del params
        out[label] = r
        log(f"train {label}: losses {['%.4f' % x for x in r['losses']]}, grad norms "
            f"{['%.4f' % x for x in r['grad_norms']]}, step {r['step_s']:.3f} s "
            f"(first {r['first_step_s']:.3f} s), {r['tokens_per_s']:.0f} tok/s, peak "
            f"{r['max_memory_allocated'] / 2**30:.2f} GiB, "
            + (f"rows differ {r['grad_rows_differ']}, " if check_rows else "")
            + f"launches {r['launches']}")
    ref = out["tuned_allreduce"]["losses"]
    for label, r in out.items():
        assert abs(r["losses"][0] - ref[0]) <= 1e-3, ("step-0 loss", label, r["losses"], ref)
    for label in ROW_CHECKED:
        rows = out[label + "+check_rows"]["grad_rows_differ"]
        assert not any(rows), (label, "synced rows differ", rows)
    # grad_allreduce's plain mean is the one sync that runs none of the
    # port's kernels: the bf16-wire modes must track it. Bounds set from
    # the readings of the proof run (NVIDIA H100 80GB HBM3, 700 W): last
    # losses within 1.7e-4, grad norms within 3.8e-5 relative at every step.
    base = out["grad_allreduce"]
    for label in ("param_bcast", "tuned_allreduce", "compressed_bf16"):
        r = out[label]
        d_loss = abs(r["losses"][-1] - base["losses"][-1])
        d_norm = max(abs(a - b) / b for a, b in zip(r["grad_norms"], base["grad_norms"]))
        log(f"train {label} against grad_allreduce: last loss differs by {d_loss:.3e} "
            f"(bound 1e-3), grad norms by {d_norm:.3e} relative at most (bound 2e-4)")
        assert d_loss <= 1e-3 and d_norm <= 2e-4, (label, r["losses"], r["grad_norms"],
                                                   base["losses"], base["grad_norms"])
    d_int8 = abs(out["compressed_int8"]["losses"][-1] - ref[-1])
    log(f"train compressed_int8 against tuned_allreduce: last loss differs by {d_int8:.3e} "
        "(bound 5e-3; the reference's own test allows 0.05)")
    assert d_int8 <= 5e-3, (out["compressed_int8"]["losses"], ref)
    return out


def small_train_reference(torch) -> list[float]:
    """One f32 smoke param_bcast run of 2 steps on the card against the
    same run on the CPU, from one initial state (saved as a checkpoint by
    the CPU trainer and restored by both)."""
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import checkpoint
    from repro_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("minitron-8b-smoke"), dtype="float32")
    run = RunConfig(sync_mode="param_bcast", **TRAIN_RUN)
    losses = {}
    with tempfile.TemporaryDirectory() as d:
        for dev in ("cpu", "cuda"):
            tr = Trainer(cfg, run, mesh=make_mesh(RANKS, device=dev), ckpt_dir=d, device=dev)
            if dev == "cpu":
                params, opt = tr.init_state()
                checkpoint.save_checkpoint(d, 0, params)
                checkpoint.save_checkpoint(os.path.join(d, "opt"), 0, opt)
            losses[dev] = [h["loss"] for h in tr.train(batch=8, seq=32, steps=2,
                                                       log_every=1)[2]]
    err = [abs(a - b) for a, b in zip(losses["cpu"], losses["cuda"])]
    assert all(e <= 1e-4 for e in err), (losses, err)
    log(f"reference: smoke f32 param_bcast losses, card vs CPU, max abs diff {max(err):.3e} "
        "(tol 1e-4)")
    return err


def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: src/repro_torch is missing beside this script", file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    from repro_torch import kernels
    from repro_torch.kernels import _build

    name_power = card()
    log(f"card: {name_power}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s for {len(_build.SOURCES)} sources")
    for src in _build.SOURCES:
        logf = _build.BUILD_DIR / f"{src}.log"
        if logf.exists():
            for ln in logf.read_text().splitlines():
                if "registers" in ln or "spill" in ln:
                    log(f"  ptxas {src}: {ln.strip()}")
    cal = calibrate(torch)
    log(f"calibrate: ts {cal['ts_s']:.3e} s, t_launch {cal['t_launch_s']:.3e} s")

    lines = [check_fused_combine(torch), check_chunked_copy(torch), *check_quantize(torch),
             check_inkernel(torch)]
    check_fused_combine_training(torch)
    gc.collect()
    torch.cuda.empty_cache()

    kernels.reset_launch_counts()
    serving, engine = serve(torch)
    from repro_torch.core.tree import tree_map

    root, mesh = tree_map(lambda t: t[0].clone(), engine.params), engine.mesh
    del engine  # frees the four replicas before phase 4 builds its own
    torch.cuda.empty_cache()
    log(f"memory: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated before phase 4")
    compiled, stacked = compiled_replay(torch, root, mesh)
    serve_counts = kernels.launch_counts()
    del root
    tuned = tuned_inkernel(torch, stacked, mesh)
    tuned_counts = tuned.pop("counts")
    log(f"serving: tuned in-kernel distribution {tuned['distribute_s']:.3f} s beside the "
        f"compiled pipelined chain's {compiled['distribute_s']:.3f} s")
    del stacked, mesh
    gc.collect()
    torch.cuda.empty_cache()

    small_reference(torch)
    numbers = {"serve": serving, "compiled": compiled, "tuned_inkernel": tuned}
    log(f"serving numbers: {json.dumps(numbers)}")

    with tempfile.TemporaryDirectory() as d:
        tables, plans_per_step = train_tables(torch, d)
        table_runs = [(f"table_{e}", {"sync_mode": "tuned_allreduce", "tuner_table": tables[e]})
                      for e in ("compiled", "inkernel")]
        kernels.reset_launch_counts()
        training = train(torch, table_runs, plans_per_step)
        train_counts = kernels.launch_counts()
    # each kernel on the path that runs it: the merge on both, the staging
    # copy on the serving path, the quantize pair on the training path, the
    # in-kernel replay on the tuned serving path (phase 4b) and in training
    paths = {"fused_combine": ("serve", "train"), "chunked_copy": ("serve",),
             "quantize_blocks": ("train",), "dequantize_blocks": ("train",),
             "inkernel_replay": ("serve_tuned", "train")}
    counts = {"serve": serve_counts, "serve_tuned": tuned_counts, "train": train_counts}
    for line in lines:
        line["launches_by_path"] = {p: counts[p][line["name"]] for p in paths[line["name"]]}
        for p, k in line["launches_by_path"].items():
            assert k > 0, f"{line['name']} never launched on the {p} path"
        line["launches"] = line["launches_by_path"][paths[line["name"]][-1]]
    small_train_reference(torch)
    log(f"training numbers: {json.dumps(training)}")
    print(json.dumps({"kernels": lines}))
    print(f"card: {name_power}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
