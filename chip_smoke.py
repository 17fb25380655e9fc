#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. card: name and power limit (``nvidia-smi``); build the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` with ``nvcc`` for sm_90a; calibrate the
   per-transfer and per-launch times the H100 cost profile quotes.
2. kernels at the serving path's shapes, each held bit for bit against its
   plain PyTorch version, with CUDA-event times, the bound (bytes / 3.35
   TB/s), the plain version's time and a one-call PyTorch yardstick.
3. serving, default policy: minitron-8b at full width (8 of 32 layers,
   bf16, seeded random weights) on an emulated data axis of 4 ranks;
   ``Engine(distribute=True, double_buffer=True)`` broadcasts the weights,
   then ``generate`` serves batch 4, prompt 128, 32 decode steps; a warm
   re-run of the same loop times prefill and the decode steps apart.
4. compiled replay: the same weights broadcast again from NaN-filled
   replicas with the pinned pipelined chain and the compiled executor.
5. a small-input reference: the port's f32 smoke model on the card against
   the same model on the CPU.

Launch counts are zeroed right before phase 3 and read right after phase 4
(the serving path); the launches that compare kernels with their plain
versions are not counted. The last three lines of output are the kernels
JSON, the card, and ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BATCH, PROMPT, STEPS, RANKS, LAYERS = 4, 128, 32, 4, 8


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


def compiled_replay(torch, root, mesh) -> dict:
    """``root``: phase 3's root replica (a copy; the engine is gone). Row 0
    of the new stack is that copy, so the replicas are held against it."""
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
    return {"distribute_s": secs, "fused_combine_launches": launched, "rounds": rounds}


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

    lines = [check_fused_combine(torch), check_chunked_copy(torch)]

    kernels.reset_launch_counts()
    serving, engine = serve(torch)
    from repro_torch.core.tree import tree_map

    root, mesh = tree_map(lambda t: t[0].clone(), engine.params), engine.mesh
    del engine  # frees the four replicas before phase 4 builds its own
    torch.cuda.empty_cache()
    log(f"memory: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated before phase 4")
    compiled = compiled_replay(torch, root, mesh)
    counts = kernels.launch_counts()
    for line in lines:
        line["launches"] = counts[line["name"]]
        assert line["launches"] > 0, f"{line['name']} never launched on the serving path"

    small_reference(torch)
    log(f"serving numbers: {json.dumps({'serve': serving, 'compiled': compiled})}")
    print(json.dumps({"kernels": lines}))
    print(f"card: {name_power}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
