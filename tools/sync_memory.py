#!/usr/bin/env python3
"""Where a training step's sync allocates device memory, bucket by bucket.

    python3 tools/sync_memory.py

Builds the 1-layer minitron-8b trainer of ``chip_smoke.py``'s phase 6 on 4
emulated ranks of one GPU (bf16, global batch 8 x 512) for each of
``tuned_allreduce``, ``overlap_allreduce`` and ``overlap_allreduce`` with
``prefetch_stream``, runs one step, and prints for every bucket replay
(each call of ``comm.api.apply_plan``) the memory allocated before it and
the peak during it, in GiB, with the bucket's shape and algorithm, the
peak between replays, and the step's peak and where it fell. Nothing else
is held on the card between the runs (``chip_smoke.py`` keeps the previous
run's parameters for its bit-equality checks, and its peaks include them).
Needs one card; exits non-zero without one.
"""
from __future__ import annotations

import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
GIB = 2.0**30


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sync_memory: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.comm import api, streams
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.data.pipeline import batches
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.trainer import Trainer

    cfg = dataclasses.replace(get_config("minitron-8b"), num_layers=1)
    mesh = make_mesh(4, device="cuda")
    real = api.apply_plan
    for label, fields in (("tuned_allreduce", {"sync_mode": "tuned_allreduce"}),
                          ("overlap_allreduce", {"sync_mode": "overlap_allreduce"}),
                          ("overlap_prefetch", {"sync_mode": "overlap_allreduce",
                                                "prefetch_stream": True})):
        segments = []  # (what, allocated at its start, peak during it), GiB

        def traced(plan, x, **kw):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            segments.append(("between", None, torch.cuda.max_memory_allocated() / GIB))
            torch.cuda.reset_peak_memory_stats()
            out = real(plan, x, **kw)
            torch.cuda.synchronize()
            segments.append((f"{plan.op} {plan.algo} {tuple(x.shape)}", before / GIB,
                             torch.cuda.max_memory_allocated() / GIB))
            torch.cuda.reset_peak_memory_stats()
            return out

        # the sync modes call apply_plan through these module globals
        api.apply_plan = streams.apply_plan = traced
        try:
            tr = Trainer(cfg, RunConfig(learning_rate=1e-3, warmup_steps=1, total_steps=3,
                                        seed=0, compiled_collectives=True, **fields),
                         mesh=mesh)
            params, opt = tr.init_state()
            batch = next(batches(tr.source, cfg, batch=8, seq=512, device="cuda"))
            torch.cuda.synchronize()
            start = torch.cuda.memory_allocated() / GIB
            torch.cuda.reset_peak_memory_stats()
            params, opt, out = tr._step_fn(params, opt, batch)
            torch.cuda.synchronize()
            segments.append(("after the last bucket", None,
                             torch.cuda.max_memory_allocated() / GIB))
        finally:
            api.apply_plan = streams.apply_plan = real
        peak = max(seg[2] for seg in segments)
        print(f"{label}: {start:.2f} GiB allocated at the step's start, peak {peak:.2f} GiB; "
              "segments (what, allocated before, peak during, GiB):")
        for what, before, top in segments:
            mark = " <- peak" if top == peak else ""
            print(f"  {what}: {'-' if before is None else f'{before:.2f}'} -> {top:.2f}{mark}")
        del tr, params, opt, out, batch
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
