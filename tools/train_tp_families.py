#!/usr/bin/env python3
"""Phase 6u of ``chip_smoke.py`` alone: the MoE, encoder-decoder and
vision-prefix families trained on a (2, 2) ('data', 'model') mesh, beside
the one-axis runs the phase reads.

    python3 tools/train_tp_families.py [--one-pass]

On one GPU: builds the kernels, runs the one-axis runs of phases 6m
(mixtral-8x7b, 1 layer, grad_allreduce), 6f (whisper-large-v3,
grad_allreduce) and 6v (paligemma-3b, tuned_allreduce), then
``chip_smoke.train_tp_families`` with them (its controls, its timed runs,
its f32 checks and its smoke configs, every check asserted), and prints
the phase's seconds and its launch counts. ``--one-pass`` first trains
paligemma-3b on (2, 2) in one pass over its 4 sequences of 256 patches +
3840 tokens, the layout phase 6u cuts into 4 microbatches, and prints
whether it fits the card and its peak. About 100 s of command (150 s with
``--one-pass``). Needs one card; exits non-zero without one.
"""
from __future__ import annotations

import dataclasses
import gc
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("train_tp_families: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_mesh

    t0 = time.perf_counter()
    cs.log(f"card: {cs.card()}")
    _build.build_all()
    mixtral = dataclasses.replace(get_config("mixtral-8x7b"), num_layers=cs.MOE_TRAIN_LAYERS)
    _, moe = cs.train_mode(torch, mixtral, make_mesh(cs.RANKS, device="cuda"),
                           {"sync_mode": "grad_allreduce"})
    cs.log("train moe grad_allreduce: " + cs._train_line(moe))
    whisper = cs._family_run(torch, "whisper-large-v3", get_config("whisper-large-v3"),
                             "grad_allreduce")
    vlm = cs.train_vlm(torch)
    if "--one-pass" in sys.argv[1:]:
        gc.collect()
        torch.cuda.empty_cache()
        cfg = dataclasses.replace(get_config("paligemma-3b"), num_layers=cs.VLM_TRAIN_LAYERS)
        try:
            _, r = cs.train_mode(torch, cfg, cs._tp_train_mesh(), cs.TP_TRAIN_FIELDS,
                                 batch=cs.RANKS, seq=cs.VLM_TEXT)
            cs.log("train tp_fam paligemma-3b in one pass: " + cs._train_line(r))
        except torch.OutOfMemoryError as e:
            cs.log(f"train tp_fam paligemma-3b in one pass: out of memory, "
                   f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated at the peak "
                   f"({str(e).splitlines()[0]})")
        gc.collect()
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    _, counts = cs.train_tp_families(torch, {"6m": moe, "6f": whisper, "6v": vlm})
    cs.log(f"phase 6u: {time.perf_counter() - t1:.1f} s, launches "
           f"{ {k: v for k, v in counts.items() if v} }; {time.perf_counter() - t0:.1f} s in all")
    return 0


if __name__ == "__main__":
    sys.exit(main())
