#!/usr/bin/env python3
"""How far a bf16 training step's gradient lies from the f32 gradient of
the same weights and batch, for the two ways the port's trainer takes it.

    python3 tools/grad_precision.py

On one GPU, for ``chip_smoke.py``'s phase-6 model (minitron-8b, 1 of 32
layers, full width, seeded weights) and phase 6m's (mixtral-8x7b, 1 layer)
on the first global batch of 8 x 512 tokens, and for minitron-8b also on
that batch without rank 1's two sequences (phase 11's survivors), the loss
and gradients of:

* ``f32``: the same weights cast to f32, TF32 off: the yardstick;
* ``global``: one bf16 pass over the batch (``grad_allreduce``);
* ``per_rank``: one bf16 pass a rank, 2 sequences each, their mean taken
  in f32 (what the explicit sync modes and the degraded step average);
* ``global_f32_reduce``: ``global`` with cuBLAS's reduced-precision bf16
  reductions switched off
  (``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``).

For each it prints the grad norm and ``|g - g_f32| / |g_f32|`` over the
whole tree and for the five leaves with the largest error. A MoE model's
router statistics read another batch in each form, so its aux differs by
semantics as well as by rounding. Needs one card; exits non-zero without
one.
"""
from __future__ import annotations

import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
RANKS = 4  # the emulated data ranks the batch splits over


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("grad_precision: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.core.tree import tree_leaves, tree_map, tree_paths
    from repro_torch.data.pipeline import batches, make_source
    from repro_torch.models import Model
    from repro_torch.train.train_step import _grad_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for arch, ranks in (("minitron-8b", (0, 1, 2, 3)), ("minitron-8b", (0, 2, 3)),
                        ("mixtral-8x7b", (0, 1, 2, 3))):
        cfg = dataclasses.replace(get_config(arch), num_layers=1)
        model = Model(cfg)
        compute = _grad_fn(model, RunConfig())
        params = model.init(seed=0, device="cuda")
        paths = tree_paths(params)
        full = next(batches(make_source(cfg, seed=0), cfg, batch=8, seq=512, device="cuda"))
        shards = [{k: torch.tensor_split(v, RANKS)[r] for k, v in full.items()} for r in ranks]
        batch = {k: torch.cat([sh[k] for sh in shards]) for k in full}
        label0 = f"{arch} ranks {''.join(map(str, ranks))}"

        def f32_grads():
            p32 = tree_map(lambda t: t.float(), params)
            loss, _m, g = _grad_fn(Model(dataclasses.replace(cfg, dtype="float32")),
                                   RunConfig())(p32, batch)
            del p32
            return float(loss), [t.float() for t in g]

        loss32, g32 = f32_grads()
        torch.cuda.empty_cache()
        n32 = torch.sqrt(sum((t.double() ** 2).sum() for t in g32))

        def report(label, loss, grads):
            errs = [torch.linalg.vector_norm((g.float() - t).double()) for g, t in zip(grads, g32)]
            total = torch.sqrt(sum(e ** 2 for e in errs)) / n32
            norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
            worst = sorted(range(len(errs)), key=lambda i: -float(errs[i]))[:5]
            line = {"loss": loss, "grad_norm": float(norm), "rel_err": float(total),
                    "worst": [(paths[i], float(errs[i] / torch.linalg.vector_norm(
                        g32[i].double()))) for i in worst]}
            out[f"{label0} {label}"] = line
            print(f"grad_precision {label0} {label}: loss {loss:.6f}, grad norm "
                  f"{line['grad_norm']:.6f} (f32 {float(n32):.6f}), |g - g32| / |g32| "
                  f"{line['rel_err']:.3e}; worst leaves {line['worst']}", flush=True)

        loss, _m, g = compute(params, batch)
        report("global", float(loss), g)
        del g
        acc, losses = None, []
        for shard in shards:
            loss, _m, g = compute(params, shard)
            losses.append(float(loss))
            if acc is None:
                acc = [t.float() / len(shards) for t in g]
            else:
                for a, t in zip(acc, g):
                    a.add_(t.float() / len(shards))
            del g
        report("per_rank", sum(losses) / len(shards), [a.to(p.dtype) for a, p in
                                                        zip(acc, tree_leaves(params))])
        del acc
        flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        try:
            loss, _m, g = compute(params, batch)
        finally:
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
        report("global_f32_reduce", float(loss), g)
        del g, g32, params, full, shards, batch
        torch.cuda.empty_cache()
    print(f"card: {torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
