#!/usr/bin/env python3
"""How far one tensor-parallel training pass lies from the one-axis pass,
in bf16 and in f32, and how many of a MoE's tokens it routes otherwise.

    python3 tools/tp_routing.py [arch ...]   # default: mixtral-8x7b

On one GPU, for each config at one layer and full width, from the same
seeded weights and the first batch of 8 x 512 tokens (a vision config's
patches and an encoder-decoder's frames in it): ``Model.loss`` and its
gradients on one axis, and ``tensor_parallel.tp_loss`` on the two model
ranks' shards of the training layout (``param_specs(fsdp=True,
attn_fallback='replicate')`` on a (1, 2) ('data', 'model') mesh) and their
gradients, reassembled along the model axis. It prints, in each dtype,
both losses and aux losses, the router logits' largest difference and the
tokens whose dispatch (expert or capacity slot) differs, both global grad
norms and the leaves whose gradients differ most (relative L2, beside the
one-axis gradient's norm: a key bias's is zero but for rounding, the
softmax being blind to it). TF32 is off. Needs one card; exits non-zero without one.
"""
from __future__ import annotations

import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def one(torch, arch: str, dtype: str, routes: list, device: str = "cuda") -> None:
    from repro_torch import comm
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_flatten, tree_paths, tree_unflatten
    from repro_torch.data.pipeline import batches, make_source
    from repro_torch.dist import sharding
    from repro_torch.dist.topology import TP_AXIS
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    from repro_torch.models import tensor_parallel as tp_lib
    from repro_torch.train import train_step as tts

    cfg = dataclasses.replace(get_config(arch), num_layers=1, dtype=dtype,
                              encoder_layers=1 if get_config(arch).encoder_layers else 0)
    model = Model(cfg)
    params = model.init(0, device=device)
    batch = next(batches(make_source(cfg, seed=0), cfg, batch=8, seq=512, device=device))
    leaves, treedef = tree_flatten(params)
    routes.clear()
    ps = [t.detach().requires_grad_(True) for t in leaves]
    loss, metrics = model.loss(tree_unflatten(treedef, ps), batch)
    grads = torch.autograd.grad(loss, ps)
    mesh = make_mesh((1, 2), axis_names=("data", TP_AXIS), device=device)
    specs = tree_flatten(tts.tp_specs(model, mesh), sharding.is_spec)[0]
    blocked = sharding.cut_leaves([t.detach() for t in leaves], specs, mesh)
    shards = [[t.detach().requires_grad_(True) for t in tts.gather_model_shards(
        b, sp, mesh, lambda frame, axis: comm.pallgather(frame, compiled=True))]
        for b, sp in zip(blocked, specs)]
    trees = [tree_unflatten(treedef, [s[j] if len(s) > 1 else s[0] for s in shards])
             for j in range(2)]
    tp_loss, tp_metrics = tp_lib.tp_loss(trees, cfg, batch)
    tp_grads = iter(torch.autograd.grad(tp_loss, [t for s in shards for t in s]))
    line = (f"{arch} {dtype}: loss {float(loss.detach()):.6f} / TP "
            f"{float(tp_loss.detach()):.6f}, aux {float(metrics['aux'].detach()):.9f} / "
            f"{float(tp_metrics['aux'].detach()):.9f}")
    if routes:
        (la, da), (lb, db) = routes[0], routes[len(routes) // 2]
        moved = int((da != db).flatten(3).any(-1).sum())
        line += (f"; router logits {float((la - lb).abs().max()):.3e} apart, {moved} of "
                 f"{da.shape[0] * da.shape[1] * da.shape[2]} tokens dispatched otherwise")
    print(line, flush=True)
    rows, n_one, n_tp = [], 0.0, 0.0
    for path, g, s, spec in zip(tree_paths(params), grads, shards, specs):
        parts = [next(tp_grads) for _ in s]
        whole = parts[0]
        if len(parts) > 1:
            dim = next(i for i, e in enumerate(spec)
                       if e == TP_AXIS or (isinstance(e, tuple) and TP_AXIS in e))
            whole = torch.cat(parts, dim=dim)
        a, b = g.float(), whole.float()
        n_one, n_tp = n_one + float((a * a).sum()), n_tp + float((b * b).sum())
        rows.append((float((a - b).norm()) / max(float(a.norm()), 1e-30), path, float(a.norm())))
    print(f"  grad norms {n_one ** 0.5:.6f} / TP {n_tp ** 0.5:.6f}, relative "
          f"{abs(n_one ** 0.5 - n_tp ** 0.5) / n_one ** 0.5:.3e}; leaves farthest apart: "
          + ", ".join(f"{p} {r:.3e} (|g| {n:.1e})" for r, p, n in sorted(rows, reverse=True)[:5]),
          flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tp_routing: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.models import moe as moe_lib

    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    routes = []
    route = moe_lib.route_logits

    def recorded(logits, cfg, dtype, ranks=1):
        out = route(logits, cfg, dtype, ranks)
        routes.append((logits.detach().clone(), out[1].detach().clone()))
        return out

    moe_lib.route_logits = recorded  # the one-axis and the TP forward both route through it
    for arch in sys.argv[1:] or ["mixtral-8x7b"]:
        for dtype in ("bfloat16", "float32"):
            one(torch, arch, dtype, routes)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
