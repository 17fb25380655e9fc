"""Serving launcher of the port: load (or init) weights and run batched
generation.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch minitron-8b-smoke \
        --batch 4 --prompt-len 16 --steps 16 [--ckpt-dir DIR] [--device cpu]

The reference's flags and draws (``--seed`` seeds both the random init and
the numpy prompt tokens, and the stub ``embeds`` of a vision or an
encoder-decoder config); ``--ckpt-dir`` restores the latest npz checkpoint,
one the reference wrote included. The port's own flag: ``--device`` (the
card by default; ``cpu`` runs the plain PyTorch path).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.tree import tree_map
from repro_torch.launch.mesh import resolve_device
from repro_torch.models import Model
from repro_torch.serve.engine import Engine
from repro_torch.train import checkpoint as ck


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--temperature", type=float, default=0.0, help="0 = greedy")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    model = Model(cfg)
    device = resolve_device(args.device)
    if args.ckpt_dir:
        step = ck.latest_step(args.ckpt_dir)
        assert step is not None, f"no checkpoint under {args.ckpt_dir}"
        like = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device=device),
                        model.param_shapes())
        params = ck.restore_checkpoint(args.ckpt_dir, step, like)
        print(f"restored step {step} from {args.ckpt_dir}")
    else:
        params = model.init(args.seed, device=device)
        print("no checkpoint given; serving random-init weights")

    engine = Engine(cfg, params, max_len=args.prompt_len + args.steps, device=device)
    rng = np.random.RandomState(args.seed)
    batch = {"tokens": rng.randint(0, cfg.vocab_size - 1, (args.batch, args.prompt_len))}
    dt = getattr(torch, cfg.dtype)
    if cfg.frontend == "vision":
        batch["embeds"] = torch.from_numpy(
            rng.randn(args.batch, cfg.prefix_len, cfg.d_model)).to(dt)
    if cfg.arch_type == "encdec":
        batch["embeds"] = torch.from_numpy(
            rng.randn(args.batch, cfg.frontend_len, cfg.d_model)).to(dt)
    res = engine.generate(
        batch,
        steps=args.steps,
        greedy=(args.temperature == 0.0),
        temperature=max(args.temperature, 1e-6),
        seed=args.seed,
    )
    print(f"arch={cfg.name} batch={args.batch} prefill={args.prompt_len} decode={args.steps}")
    for b in range(args.batch):
        print(f"req{b}: {res.tokens[b].tolist()} (mean logprob {res.logprobs[b].mean():.3f})")


if __name__ == "__main__":
    main()
