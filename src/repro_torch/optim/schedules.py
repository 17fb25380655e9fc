"""LR schedules, computed in float32 as the reference's ``jnp`` versions."""
from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine", "constant"]


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1):
    """Linear warmup to ``base_lr``, then cosine decay to ``min_ratio``
    times it. Returns ``lr(step) -> 0-d float32 tensor``."""
    def lr(step):
        step = _f32(step)
        warm = base_lr * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup_steps, warm, cos)

    return lr


def constant(base_lr: float):
    return lambda step: _f32(base_lr)
