"""Model facade: init / prefill / decode / cache."""
from __future__ import annotations

from typing import Any

import torch

from ..configs.base import ModelConfig
from ..launch.mesh import resolve_device
from .transformer import apply_lm, init_decode_cache, init_lm

__all__ = ["Model"]


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def init(self, seed: int = 0, *, device="cuda") -> Any:
        """Random parameters drawn from a ``torch.Generator`` seeded with
        ``seed`` on ``device`` (they differ from the reference's
        ``jax.random`` draws; :func:`~repro_torch.models.convert.params_from_jax`
        carries the reference's parameters over)."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return init_lm(gen, self.cfg)

    def prefill(self, params, batch: dict, *, max_len: int):
        """``batch['tokens']`` (B, T) int. Returns (logits (B, T, V) f32,
        caches grown to ``max_len``)."""
        return apply_lm(params, self.cfg, tokens=batch["tokens"], mode="prefill",
                        max_len=max_len)

    def decode_step(self, params, tokens: torch.Tensor, caches, cur_pos: int):
        """tokens (B, 1) int; ``cur_pos`` the absolute position of the new
        token. Returns (logits (B, 1, V), caches) — the caches are updated in
        place."""
        return apply_lm(params, self.cfg, tokens=tokens, mode="decode",
                        caches=caches, cur_pos=int(cur_pos))

    def init_cache(self, batch: int, max_len: int, *, device="cuda"):
        return init_decode_cache(self.cfg, batch, max_len, resolve_device(device))
