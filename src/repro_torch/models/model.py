"""Model facade: init / loss / prefill / decode / cache."""
from __future__ import annotations

from typing import Any

import torch

from ..configs.base import ModelConfig
from ..launch.mesh import resolve_device
from .layers import cross_entropy_loss
from .transformer import apply_lm, init_decode_cache, init_lm

__all__ = ["Model"]


class _MetaGenerator(torch.Generator):
    """A CPU generator whose ``device`` is the meta device: the init's walk
    draws every leaf on it (shape and dtype, no storage)."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


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

    def param_shapes(self) -> Any:
        """The parameter tree as meta tensors, from the init's own walk:
        shapes and dtypes, nothing allocated (the layout rules of
        :mod:`repro_torch.dist.sharding` read it)."""
        return init_lm(_MetaGenerator(), self.cfg)

    def forward(self, params, batch: dict, *, remat: bool = False):
        """Train-mode forward. Returns (logits (B, T, V) f32, aux): the
        blocks' summed auxiliary loss, 0-d f32 (the MoE router's
        load-balancing loss; exactly 0 for a dense model)."""
        logits, _, aux = apply_lm(params, self.cfg, tokens=batch["tokens"],
                                  embeds=batch.get("embeds"), mode="train", remat=remat)
        return logits, aux

    def loss(self, params, batch: dict, *, remat: bool = False):
        """``(nll + aux, {"nll": nll, "aux": aux})`` over ``batch['tokens']``
        and ``batch['labels']`` (B, T)."""
        logits, aux = self.forward(params, batch, remat=remat)
        labels = torch.clamp(batch["labels"], max=self.cfg.padded_vocab - 1)
        nll = cross_entropy_loss(logits, labels, batch.get("loss_mask"))
        return nll + aux, {"nll": nll, "aux": aux}

    def prefill(self, params, batch: dict, *, max_len: int):
        """``batch['tokens']`` (B, T) int, and ``batch['embeds']``: (B,
        prefix, D) for a vision config, (B, frames, D) for an
        encoder-decoder. Returns (logits (B, T, V) f32, caches grown to
        ``max_len``, plus the prefix's slots for vision; the frames take no
        slot of the self-attention caches, their keys and values are the
        ``cross`` entries)."""
        if self.cfg.frontend == "vision":
            max_len = max_len + self.cfg.prefix_len  # the cache holds the prefix too
        logits, caches, _ = apply_lm(params, self.cfg, tokens=batch["tokens"],
                                     embeds=batch.get("embeds"), mode="prefill",
                                     max_len=max_len)
        return logits, caches

    def decode_step(self, params, tokens: torch.Tensor, caches, cur_pos: int):
        """tokens (B, 1) int; ``cur_pos`` the absolute position of the new
        token. Returns (logits (B, 1, V), caches) — the caches are updated in
        place."""
        logits, caches, _ = apply_lm(params, self.cfg, tokens=tokens, mode="decode",
                                     caches=caches, cur_pos=int(cur_pos))
        return logits, caches

    def init_cache(self, batch: int, max_len: int, *, device="cuda"):
        return init_decode_cache(self.cfg, batch, max_len, resolve_device(device))
