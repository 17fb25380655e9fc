"""Stack assembly: decoder over stacked superblocks.

Layers are grouped into *superblocks* of length P = lcm(|block_pattern|,
|attn_pattern|), as in the reference. Parameters keep the reference's
stacked layout: ``decoder.blocks[i]`` holds pattern slot ``i`` for every
superblock, with a leading ``num_layers // P`` dimension, so the port's
parameter tree flattens and buckets exactly like the reference's. Layer
``l`` of slot ``i`` is row ``l`` of that stack. ``num_layers % P`` leftover
layers live unstacked in ``decoder.tail``. Decode caches are stacked the
same way.
"""
from __future__ import annotations

import math

import torch

from ..core.tree import tree_map
from .blocks import apply_block, init_block, init_block_cache
from .layers import embed_tokens, init_embedding, init_rms_norm, rms_norm, unembed

__all__ = ["StackLayout", "init_lm", "apply_lm", "init_decode_cache"]


class StackLayout:
    """Derived layer layout for a config."""

    def __init__(self, cfg):
        self.cfg = cfg
        bp, ap = cfg.block_pattern, cfg.attn_pattern
        self.period = math.lcm(len(bp), len(ap))
        self.num_layers = cfg.num_layers
        self.kinds = cfg.layer_kinds()
        self.windows = cfg.layer_windows()
        self.num_super = self.num_layers // self.period
        self.tail = self.num_layers % self.period


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_arch(cfg) -> None:
    if cfg.arch_type != "decoder" or cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: only decoder-only text models are ported (ROADMAP A.11)")


def init_lm(gen: torch.Generator, cfg) -> dict:
    """Full parameter tree for a config, drawn from ``gen`` on its device."""
    _check_arch(cfg)
    dt = _dtype(cfg)
    layout = StackLayout(cfg)
    blocks = []
    for i in range(layout.period):
        if layout.num_super:
            blocks.append(init_block(gen, cfg, layout.kinds[i], layout.windows[i],
                                     dtype=dt, lead=(layout.num_super,)))
        else:
            blocks.append(None)
    tail = []
    for j in range(layout.tail):
        i = (layout.num_super * layout.period + j) % layout.period
        tail.append(init_block(gen, cfg, layout.kinds[i], layout.windows[i], dtype=dt))
    return {
        "embed": init_embedding(gen, cfg.padded_vocab, cfg.d_model, cfg.tie_embeddings, dt),
        "decoder": {"blocks": blocks, "tail": tail},
        "final_norm": init_rms_norm(cfg.d_model, gen.device),
    }


def _apply_stack(stack, x, cfg, layout: StackLayout, *, mode: str, caches=None,
                 cur_pos=None, max_len: int = 0):
    """Returns (x, caches) with caches ``{'blocks': [...], 'tail': [...]}``."""
    P = layout.period
    kinds, wins = layout.kinds, layout.windows
    slot_caches: list[list] = [[] for _ in range(P)]
    for l in range(layout.num_super):
        for i in range(P):
            p = tree_map(lambda t: t[l], stack["blocks"][i])
            c = None if caches is None else tree_map(lambda t: t[l], caches["blocks"][i])
            x, nc = apply_block(p, x, cfg, kinds[i], wins[i], mode=mode, cache=c,
                                cur_pos=cur_pos, max_len=max_len)
            slot_caches[i].append(nc)
    new_caches = {"blocks": None, "tail": []}
    if layout.num_super:
        if mode == "prefill":
            new_caches["blocks"] = [tree_map(lambda *ts: torch.stack(ts), *cs)
                                    for cs in slot_caches]
        else:  # decode appended in place into the stacked caches
            new_caches["blocks"] = caches["blocks"]
    for j, tp in enumerate(stack["tail"]):
        i = (layout.num_super * P + j) % P
        tc = None if caches is None else caches["tail"][j]
        x, nc = apply_block(tp, x, cfg, kinds[i], wins[i], mode=mode, cache=tc,
                            cur_pos=cur_pos, max_len=max_len)
        new_caches["tail"].append(nc)
    return x, new_caches


def apply_lm(params, cfg, *, tokens: torch.Tensor, mode: str = "prefill",
             caches=None, cur_pos: int | None = None, max_len: int = 0):
    """prefill: ``tokens`` (B, T); decode: ``tokens`` (B, 1) + ``caches`` +
    ``cur_pos``. Returns (logits_f32, caches)."""
    _check_arch(cfg)
    layout = StackLayout(cfg)
    dt = _dtype(cfg)
    scale = torch.tensor(cfg.d_model**0.5, dtype=dt, device=tokens.device)
    x = embed_tokens(params["embed"], tokens) * scale
    x, new_caches = _apply_stack(params["decoder"], x, cfg, layout, mode=mode,
                                 caches=caches, cur_pos=cur_pos, max_len=max_len)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["embed"], x), new_caches


def init_decode_cache(cfg, batch: int, max_len: int, device) -> dict:
    """Zero decode cache matching :func:`apply_lm`'s cache structure."""
    layout = StackLayout(cfg)
    P = layout.period
    blocks = None
    if layout.num_super:
        blocks = []
        for i in range(P):
            one = init_block_cache(cfg, layout.kinds[i], layout.windows[i], batch,
                                   max_len, device)
            blocks.append(tree_map(
                lambda t: t.expand((layout.num_super,) + tuple(t.shape)).clone(), one))
    tail = [
        init_block_cache(cfg, layout.kinds[(layout.num_super * P + j) % P],
                         layout.windows[(layout.num_super * P + j) % P], batch,
                         max_len, device)
        for j in range(layout.tail)
    ]
    return {"blocks": blocks, "tail": tail}
