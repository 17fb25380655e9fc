"""Block assembly with a uniform (init, apply) interface per ``kind``.

The port has the dense ``attn`` block (pre-norm GQA attention + MLP) that
the dense architectures use; the other kinds (moe, mlstm, slstm, hybrid)
are ROADMAP A.8 and A.11.
"""
from __future__ import annotations

from typing import Optional

import torch

from .layers import (
    AttnSpec,
    attention,
    init_attention,
    init_attn_cache,
    init_mlp,
    init_rms_norm,
    mlp,
    rms_norm,
)

__all__ = ["attn_spec_for", "init_block", "apply_block", "init_block_cache"]


def attn_spec_for(cfg, window: Optional[int], causal: bool = True) -> AttnSpec:
    if window is not None:
        raise NotImplementedError(
            f"sliding-window attention (window {window}) is not ported yet "
            "(ROADMAP A.11); the port has global attention"
        )
    return AttnSpec(
        num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim,
        qkv_bias=cfg.qkv_bias,
        rope_theta=cfg.rope_theta,
        causal=causal,
    )


def _check_kind(kind: str) -> None:
    if kind != "attn":
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ROADMAP A.8/A.11); "
            "the port has the dense 'attn' block"
        )


def init_block(gen: torch.Generator, cfg, kind: str, window: Optional[int], *,
               dtype, lead: tuple = ()) -> dict:
    """One block's parameters; ``lead`` stacks several layers' blocks."""
    _check_kind(kind)
    d = cfg.d_model
    p = {
        "norm1": init_rms_norm(d, gen.device, lead),
        "attn": init_attention(gen, d, attn_spec_for(cfg, window), dtype, lead),
    }
    if cfg.d_ff:
        p["norm2"] = init_rms_norm(d, gen.device, lead)
        p["mlp"] = init_mlp(gen, d, cfg.d_ff, cfg.act, dtype, lead)
    return p


def init_block_cache(cfg, kind: str, window: Optional[int], batch: int,
                     max_len: int, device) -> dict:
    """Zero decode cache for one block."""
    _check_kind(kind)
    kv_dt = getattr(torch, cfg.kv_cache_dtype)
    return {"attn": init_attn_cache(batch, max_len, attn_spec_for(cfg, window), kv_dt, device)}


def apply_block(p, x: torch.Tensor, cfg, kind: str, window: Optional[int], *,
                mode: str, cache: dict | None = None, cur_pos: int | None = None,
                max_len: int = 0, prefix_len: int = 0):
    """Returns (x, cache): the prefill-built cache (grown to ``max_len``) or
    the decode cache with the new token appended in place."""
    _check_kind(kind)
    spec = attn_spec_for(cfg, window)
    h = rms_norm(p["norm1"], x, cfg.norm_eps)
    y, ac = attention(p["attn"], h, spec, mode=mode, prefix_len=prefix_len,
                      cache=None if cache is None else cache["attn"], cur_pos=cur_pos)
    if mode == "prefill":
        if max_len:
            ac = _grow_cache(ac, max_len)
        kv_dt = getattr(torch, cfg.kv_cache_dtype)
        ac = {**ac, "k": ac["k"].to(kv_dt), "v": ac["v"].to(kv_dt)}
    x = x + y
    if "mlp" in p:
        x = x + mlp(p["mlp"], rms_norm(p["norm2"], x, cfg.norm_eps), cfg.act)
    return x, {"attn": ac}


def _grow_cache(cache: dict, max_len: int) -> dict:
    """Extend a prefill-built cache to decode capacity ``max_len``."""
    pad = max_len - cache["k"].shape[1]
    if pad <= 0:
        return cache
    k = torch.nn.functional.pad(cache["k"], (0, 0, 0, 0, 0, pad))
    v = torch.nn.functional.pad(cache["v"], (0, 0, 0, 0, 0, pad))
    pos = torch.nn.functional.pad(cache["pos"], (0, pad), value=-1)
    return {"k": k, "v": v, "pos": pos}
