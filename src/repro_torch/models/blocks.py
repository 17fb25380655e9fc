"""Block assembly with a uniform (init, apply) interface per ``kind``.

The port has two kinds:
  attn    pre-norm GQA attention + MLP            (dense archs)
  moe     pre-norm GQA attention + MoE FFN        (mixtral / qwen3 / moonshot)
The other kinds (mlstm, slstm, hybrid) are ROADMAP item "Other model
families".
"""
from __future__ import annotations

from typing import Optional

import torch

from . import moe as moe_lib
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
    return AttnSpec(
        num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim,
        qkv_bias=cfg.qkv_bias,
        rope_theta=cfg.rope_theta,
        window=window,
        causal=causal,
    )


_KINDS = ("attn", "moe")


def _check_kind(kind: str) -> None:
    if kind not in _KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ROADMAP item \"Other model "
            f"families\"); the port has the kinds {_KINDS}"
        )


def init_block(gen: torch.Generator, cfg, kind: str, window: Optional[int], *,
               dtype=torch.bfloat16, lead: tuple = ()) -> dict:
    """One block's parameters; ``lead`` stacks several layers' blocks."""
    _check_kind(kind)
    if kind == "moe" and not cfg.d_ff:
        raise ValueError("moe blocks need d_ff (expert width)")
    d = cfg.d_model
    p = {
        "norm1": init_rms_norm(d, gen.device, lead),
        "attn": init_attention(gen, d, attn_spec_for(cfg, window), dtype, lead),
    }
    if cfg.d_ff:
        p["norm2"] = init_rms_norm(d, gen.device, lead)
        if kind == "moe":
            p["moe"] = moe_lib.init_moe(gen, cfg, dtype, lead)
        else:
            p["mlp"] = init_mlp(gen, d, cfg.d_ff, cfg.act, dtype, lead)
    return p


def init_block_cache(cfg, kind: str, window: Optional[int], batch: int,
                     max_len: int, device, dtype=torch.bfloat16) -> dict:
    """Zero decode cache for one block. ``dtype`` is accepted for the
    reference's signature and, as there, read by no block kind the port
    has: the attention cache takes ``cfg.kv_cache_dtype`` (a moe block's
    cache is its attention's)."""
    _check_kind(kind)
    kv_dt = getattr(torch, cfg.kv_cache_dtype)
    return {"attn": init_attn_cache(batch, max_len, attn_spec_for(cfg, window), kv_dt, device)}


def apply_block(p, x: torch.Tensor, cfg, kind: str, window: Optional[int], *,
                mode: str = "train", cache: dict | None = None, cur_pos: int | None = None,
                max_len: int = 0, prefix_len: int = 0, positions=None, mesh=None,
                transport=None):
    """Returns (x, cache, aux): the cache is None in train mode, the
    prefill-built cache (grown to ``max_len``) or the decode cache with the
    new token appended in place; ``aux`` is the block's 0-d f32 auxiliary
    loss (the router's load-balancing loss of a moe block, 0 otherwise).
    ``positions`` as :func:`attention`'s. ``mesh`` (an emulated mesh)
    routes a moe block's expert dispatch over its ranks when
    ``cfg.moe_dispatch == 'alltoallv'``, its rows moved by ``transport``
    (see :func:`.moe.moe_ffn`); None keeps the dense einsum formulation."""
    _check_kind(kind)
    spec = attn_spec_for(cfg, window)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(p["norm1"], x, cfg.norm_eps)
    y, ac = attention(p["attn"], h, spec, mode=mode, positions=positions,
                      prefix_len=prefix_len,
                      cache=None if cache is None else cache["attn"], cur_pos=cur_pos)
    if mode == "prefill":
        if max_len:
            ac = _grow_cache(ac, max_len, spec)
        kv_dt = getattr(torch, cfg.kv_cache_dtype)
        ac = {**ac, "k": ac["k"].to(kv_dt), "v": ac["v"].to(kv_dt)}
    x = x + y
    if "mlp" in p:
        x = x + mlp(p["mlp"], rms_norm(p["norm2"], x, cfg.norm_eps), cfg.act)
    elif "moe" in p:
        y, a = moe_lib.moe_ffn(p["moe"], rms_norm(p["norm2"], x, cfg.norm_eps), cfg,
                               mesh=mesh, transport=transport)
        x = x + y
        aux = aux + a
    return x, (None if mode == "train" else {"attn": ac}), aux


def _grow_cache(cache: dict, max_len: int, spec: AttnSpec) -> dict:
    """Extend a prefill-built cache to decode capacity ``max_len`` (a
    windowed layer's ring holds at most ``window`` slots)."""
    target = min(max_len, spec.window) if spec.window else max_len
    pad = target - cache["k"].shape[1]
    if pad <= 0:
        return cache
    k = torch.nn.functional.pad(cache["k"], (0, 0, 0, 0, 0, pad))
    v = torch.nn.functional.pad(cache["v"], (0, 0, 0, 0, 0, pad))
    pos = torch.nn.functional.pad(cache["pos"], (0, pad), value=-1)
    return {"k": k, "v": v, "pos": pos}
