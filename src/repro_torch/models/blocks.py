"""Block assembly with a uniform (init, apply) interface per ``kind``.

Kinds:
  attn    pre-norm GQA attention + MLP            (dense archs)
  moe     pre-norm GQA attention + MoE FFN        (mixtral / qwen3 / moonshot)
  mlstm   matrix-LSTM mixer                       (xLSTM)
  slstm   scalar-LSTM mixer                       (xLSTM)
  hybrid  parallel attention + mamba heads + MLP  (hymba)

Caches are dicts whose structure depends on the kind: ``attn`` for the
attention's, ``ssm`` for a recurrent state, and ``cross`` for a whisper
decoder block's cross-attention keys and values. Decode writes the first
two into the caller's cache in place and reads the third.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import moe as moe_lib
from . import ssm
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

__all__ = ["attn_spec_for", "init_block", "apply_block", "init_block_cache", "prefill_cache"]


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


_KINDS = ("attn", "moe", "mlstm", "slstm", "hybrid")
_ATTN_KINDS = ("attn", "moe", "hybrid")


def _check_kind(kind: str) -> None:
    if kind not in _KINDS:
        raise ValueError(f"unknown block kind {kind!r}; the kinds are {_KINDS}")


def init_block(gen: torch.Generator, cfg, kind: str, window: Optional[int], *,
               cross: bool = False, causal: bool = True, dtype=torch.bfloat16,
               lead: tuple = ()) -> dict:
    """One block's parameters; ``lead`` stacks several layers' blocks.
    ``cross`` adds a whisper decoder block's ``norm_x`` and ``cross``
    attention (with the config's QKV biases)."""
    _check_kind(kind)
    if kind == "moe" and not cfg.d_ff:
        raise ValueError("moe blocks need d_ff (expert width)")
    d = cfg.d_model
    spec = attn_spec_for(cfg, window, causal)
    p = {"norm1": init_rms_norm(d, gen.device, lead)}
    if kind in _ATTN_KINDS:
        p["attn"] = init_attention(gen, d, spec, dtype, lead)
    if kind == "hybrid":
        p["ssm"] = ssm.init_mamba(gen, cfg, dtype, lead)
        p["mix_a"] = torch.ones(lead, dtype=torch.float32, device=gen.device)
        p["mix_m"] = torch.ones(lead, dtype=torch.float32, device=gen.device)
    elif kind == "mlstm":
        p["ssm"] = ssm.init_mlstm(gen, cfg, dtype, lead)
    elif kind == "slstm":
        p["ssm"] = ssm.init_slstm(gen, cfg, dtype, lead)
    if kind in _ATTN_KINDS and cfg.d_ff:
        p["norm2"] = init_rms_norm(d, gen.device, lead)
        if kind == "moe":
            p["moe"] = moe_lib.init_moe(gen, cfg, dtype, lead)
        else:
            p["mlp"] = init_mlp(gen, d, cfg.d_ff, cfg.act, dtype, lead)
    if cross:
        p["norm_x"] = init_rms_norm(d, gen.device, lead)
        p["cross"] = init_attention(gen, d, spec, dtype, lead)
    return p


# the recurrent state of each kind that carries one, by its cache keys
_STATE_KEYS = {"hybrid": ("h", "conv"), "mlstm": ("C", "n"), "slstm": ("c", "n", "h")}


def init_block_cache(cfg, kind: str, window: Optional[int], batch: int,
                     max_len: int, device, dtype=torch.bfloat16) -> dict:
    """Zero decode cache for one block. ``dtype`` is accepted for the
    reference's signature and, as there, read by no block kind: the
    attention cache takes ``cfg.kv_cache_dtype`` (a moe block's cache is
    its attention's), the recurrent states are f32."""
    _check_kind(kind)
    d = cfg.d_model
    di = cfg.ssm_expand * d
    H = cfg.num_heads
    cache = {}
    if kind in _ATTN_KINDS:
        kv_dt = getattr(torch, cfg.kv_cache_dtype)
        cache["attn"] = init_attn_cache(batch, max_len, attn_spec_for(cfg, window), kv_dt,
                                        device)
    shapes = {"hybrid": ((batch, di, cfg.ssm_state), (batch, cfg.ssm_conv - 1, di)),
              "mlstm": ((batch, H, di // H, di // H), (batch, H, di // H)),
              "slstm": ((batch, d),) * 3}
    if kind in _STATE_KEYS:
        cache["ssm"] = {key: torch.zeros(shape, dtype=torch.float32, device=device)
                        for key, shape in zip(_STATE_KEYS[kind], shapes[kind])}
    return cache


def _mixer(p, h: torch.Tensor, cfg, kind: str, mode: str, cache: dict | None):
    """A recurrent mixer over the normed input ``h``: Mamba (a hybrid
    block's), mLSTM or sLSTM. Returns (y, the new state as its cache dict,
    None in train mode); decode copies the new state into ``cache['ssm']``
    in place and returns that dict."""
    seq, step = {"hybrid": (ssm.mamba_seq, ssm.mamba_step),
                 "mlstm": (ssm.mlstm_seq, ssm.mlstm_step),
                 "slstm": (ssm.slstm_seq, ssm.slstm_step)}[kind]
    keys = _STATE_KEYS[kind]
    if mode in ("train", "prefill"):
        y, st = seq(p["ssm"], h, cfg)
        return y, (None if mode == "train" else dict(zip(keys, st)))
    state = cache["ssm"]
    y, st = step(p["ssm"], h, tuple(state[key] for key in keys), cfg)
    for key, new in zip(keys, st):
        state[key].copy_(new)
    return y, state


def apply_block(p, x: torch.Tensor, cfg, kind: str, window: Optional[int], *,
                mode: str = "train", cache: dict | None = None, cur_pos: int | None = None,
                max_len: int = 0, prefix_len: int = 0, positions=None, causal: bool = True,
                cross_inputs: torch.Tensor | None = None, mesh=None, transport=None):
    """Returns (x, cache, aux): the cache is None in train mode, the
    prefill-built cache (attention grown to ``max_len``, the final
    recurrent state) or the decode cache with the new token appended and
    the new recurrent state written, in place; ``aux`` is the block's 0-d
    f32 auxiliary loss (the router's load-balancing loss of a moe block, 0
    otherwise). ``positions`` as :func:`attention`'s. ``mesh`` (an
    emulated mesh) routes a moe block's expert dispatch over its ranks
    when ``cfg.moe_dispatch == 'alltoallv'``, its rows moved by
    ``transport`` (see :func:`.moe.moe_ffn`); None keeps the dense einsum
    formulation. A hybrid block runs attention and Mamba on the same normed
    input and mixes them with its 0-d f32 ``mix_a``/``mix_m`` in the
    compute dtype. ``causal=False`` makes the self-attention bidirectional
    (a whisper encoder block). A block with ``cross`` parameters attends
    after its self-attention to the encoder's normed output
    ``cross_inputs`` (B, frames, D) in train and prefill; prefill keeps
    those keys and values (biases added) as ``cache['cross']``, which
    decode reads and hands back, the same tensors."""
    _check_kind(kind)
    spec = attn_spec_for(cfg, window, causal)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache = {}
    h = rms_norm(p["norm1"], x, cfg.norm_eps)
    if kind in _ATTN_KINDS:
        y, ac = attention(p["attn"], h, spec, mode=mode, positions=positions,
                          prefix_len=prefix_len,
                          cache=None if cache is None else cache["attn"], cur_pos=cur_pos)
        new_cache["attn"] = prefill_cache(ac, max_len, spec, cfg) if mode == "prefill" else ac
        if kind == "hybrid":
            m, new_cache["ssm"] = _mixer(p, h, cfg, kind, mode, cache)
            y = p["mix_a"].to(x.dtype) * y + p["mix_m"].to(x.dtype) * m
    else:
        y, new_cache["ssm"] = _mixer(p, h, cfg, kind, mode, cache)
    x = x + y
    if "cross" in p:
        cp = p["cross"]
        if mode == "decode":
            ck, cv = cache["cross"]["k"], cache["cross"]["v"]
            new_cache["cross"] = cache["cross"]
        else:
            ck = torch.einsum("bsd,dhk->bshk", cross_inputs, cp["wk"])
            cv = torch.einsum("bsd,dhk->bshk", cross_inputs, cp["wv"])
            if spec.qkv_bias:
                ck, cv = ck + cp["bk"], cv + cp["bv"]
            new_cache["cross"] = {"k": ck, "v": cv}
        y, _ = attention(cp, rms_norm(p["norm_x"], x, cfg.norm_eps), spec, cross_kv=(ck, cv))
        x = x + y
    if "mlp" in p:
        x = x + mlp(p["mlp"], rms_norm(p["norm2"], x, cfg.norm_eps), cfg.act)
    elif "moe" in p:
        y, a = moe_lib.moe_ffn(p["moe"], rms_norm(p["norm2"], x, cfg.norm_eps), cfg,
                               mesh=mesh, transport=transport)
        x = x + y
        aux = aux + a
    return x, (None if mode == "train" else new_cache), aux


def prefill_cache(cache: dict, max_len: int, spec: AttnSpec, cfg) -> dict:
    """A prefill-built attention cache as decode keeps it: grown to
    ``max_len`` (when given) and cast to ``cfg.kv_cache_dtype``."""
    if max_len:
        cache = _grow_cache(cache, max_len, spec)
    kv_dt = getattr(torch, cfg.kv_cache_dtype)
    return {**cache, "k": cache["k"].to(kv_dt), "v": cache["v"].to(kv_dt)}


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
