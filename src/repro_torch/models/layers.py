"""Shared model layers (dense path): norms, RoPE, GQA attention, SwiGLU MLP,
embeddings. Plain functions over dicts of tensors, in the reference's
layouts so both packages are compared like with like.

Conventions:
  * activations ``(B, T, D)``; attention heads ``(B, T, H, hd)``.
  * caches: dict with 'k','v' of shape (B, S_cache, KV, hd) plus 'pos'
    (stored absolute positions (S_cache,) int32, -1 = empty slot), with
    S_cache == max_len. Only global attention is ported: the reference's
    sliding-window ring buffers wait for a config that uses them
    (ROADMAP A.11).
  * decode appends to its cache IN PLACE (the reference returns an updated
    copy); the caller's cache tensors hold the new entry.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

__all__ = [
    "AttnSpec",
    "rms_norm",
    "init_rms_norm",
    "rope",
    "init_attention",
    "attention",
    "init_attn_cache",
    "init_mlp",
    "mlp",
    "init_embedding",
    "embed_tokens",
    "unembed",
]


def _norm_init(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (x * scale).to(dtype)


# ---------------------------------------------------------------------------
# norm / rope
# ---------------------------------------------------------------------------


def init_rms_norm(d: int, device, lead: tuple = ()) -> dict:
    return {"scale": torch.ones(lead + (d,), dtype=torch.float32, device=device)}


def rms_norm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Normalize in f32, apply the scale in the compute dtype."""
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(var + eps)).to(dt)
    return out * p["scale"].to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding. x: (..., T, H, hd); positions: broadcastable to (..., T)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freqs  # (..., T, half)
    cos = torch.cos(ang)[..., None, :]  # (..., T, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    num_heads: int
    num_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    causal: bool = True
    use_rope: bool = True


def init_attention(gen: torch.Generator, d: int, spec: AttnSpec, dtype,
                   lead: tuple = ()) -> dict:
    """``lead`` prepends stacked dimensions (layers of a superblock)."""
    H, KV, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim
    s = d**-0.5
    p = {
        "wq": _norm_init(gen, lead + (d, H, hd), s, dtype),
        "wk": _norm_init(gen, lead + (d, KV, hd), s, dtype),
        "wv": _norm_init(gen, lead + (d, KV, hd), s, dtype),
        "wo": _norm_init(gen, lead + (H, hd, d), (H * hd) ** -0.5, dtype),
    }
    if spec.qkv_bias:
        for name, heads in (("bq", H), ("bk", KV), ("bv", KV)):
            p[name] = torch.zeros(lead + (heads, hd), dtype=dtype, device=gen.device)
    return p


def init_attn_cache(batch: int, max_len: int, spec: AttnSpec, dtype, device) -> dict:
    """Cache for one attention layer."""
    S = max_len
    KV, hd = spec.num_kv_heads, spec.head_dim
    return {
        "k": torch.zeros((batch, S, KV, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, S, KV, hd), dtype=dtype, device=device),
        "pos": torch.full((S,), -1, dtype=torch.int32, device=device),
    }


def _qkv(p, spec: AttnSpec, x):
    q = torch.einsum("btd,dhk->bthk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if spec.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def down_proj(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Projection with a compute-dtype output (the reference declares
    ``preferred_element_type=h.dtype``)."""
    return h @ w


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    B, T, H, hd = out.shape
    return down_proj(out.reshape(B, T, H * hd), wo.reshape(H * hd, -1))


def _sdpa(q, k, v, mask, spec: AttnSpec):
    """q: (B,T,H,hd); k,v: (B,S,KV,hd); mask broadcastable to (B,T,S)."""
    B, T, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, T, KV, G, hd)
    k = k.to(q.dtype)
    v = v.to(q.dtype)
    scores = torch.einsum("btkgh,bskh->bkgts", qg, k).float()
    scores = scores * (hd**-0.5)
    scores = torch.where(mask[:, None, None, :, :], scores, -1e30)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bskh->btkgh", w.to(v.dtype), v)
    return out.reshape(B, T, H, hd)


# S at which train/prefill attention switches to the memory-efficient
# KV-block-scanned softmax (full T x S scores never materialize), as in the
# reference.
CHUNKED_ATTN_MIN_S = 4096
_CHUNK_BLOCK = 1024


def _mask_block(spec: AttnSpec, prefix_len: int, i, j):
    """Boolean mask for query positions i (T,) x key positions j (block,)."""
    ii, jj = i[:, None], j[None, :]
    if spec.causal:
        m = jj <= ii
        if prefix_len:
            m = m | (jj < prefix_len)
    else:
        m = torch.ones((ii.shape[0], jj.shape[1]), dtype=torch.bool, device=i.device)
    return m


def _chunked_sdpa(q, k, v, spec: AttnSpec, prefix_len: int, block: int = _CHUNK_BLOCK):
    """Flash-style attention: a loop over KV blocks with running (max, sum).
    Peak memory is O(B*T*H*block) instead of O(B*T*H*S)."""
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    block = min(block, S)
    assert S % block == 0, (S, block)
    qg = q.reshape(B, T, KV, G, hd).float() * (hd**-0.5)
    i = torch.arange(T, device=q.device)
    o = torch.zeros((B, KV, G, T, hd), dtype=torch.float32, device=q.device)
    m = torch.full((B, KV, G, T), -math.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, KV, G, T), dtype=torch.float32, device=q.device)
    for j0 in range(0, S, block):
        j = j0 + torch.arange(block, device=q.device)
        mask = _mask_block(spec, prefix_len, i, j)
        s = torch.einsum("btkgh,bskh->bkgts", qg, k[:, j0:j0 + block].float())
        s = torch.where(mask[None, None, None], s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum("bkgts,bskh->bkgth", p,
                                               v[:, j0:j0 + block].float())
        m = m_new
    out = o / torch.clamp(l[..., None], min=1e-30)
    out = out.movedim(3, 1).reshape(B, T, H, hd)
    return out.to(q.dtype)


def full_mask(T: int, spec: AttnSpec, device, prefix_len: int = 0):
    """(1, T, S=T) mask for train/prefill."""
    i = torch.arange(T, device=device)
    return _mask_block(spec, prefix_len, i, i)[None]


def attention(
    p,
    x: torch.Tensor,
    spec: AttnSpec,
    *,
    mode: str = "prefill",         # prefill | decode
    prefix_len: int = 0,
    cache: dict | None = None,
    cur_pos: int | None = None,    # absolute position of the new token
):
    """Returns (out, cache): the prefill-built cache, or ``cache`` with the
    new token appended in place."""
    B, T, _D = x.shape
    if mode == "prefill":
        positions = torch.arange(T, device=x.device)[None, :]
        q, k, v = _qkv(p, spec, x)
        if spec.use_rope:
            q = rope(q, positions, spec.rope_theta)
            k = rope(k, positions, spec.rope_theta)
        if k.shape[1] >= CHUNKED_ATTN_MIN_S:
            out = _chunked_sdpa(q, k, v, spec, prefix_len)
        else:
            out = _sdpa(q, k, v, full_mask(T, spec, x.device, prefix_len), spec)
        return _out_proj(out, p["wo"]), _fill_cache(k, v)

    # ---- decode: T == 1, append to cache ----
    if mode != "decode" or cache is None or cur_pos is None:
        raise ValueError("decode needs mode='decode', a cache and cur_pos")
    q, k_new, v_new = _qkv(p, spec, x)
    pos_b = torch.full((B, 1), cur_pos, dtype=torch.int32, device=x.device)
    if spec.use_rope:
        q = rope(q, pos_b, spec.rope_theta)
        k_new = rope(k_new, pos_b, spec.rope_theta)
    S = cache["k"].shape[1]
    slot = cur_pos % S
    cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
    cache["pos"][slot] = cur_pos
    valid = cache["pos"] >= 0
    out = _sdpa(q, cache["k"], cache["v"], valid[None, None, :], spec)
    return _out_proj(out, p["wo"]), cache


def _fill_cache(k, v) -> dict:
    """Build a decode cache from prefill K/V."""
    pos = torch.arange(k.shape[1], dtype=torch.int32, device=k.device)
    return {"k": k, "v": v, "pos": pos}


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, d: int, f: int, act: str, dtype,
             lead: tuple = ()) -> dict:
    p = {
        "w_up": _norm_init(gen, lead + (d, f), d**-0.5, dtype),
        "w_down": _norm_init(gen, lead + (f, d), f**-0.5, dtype),
    }
    if act in ("silu", "geglu"):
        p["w_gate"] = _norm_init(gen, lead + (d, f), d**-0.5, dtype)
    return p


def mlp(p, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    up = x @ p["w_up"]
    if act == "silu":
        h = F.silu(x @ p["w_gate"]) * up
    elif act == "geglu":
        h = F.gelu(x @ p["w_gate"], approximate="tanh") * up
    else:
        h = F.gelu(up, approximate="tanh")  # jax.nn.gelu default
    return down_proj(h, p["w_down"])


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------


def init_embedding(gen: torch.Generator, vocab: int, d: int, tie: bool, dtype) -> dict:
    p = {"tokens": _norm_init(gen, (vocab, d), d**-0.5, dtype)}
    if not tie:
        p["unembed"] = _norm_init(gen, (vocab, d), d**-0.5, dtype)
    return p


def embed_tokens(p, tokens: torch.Tensor) -> torch.Tensor:
    return p["tokens"][tokens]


def unembed(p, x: torch.Tensor) -> torch.Tensor:
    table = p.get("unembed", p["tokens"])
    return torch.einsum("btd,vd->btv", x, table).float()
