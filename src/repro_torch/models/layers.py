"""Shared model layers (dense path): norms, RoPE, GQA attention (windowed,
prefix-LM, cross), SwiGLU MLP, dense, embeddings. Plain functions over
dicts of tensors, in the reference's layouts so both packages are compared
like with like.

Conventions:
  * activations ``(B, T, D)``; attention heads ``(B, T, H, hd)``.
  * caches: dict with 'k','v' of shape (B, S_cache, KV, hd) plus 'pos'
    (stored absolute positions (S_cache,) int32, -1 = empty slot), with
    S_cache == max_len for global layers and min(max_len, window) for
    sliding-window layers, whose cache is a ring buffer (slot = pos % S).
  * decode appends to its cache IN PLACE (the reference returns an updated
    copy); the caller's cache tensors hold the new entry.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels import flash_attention as flash

__all__ = [
    "AttnSpec",
    "rms_norm",
    "init_rms_norm",
    "rope",
    "init_dense",
    "dense",
    "init_attention",
    "attend",
    "attention",
    "decode_shard",
    "init_attn_cache",
    "init_mlp",
    "mlp",
    "init_embedding",
    "embed_tokens",
    "unembed",
    "cross_entropy_loss",
    "prefill_tiles",
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
# dense
# ---------------------------------------------------------------------------


def init_dense(gen: torch.Generator, d_in: int, d_out: int, bias: bool = False,
               dtype=torch.bfloat16) -> dict:
    p = {"w": _norm_init(gen, (d_in, d_out), d_in**-0.5, dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def dense(p, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


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
    window: Optional[int] = None     # sliding window (None = global)
    causal: bool = True
    use_rope: bool = True


def init_attention(gen: torch.Generator, d: int, spec: AttnSpec, dtype=torch.bfloat16,
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
    """Cache for one attention layer. Windowed layers keep a ring buffer."""
    S = min(max_len, spec.window) if spec.window else max_len
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


# S at which train/prefill attention leaves the dense softmax (full T x S
# scores never materialize), as in the reference: prefill goes through the
# flash_attention kernel, train through the differentiable block loop.
CHUNKED_ATTN_MIN_S = 4096
_CHUNK_BLOCK = 1024


def prefill_tiles(T: int, prefix_len: int) -> tuple[int, int]:
    """Caller tiles ``(bq, bk)`` of a prefill through the flash kernel. The
    kernel's tile test (the reference kernel's) leaves the prefix out of its
    causal term, so a query tile shorter than the prefix would skip prefix
    keys that the mask allows; ``bq`` is the least multiple of 128 at least
    ``prefix_len`` that divides T, under which no allowed key lies in a
    skipped tile (a T of 128 or less is one tile)."""
    if T <= 128:
        return 128, 128
    for bq in range(128 * max(1, -(-prefix_len // 128)), T + 1, 128):
        if T % bq == 0:
            return bq, 128
    raise ValueError(f"prefix of {prefix_len}: no multiple of 128 at least that long divides "
                     f"the prefill's {T} positions, so a query tile would skip prefix keys")


def _mask_block(spec: AttnSpec, prefix_len: int, i, j):
    """Boolean mask for query positions i (T,) x key positions j (block,)."""
    ii, jj = i[:, None], j[None, :]
    if spec.causal:
        m = jj <= ii
        if prefix_len:
            m = m | (jj < prefix_len)
    else:
        m = torch.ones((ii.shape[0], jj.shape[1]), dtype=torch.bool, device=i.device)
    if spec.window is not None:
        m = m & (jj > ii - spec.window)
        if prefix_len:
            m = m | ((jj < prefix_len) & (ii < prefix_len))
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


def attend(q, k, v, spec: AttnSpec, *, mode: str, prefix_len: int = 0) -> torch.Tensor:
    """Train or prefill attention of rotated ``q`` (B, T, H, hd) over ``k``,
    ``v`` (B, T, KV, hd): dense below CHUNKED_ATTN_MIN_S keys, else the
    ``flash_attention`` kernel in prefill and the differentiable block loop
    in train."""
    T = q.shape[1]
    if k.shape[1] < CHUNKED_ATTN_MIN_S:
        return _sdpa(q, k, v, full_mask(T, spec, q.device, prefix_len), spec)
    if mode == "prefill":
        bq, bk = prefill_tiles(T, prefix_len)
        return flash.flash_attention(q, k, v, causal=spec.causal, window=spec.window,
                                     prefix=prefix_len, bq=bq, bk=bk)
    # the kernel has no backward (neither has the reference's Pallas
    # kernel, whose training takes this XLA twin): train keeps the
    # differentiable block loop
    return _chunked_sdpa(q, k, v, spec, prefix_len)


def attention(
    p,
    x: torch.Tensor,
    spec: AttnSpec,
    *,
    mode: str = "train",           # train | prefill | decode
    positions: torch.Tensor | None = None,
    prefix_len: int = 0,
    cache: dict | None = None,
    cur_pos: int | None = None,    # absolute position of the new token
    cross_kv: tuple | None = None,  # (k, v) (B, S, KV, hd): cross attention
):
    """Returns (out, cache): None in train mode, the prefill-built cache, or
    ``cache`` with the new token appended in place. ``positions``
    (broadcastable to (B, T)) rotate q and k in train and prefill in place
    of ``0..T-1``, as the reference's do; the mask and the cache's slots
    keep ``0..T-1``.

    ``cross_kv`` (a whisper decoder's cross attention, any mode): keys and
    values precomputed from the encoder's output, their biases added by the
    caller; every query sees every key, nothing is rotated, no cache is
    read or written, and the cache returned is None."""
    B, T, _D = x.shape
    if cross_kv is not None:
        k, v = cross_kv
        q = torch.einsum("btd,dhk->bthk", x, p["wq"])
        if spec.qkv_bias:
            q = q + p["bq"]
        mask = torch.ones((1, T, k.shape[1]), dtype=torch.bool, device=x.device)
        return _out_proj(_sdpa(q, k, v, mask, spec), p["wo"]), None
    if mode in ("train", "prefill"):
        if positions is None:
            positions = torch.arange(T, device=x.device)[None, :]
        q, k, v = _qkv(p, spec, x)
        if spec.use_rope:
            q = rope(q, positions, spec.rope_theta)
            k = rope(k, positions, spec.rope_theta)
        out = attend(q, k, v, spec, mode=mode, prefix_len=prefix_len)
        return _out_proj(out, p["wo"]), (_fill_cache(k, v, spec, T) if mode == "prefill"
                                         else None)

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
    if spec.window is not None:
        valid = valid & (cache["pos"] > cur_pos - spec.window)
    if cache["k"].dtype != q.dtype and S >= HEADBLOCKED_MIN_S:
        out = _decode_sdpa_headblocked(q, cache["k"], cache["v"], valid[None, None, :], spec)
    else:
        out = _sdpa(q, cache["k"], cache["v"], valid[None, None, :], spec)
    return _out_proj(out, p["wo"]), cache


# S from which decode over a cache narrower than the compute dtype (an f8
# cache) takes the head-blocked softmax, as in the reference: ``_sdpa``'s
# cast of the whole cache would hold a compute-dtype copy of k and v, twice
# the bytes of the f8 cache itself
HEADBLOCKED_MIN_S = 8192


def _decode_sdpa_headblocked(q, k, v, mask, spec: AttnSpec, heads_per_block: int = 8):
    """q: (B, 1, H, hd); k/v: (B, S, KV, hd) in a narrower cache dtype.
    Heads are independent under the softmax, so a loop over blocks of at
    most ``heads_per_block`` kv heads (lowered until it divides KV) runs a
    whole ``_sdpa`` a block; only one block of the cache is ever cast to the
    compute dtype."""
    B, T, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    hb = min(heads_per_block, KV)
    while KV % hb:
        hb -= 1
    qg = q.reshape(B, T, KV, G, hd)
    outs = []
    for k0 in range(0, KV, hb):
        qb = qg[:, :, k0:k0 + hb].reshape(B, T, hb * G, hd)
        kb = k[:, :, k0:k0 + hb].to(q.dtype)
        vb = v[:, :, k0:k0 + hb].to(q.dtype)
        outs.append(_sdpa(qb, kb, vb, mask, spec).reshape(B, T, hb, G, hd))
    return torch.cat(outs, dim=2).reshape(B, T, H, hd)


def decode_shard(q, k, v, valid) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode attention of ``q`` (B, 1, H, hd) over one shard of a cache,
    ``k``/``v`` (B, S_shard, KV, hd) with ``valid`` (S_shard,) its slots
    that hold a key: (out (B, 1, H, hd), lse (B, 1, H)), both f32, the
    softmax over the shard's valid keys alone and its log-sum-exp. The
    scores are ``_sdpa``'s (the product in q's dtype, then f32); the
    weights and the values are summed in f32. A shard with no valid slot
    gives out 0 and lse -inf, so a merge (``tensor_parallel.merge_shards``)
    adds nothing from it."""
    B, T, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, T, KV, H // KV, hd)
    s = torch.einsum("btkgh,bskh->bkgts", qg, k.to(q.dtype)).float() * (hd**-0.5)
    s = torch.where(valid, s, -math.inf)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    w = torch.exp(s - m)
    l = w.sum(dim=-1)
    o = torch.einsum("bkgts,bskh->btkgh", w, v.float())
    o = o / torch.clamp(l, min=1e-30).permute(0, 3, 1, 2)[..., None]
    lse = torch.where(l > 0, m[..., 0] + torch.log(l), -math.inf)
    return o.reshape(B, T, H, hd), lse.permute(0, 3, 1, 2).reshape(B, T, H)


def _fill_cache(k, v, spec: AttnSpec, T: int) -> dict:
    """Build a decode cache from prefill K/V; a windowed layer keeps the
    last ``window`` positions in ring-buffer order (slot = pos % window)."""
    if spec.window is not None and T > spec.window:
        W = spec.window
        pos_abs = torch.arange(T - W, T, device=k.device)
        order = torch.argsort(pos_abs % W)
        pos_abs = pos_abs[order]
        return {"k": k[:, T - W:][:, order], "v": v[:, T - W:][:, order],
                "pos": pos_abs.to(torch.int32)}
    pos = torch.arange(k.shape[1], dtype=torch.int32, device=k.device)
    return {"k": k, "v": v, "pos": pos}


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, d: int, f: int, act: str = "silu",
             dtype=torch.bfloat16, lead: tuple = ()) -> dict:
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


def init_embedding(gen: torch.Generator, vocab: int, d: int, tie: bool = True,
                   dtype=torch.bfloat16) -> dict:
    p = {"tokens": _norm_init(gen, (vocab, d), d**-0.5, dtype)}
    if not tie:
        p["unembed"] = _norm_init(gen, (vocab, d), d**-0.5, dtype)
    return p


class _RowGather(torch.autograd.Function):
    """``table[tokens]`` whose backward sums each row's gradients in f32,
    over the rows the tokens name, and rounds once to the table's dtype.
    Indexing's own backward accumulates into a bf16 table, one rounding per
    occurrence, so a frequent token's row drifts with the count of its
    repeats: on an H100, minitron-8b's embedding gradient from one bf16 pass
    over a Zipf batch of 8 x 512 tokens lay 3.0% from the f32 one, and
    0.47% for a pass over a quarter of it; summed in f32, 0.28% and 0.26%
    (tools/grad_precision.py). ``index_put_`` with ``accumulate`` sorts its
    indices on the card, so two runs give the same bits."""

    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.table_shape, ctx.table_dtype = table.shape, table.dtype
        return table[tokens]

    @staticmethod
    def backward(ctx, grad):
        (tokens,) = ctx.saved_tensors
        return row_grad(tokens.reshape(-1), grad.reshape(-1, grad.shape[-1]),
                        ctx.table_shape, ctx.table_dtype), None


def row_grad(index: torch.Tensor, grad: torch.Tensor, shape, dtype) -> torch.Tensor:
    """The gradient of a table of ``shape`` and ``dtype`` whose rows
    ``index`` (N,) were read with upstream gradients ``grad`` (N, D): each
    row's gradients summed in f32, in the order they come, and rounded once
    (:class:`_RowGather`'s backward)."""
    rows, where = torch.unique(index, return_inverse=True)
    acc = torch.zeros((rows.numel(), grad.shape[-1]), dtype=torch.float32, device=grad.device)
    acc.index_put_((where,), grad.float(), accumulate=True)
    out = torch.zeros(shape, dtype=dtype, device=grad.device)
    out[rows] = acc.to(dtype)
    return out


def embed_tokens(p, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the embedding table; the table's gradient is summed in f32
    (:class:`_RowGather`)."""
    return _RowGather.apply(p["tokens"], tokens)


def unembed(p, x: torch.Tensor) -> torch.Tensor:
    table = p.get("unembed", p["tokens"])
    return torch.einsum("btd,vd->btv", x, table).float()


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """logits (B, T, V) f32, labels (B, T) int. Returns the mean nll."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels[..., None], dim=-1)[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.to(nll.dtype)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
