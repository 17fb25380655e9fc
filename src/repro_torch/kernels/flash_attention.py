"""Blocked online-softmax attention (CUDA), with its plain PyTorch version.

Replaces the reference's Pallas ``flash_attention``
(``src/repro/kernels/flash_attention.py:102``); the kernel and its design
note are in ``csrc/flash_attention.cu``. Same signature as the reference's
``kernels/ops.py::flash_attention``: q ``(B, T, H, hd)``, k/v
``(B, S, KV, hd)`` with ``H % KV == 0``, causal / sliding-window /
prefix-LM masks, output ``(B, T, H, hd)`` in q's dtype. The caller's
``(bq, bk)`` tiles decide which (query, key) pairs are processed: a tile
that the reference's ``relevant`` test skips contributes nothing, as there.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. The kernel has no backward: training takes the model's
differentiable ``_chunked_sdpa``, as the reference's training takes its XLA
twin.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_plain", "tile_relevant", "attention_flops"]

NEG_INF = -1e30  # the reference's mask value; the running max starts here too
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (16, 32, 64, 128)


def _tiles(q, k, v, bq: int, bk: int, window: Optional[int]) -> tuple[int, int]:
    """Check shapes and the tile contract; returns the effective (bq, bk)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention needs q (B,T,H,hd), k and v (B,S,KV,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, T, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or k.shape[2] < 1 or H % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)} "
                         "(batch, head width, H % KV == 0)")
    if window is not None and window < 0:
        raise ValueError(f"window must be None or >= 0, got {window}")
    S = k.shape[1]
    bq, bk = min(bq, T), min(bk, S)
    if bq < 1 or bk < 1 or T % bq or S % bk:
        raise ValueError(f"tiles must divide the sequence: T={T} % bq={bq}, S={S} % bk={bk}")
    return bq, bk


def tile_relevant(q0: int, k0: int, bq: int, bk: int, *, causal: bool,
                  window: Optional[int], prefix: int) -> bool:
    """The reference kernel's test whether tile (q0, k0) runs at all."""
    rel = True
    if causal:
        rel = k0 <= q0 + bq - 1
    if window is not None:
        in_win = k0 + bk - 1 > q0 - window
        if prefix:
            in_win = in_win or k0 < prefix
        rel = rel and in_win
    return rel


def _mask(i: torch.Tensor, j: torch.Tensor, causal: bool, window: Optional[int],
          prefix: int) -> torch.Tensor:
    """The reference kernel's element mask, queries ``i`` x keys ``j``."""
    ii, jj = i[:, None], j[None, :]
    if causal:
        m = jj <= ii
        if prefix:
            m = m | (jj < prefix)
    else:
        m = torch.ones((ii.shape[0], jj.shape[1]), dtype=torch.bool, device=i.device)
    if window is not None:
        w_ok = jj > ii - window
        if prefix:
            w_ok = w_ok | ((jj < prefix) & (ii < prefix))
        m = m & w_ok
    return m


def attention_flops(T: int, S: int, H: int, hd: int, B: int = 1, *, causal: bool = True,
                    window: Optional[int] = None, prefix: int = 0, bq: int = 128,
                    bk: int = 128) -> int:
    """Flops of the (query, key) pairs that the masks allow within the
    tiles that run: 2*hd for q.k and 2*hd for p.v per pair. A masked pair
    of a kept tile is not counted: it adds nothing to a row's result once
    the row has met an allowed key."""
    bq, bk = min(bq, T), min(bk, S)
    i_all = torch.arange(T)
    pairs = 0
    for k0 in range(0, S, bk):
        rel = [tile_relevant(q0, k0, bq, bk, causal=causal, window=window, prefix=prefix)
               for q0 in range(0, T, bq)]
        if any(rel):  # the kept q tiles form one run, as in the plain version
            lo = rel.index(True) * bq
            i = i_all[lo:lo + sum(rel) * bq]
            pairs += int(_mask(i, torch.arange(k0, k0 + bk), causal, window, prefix).sum())
    return 4 * hd * pairs * H * B


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: Optional[int] = None, prefix: int = 0,
                          bq: int = 128, bk: int = 128) -> torch.Tensor:
    """The plain version: the reference kernel's online softmax over the
    caller's kv tiles in f32, each tile applied to the query rows whose
    tiles keep it (the rows of a skipped tile are left as they are). The q
    tiles that keep a kv tile form one run: a causal suffix cut by a window
    prefix."""
    bq, bk = _tiles(q, k, v, bq, bk, window)
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = hd**-0.5
    dev = q.device
    qg = q.reshape(B, T, KV, G, hd).float()
    acc = torch.zeros((B, KV, G, T, hd), dtype=torch.float32, device=dev)
    m = torch.full((B, KV, G, T), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G, T), dtype=torch.float32, device=dev)
    i_all = torch.arange(T, device=dev)
    for k0 in range(0, S, bk):
        rel = [tile_relevant(q0, k0, bq, bk, causal=causal, window=window, prefix=prefix)
               for q0 in range(0, T, bq)]
        if not any(rel):
            continue
        lo = rel.index(True) * bq
        hi = lo + sum(rel) * bq
        i = i_all[lo:hi]
        j = torch.arange(k0, k0 + bk, device=dev)
        s = torch.einsum("btkgh,bskh->bkgts", qg[:, lo:hi], k[:, k0:k0 + bk].float()) * scale
        s = torch.where(_mask(i, j, causal, window, prefix), s, NEG_INF)
        m_prev = m[..., lo:hi]
        m_new = torch.maximum(m_prev, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m_prev - m_new)
        l[..., lo:hi] = l[..., lo:hi] * corr + p.sum(dim=-1)
        acc[..., lo:hi, :] = acc[..., lo:hi, :] * corr[..., None] + torch.einsum(
            "bkgts,bskh->bkgth", p, v[:, k0:k0 + bk].float())
        m[..., lo:hi] = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.movedim(3, 1).reshape(B, T, H, hd).to(q.dtype)


def _launch(out, q, k, v, *, causal, window, prefix, bq, bk) -> None:
    lib = _build.load("flash_attention")
    fn = lib.repro_flash_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float] + \
        [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    _KERNEL_DTYPES[q.dtype], B, T, S, H, KV, hd, hd**-0.5, int(causal),
                    -1 if window is None else int(window), int(prefix), bq, bk, stream),
                 "flash_attention")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: Optional[int] = None, prefix: int = 0, bq: int = 128,
                    bk: int = 128) -> torch.Tensor:
    """Attention of q over k/v with the reference kernel's masks and tile
    skipping. Returns (B, T, H, hd) in q's dtype."""
    bq, bk = _tiles(q, k, v, bq, bk, window)
    devices = {q.device, k.device, v.device}
    if devices == {torch.device("cpu")}:
        return flash_attention_plain(q, k, v, causal=causal, window=window, prefix=prefix,
                                     bq=bq, bk=bk)
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors on one device, "
                         f"not {sorted(map(str, devices))}")
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the flash_attention kernel takes float32 or bfloat16 q, k, v of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[3] not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"the flash_attention kernel takes head widths "
                         f"{_KERNEL_HEAD_DIMS}, got {q.shape[3]}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous q, k and v")
    if q.shape[0] > 65535 or q.shape[2] > 65535:
        raise ValueError("flash_attention's grid takes at most 65535 sequences and heads")
    out = torch.empty_like(q)
    _launch(out, q, k, v, causal=causal, window=window, prefix=prefix, bq=bq, bk=bk)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
