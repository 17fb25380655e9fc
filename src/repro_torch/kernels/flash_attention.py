"""Blocked online-softmax attention (CUDA), with its plain PyTorch version.

Replaces the reference's Pallas ``flash_attention``
(``src/repro/kernels/flash_attention.py:102``) with two hand-written
kernels, each with its design note in its source: ``csrc/flash_attention_sm90.cu``
(bf16 ``wgmma`` and TMA, head widths 64, 128 and 256, one instantiation each)
and ``csrc/flash_attention.cu`` (f32 FMAs on CUDA cores, f32 or bf16, head
widths 16 to 128 and 256: the route of f32 and of bf16 at widths 16 and 32).
:func:`kernel_route` picks one by dtype and head width alone. Same signature
as the reference's ``kernels/ops.py::flash_attention``: q ``(B, T, H, hd)``, k/v
``(B, S, KV, hd)`` with ``H % KV == 0``, causal / sliding-window /
prefix-LM masks, output ``(B, T, H, hd)`` in q's dtype. The caller's
``(bq, bk)`` tiles decide which (query, key) pairs are processed: a tile
that the reference's ``relevant`` test skips contributes nothing, as there.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel of
its route or raises. The kernels have no backward: training takes the
model's differentiable ``_chunked_sdpa``, as the reference's training takes
its XLA twin.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_plain", "flash_fwd", "flash_sm90", "kernel_route",
           "tile_relevant", "tile_classes", "attention_flops"]

NEG_INF = -1e30  # the reference's mask value; the running max starts here too
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the CUDA-core kernel's
_KERNEL_HEAD_DIMS = (16, 32, 64, 128, 256)
# the sm90 kernel's own (query rows, keys) per tile, by head width: 64-key
# tiles at 256 leave registers for O's 64 x 256 f32 accumulator
SM90_TILES = {64: (128, 128), 128: (128, 128), 256: (128, 64)}
SM90_HEAD_DIMS = tuple(SM90_TILES)


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


@functools.lru_cache(maxsize=64)
def tile_classes(T: int, S: int, *, causal: bool = True, window: Optional[int] = None,
                 prefix: int = 0, bq: int = 128, bk: int = 128, kq: int,
                 kk: int) -> torch.Tensor:
    """int8 ``(ceil(T/kq), ceil(S/kk))``: the class of each (kq x kk) tile of
    a kernel over the caller's (bq, bk) tiles (which must divide T and S).
    0: no pair of the tile lies in a caller tile that the reference keeps
    (the kernel does not load it); 1: every pair of the tile (rows below T;
    no key past S) is kept and allowed by the mask, so no mask is applied;
    2: anything else, the per-element path. A kept tile whose pairs are all
    masked is class 2, not 0: the reference processes it (it decides a row
    that has no allowed key)."""
    if T % bq or S % bk:
        raise ValueError(f"tiles must divide the sequence: T={T} % bq={bq}, S={S} % bk={bk}")
    rel = torch.tensor([[tile_relevant(q0, k0, bq, bk, causal=causal, window=window,
                                       prefix=prefix) for k0 in range(0, S, bk)]
                        for q0 in range(0, T, bq)], dtype=torch.bool)
    nqt, nkt = -(-T // kq), -(-S // kk)
    j = torch.arange(nkt * kk)
    in_s = j < S
    col_tile = torch.clamp(j // bk, max=S // bk - 1)
    out = torch.zeros((nqt, nkt), dtype=torch.int8)
    for a in range(nqt):
        i = torch.arange(a * kq, min(a * kq + kq, T))
        keep = rel[i // bq][:, col_tile] & in_s
        ok = (keep & _mask(i, j, causal, window, prefix)).view(len(i), nkt, kk)
        any_kept = keep.view(len(i), nkt, kk).any(2).any(0)
        out[a] = torch.where(ok.all(2).all(0), 1, torch.where(any_kept, 2, 0)).to(torch.int8)
    return out


@functools.lru_cache(maxsize=64)
def _classes_on(device: torch.device, T: int, S: int, causal: bool, window: Optional[int],
                prefix: int, bq: int, bk: int, kq: int, kk: int) -> torch.Tensor:
    """The sm90 kernel's tile classes at its (kq, kk) tile, copied to
    ``device`` once per shape."""
    return tile_classes(T, S, causal=causal, window=window, prefix=prefix, bq=bq, bk=bk,
                        kq=kq, kk=kk).to(device)


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


def kernel_route(dtype: torch.dtype, hd: int) -> str:
    """The kernel that :func:`flash_attention` launches for CUDA tensors of
    this dtype and head width (its name in ``kernels.launch_counts()``)."""
    return ("flash_attention_sm90" if dtype == torch.bfloat16 and hd in SM90_HEAD_DIMS
            else "flash_attention")


def _checked(q, k, v, bq, bk, window, dtypes, head_dims, what) -> tuple[int, int]:
    """The tile contract and what a kernel takes; raises on anything else."""
    bq, bk = _tiles(q, k, v, bq, bk, window)
    devices = {q.device, k.device, v.device}
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda tensors on one device, "
                         f"not {sorted(map(str, devices))}")
    if q.dtype not in dtypes or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the {what} kernel takes q, k, v of one dtype among "
                        f"{[str(d) for d in dtypes]}, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[3] not in head_dims:
        raise ValueError(f"the {what} kernel takes head widths {head_dims}, got {q.shape[3]}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{what} needs contiguous q, k and v")
    if q.shape[0] > 65535 or q.shape[2] > 65535:
        raise ValueError(f"{what}'s grid takes at most 65535 sequences and heads")
    return bq, bk


def _args(q, k, v, out, causal, window, prefix, bq, bk) -> tuple:
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, T, S, H, KV, hd,
            hd**-0.5, int(causal), -1 if window is None else int(window), int(prefix), bq, bk,
            torch.cuda.current_stream(q.device).cuda_stream)


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
              window: Optional[int] = None, prefix: int = 0, bq: int = 128,
              bk: int = 128) -> torch.Tensor:
    """The CUDA-core kernel (``csrc/flash_attention.cu``): f32 or bf16,
    head widths 16, 32, 64, 128 and 256. The route of every call that the
    sm90 kernel does not take: f32 at every width, bf16 at 16 and 32."""
    bq, bk = _checked(q, k, v, bq, bk, window, _KERNEL_DTYPES, _KERNEL_HEAD_DIMS,
                      "flash_attention")
    fn = _build.load("flash_attention").repro_flash_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float] + \
        [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(q)
    a = _args(q, k, v, out, causal, window, prefix, bq, bk)
    _build.check(fn(*a[:4], _KERNEL_DTYPES[q.dtype], *a[4:]), "flash_attention")
    flash_fwd.launches += 1
    return out


def flash_sm90(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
               window: Optional[int] = None, prefix: int = 0, bq: int = 128,
               bk: int = 128) -> torch.Tensor:
    """The Hopper kernel (``csrc/flash_attention_sm90.cu``): bf16, head
    widths 64, 128 and 256, q, k and v 16-byte aligned (TMA's rule)."""
    bq, bk = _checked(q, k, v, bq, bk, window, (torch.bfloat16,), SM90_HEAD_DIMS,
                      "flash_attention_sm90")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention_sm90 needs 16-byte aligned q, k and v")
    classes = _classes_on(q.device, q.shape[1], k.shape[1], bool(causal), window, int(prefix),
                          bq, bk, *SM90_TILES[q.shape[3]])
    fn = _build.load("flash_attention_sm90").repro_flash_attention_sm90
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float] + \
        [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(q)
    a = _args(q, k, v, out, causal, window, prefix, bq, bk)
    _build.check(fn(*a[:4], classes.data_ptr(), *a[4:]), "flash_attention_sm90")
    flash_sm90.launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: Optional[int] = None, prefix: int = 0, bq: int = 128,
                    bk: int = 128) -> torch.Tensor:
    """Attention of q over k/v with the reference kernel's masks and tile
    skipping. Returns (B, T, H, hd) in q's dtype: the plain version for CPU
    tensors, else the kernel that :func:`kernel_route` names."""
    bq, bk = _tiles(q, k, v, bq, bk, window)
    kw = dict(causal=causal, window=window, prefix=prefix, bq=bq, bk=bk)
    if {q.device, k.device, v.device} == {torch.device("cpu")}:
        return flash_attention_plain(q, k, v, **kw)
    kernel = flash_sm90 if kernel_route(q.dtype, q.shape[3]) == "flash_attention_sm90" \
        else flash_fwd
    return kernel(q, k, v, **kw)


flash_fwd.launches = 0
flash_sm90.launches = 0
