"""Deterministic data pipeline, the reference's ``data/pipeline.py``.

Sources are numpy, so the port draws exactly the reference's tokens:

  * SyntheticZipf — endless deterministic token stream (hash-of-step);
  * MemmapTokens  — packed int32 token file (one long array).

Both produce global ``{"tokens", "labels"}`` batches (labels = next token)
as int64 tensors on the requested device; a vision config's batches also
hold the stub patch ``embeds`` and an encoder-decoder's the stub frame
``embeds``, the reference's values bit for bit.
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

__all__ = ["SyntheticZipf", "MemmapTokens", "batches", "make_source"]


class SyntheticZipf:
    """Zipf-distributed tokens, deterministic in (seed, step)."""

    def __init__(self, vocab: int, seed: int = 0, alpha: float = 1.1):
        self.vocab = vocab
        self.seed = seed
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        w = ranks ** (-alpha)
        self.cdf = np.cumsum(w / w.sum())

    def batch(self, step: int, batch: int, seq: int) -> np.ndarray:
        rng = np.random.RandomState((self.seed * 1_000_003 + step) % (2**31))
        u = rng.rand(batch, seq + 1)
        return np.searchsorted(self.cdf, u).astype(np.int32)


class MemmapTokens:
    """Packed int32 token file; windows are deterministic in step."""

    def __init__(self, path: str, seed: int = 0):
        self.tokens = np.load(path, mmap_mode="r")
        if self.tokens.ndim != 1:
            raise ValueError(f"{path}: want one flat token array, got {self.tokens.shape}")
        self.seed = seed

    @property
    def vocab(self) -> int:
        return int(self.tokens.max()) + 1

    def batch(self, step: int, batch: int, seq: int) -> np.ndarray:
        n = len(self.tokens) - (seq + 1)
        rng = np.random.RandomState((self.seed * 9_176_923 + step) % (2**31))
        starts = rng.randint(0, max(n, 1), size=batch)
        return np.stack([np.asarray(self.tokens[s: s + seq + 1], np.int32) for s in starts])


def make_source(cfg, *, path: Optional[str] = None, seed: int = 0):
    if path:
        return MemmapTokens(path, seed)
    return SyntheticZipf(min(cfg.vocab_size, 32768), seed)


def batches(source, cfg, *, batch: int, seq: int, start_step: int = 0,
            device="cpu") -> Iterator[dict]:
    """Yield global batches of ``seq`` text tokens on ``device``; for a
    vision config also ``embeds`` (batch, prefix_len, d_model), for an
    encoder-decoder ``embeds`` (batch, frontend_len, d_model), in the
    config's dtype: standard normal draws seeded with the step, as the
    reference's stub frontends make them."""
    step = start_step
    while True:
        toks = torch.from_numpy(source.batch(step, batch, seq)).long()
        out = {"tokens": toks[:, :-1].to(device), "labels": toks[:, 1:].to(device)}
        n_embeds = (cfg.prefix_len if cfg.frontend == "vision"
                    else cfg.frontend_len if cfg.arch_type == "encdec" else None)
        if n_embeds is not None:
            rng = np.random.RandomState(step % (2**31))
            emb = rng.randn(batch, n_embeds, cfg.d_model).astype(np.float32)
            out["embeds"] = torch.from_numpy(emb).to(device=device, dtype=getattr(torch, cfg.dtype))
        yield out
        step += 1
