"""Deterministic data pipeline, the reference's ``data/pipeline.py``.

Sources are numpy, so the port draws exactly the reference's tokens:

  * SyntheticZipf — endless deterministic token stream (hash-of-step);
  * MemmapTokens  — packed int32 token file (one long array).

Both produce global ``{"tokens", "labels"}`` batches (labels = next token)
as int64 tensors on the requested device. The multimodal stub embeddings
wait for the model families that read them (ROADMAP A.11).
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
    """Yield global batches of ``seq`` text tokens on ``device``."""
    if cfg.frontend is not None or cfg.arch_type != "decoder":
        raise NotImplementedError(f"{cfg.name}: frontend stub embeddings are ROADMAP A.11")
    step = start_step
    while True:
        toks = torch.from_numpy(source.batch(step, batch, seq)).long()
        yield {"tokens": toks[:, :-1].to(device), "labels": toks[:, 1:].to(device)}
        step += 1
