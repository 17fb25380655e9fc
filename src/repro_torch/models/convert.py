"""Carry the reference's parameters over to the port.

The reference draws parameters with ``jax.random``, which the port cannot
reproduce; tests hand its tree across as numpy arrays. bf16 and the f8
types arrive as ``ml_dtypes`` arrays that ``torch.from_numpy`` refuses, so
they cross as their raw bit patterns: ``.view(np.int16)`` (or ``np.uint8``)
-> ``torch.from_numpy`` -> ``.view(torch.bfloat16)`` (or the f8 type), bit
for bit.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core.tree import tree_map

__all__ = ["params_from_jax", "to_tensor"]


def to_tensor(a, device="cpu") -> torch.Tensor:
    """One numpy (or numpy-convertible) array as a tensor of the same dtype
    and bits, in memory of its own (the port updates buffers in place)."""
    a = np.array(a, order="C")  # a writable copy of its own
    raw = _RAW.get(a.dtype.name)
    if raw is None:
        t = torch.from_numpy(a)
    else:
        t = torch.from_numpy(a.view(raw[0])).view(raw[1])
    return t.to(device)


# ml_dtypes types by name: the integer view that carries their bits, the torch dtype
_RAW = {"bfloat16": (np.int16, torch.bfloat16),
        "float8_e5m2": (np.uint8, torch.float8_e5m2),
        "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


def params_from_jax(tree: Any, device="cpu") -> Any:
    """The same tree (dicts, lists, ``None``) with every array leaf a tensor
    of the same shape, dtype and bits, on ``device``."""
    return tree_map(lambda a: to_tensor(a, device), tree)
