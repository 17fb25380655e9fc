"""Carry the reference's parameters over to the port.

The reference draws parameters with ``jax.random``, which the port cannot
reproduce; tests hand its tree across as numpy arrays. bf16 arrives as an
``ml_dtypes`` array that ``torch.from_numpy`` refuses, so it crosses as
its raw 16-bit pattern: ``.view(np.int16)`` -> ``torch.from_numpy`` ->
``.view(torch.bfloat16)``, bit for bit.
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
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_jax(tree: Any, device="cpu") -> Any:
    """The same tree (dicts, lists, ``None``) with every array leaf a tensor
    of the same shape, dtype and bits, on ``device``."""
    return tree_map(lambda a: to_tensor(a, device), tree)
