"""Fused parameter updates (CUDA), with their plain PyTorch versions.

``mix`` is model averaging, ``(1 - a) * w + a * u``; ``scaled_add`` the
gradient step, ``w - a * u``; both over flat buffers, computed in f32 and
cast to ``w``'s dtype. Replaces the reference's Pallas ``mix`` /
``scaled_add`` (``src/repro/kernels/param_update.py:67,73``); the kernels
and their design note are in ``csrc/param_update.cu``. As in the
reference, no training step calls them yet.

``a`` is rounded to f32 first and ``1 - a`` is taken in f32, as the
reference's kernel takes them from its f32 scalar operand. A CPU tensor
takes the plain version; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

__all__ = ["mix", "scaled_add", "mix_plain", "scaled_add_plain"]

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MIX, _SCALED_ADD = 0, 1


def _scalars(a) -> tuple[float, float]:
    """(a, 1 - a) as the reference's kernel has them: f32, subtracted in f32."""
    a32 = np.float32(a)
    return float(a32), float(np.float32(1.0) - a32)


def _check(w: torch.Tensor, u: torch.Tensor) -> None:
    if w.dim() != 1 or w.shape != u.shape:
        raise ValueError(f"param updates take flat buffers of one length, got "
                         f"{tuple(w.shape)} and {tuple(u.shape)}")


def mix_plain(w: torch.Tensor, u: torch.Tensor, a) -> torch.Tensor:
    """The plain version of :func:`mix`."""
    _check(w, u)
    a32, om = _scalars(a)
    a_t = torch.tensor(a32, dtype=torch.float32, device=w.device)
    om_t = torch.tensor(om, dtype=torch.float32, device=w.device)
    return (om_t * w.float() + a_t * u.float()).to(w.dtype)


def scaled_add_plain(w: torch.Tensor, u: torch.Tensor, a) -> torch.Tensor:
    """The plain version of :func:`scaled_add`."""
    _check(w, u)
    a_t = torch.tensor(_scalars(a)[0], dtype=torch.float32, device=w.device)
    return (w.float() - a_t * u.float()).to(w.dtype)


def _run(op: int, w: torch.Tensor, u: torch.Tensor, a) -> torch.Tensor:
    if w.device.type != "cuda" or u.device != w.device:
        raise ValueError(f"param updates run on cuda or cpu tensors on one device, "
                         f"not {w.device} and {u.device}")
    if w.dtype not in _KERNEL_DTYPES or u.dtype != w.dtype:
        raise TypeError(f"the param update kernels take float32 or bfloat16 buffers of one "
                        f"dtype, got {w.dtype} and {u.dtype}")
    if not (w.is_contiguous() and u.is_contiguous()):
        raise ValueError("param updates need contiguous buffers")
    out = torch.empty_like(w)
    lib = _build.load("param_update")
    fn = lib.repro_param_update
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                            ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    a32, om = _scalars(a)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    _build.check(fn(out.data_ptr(), w.data_ptr(), u.data_ptr(), w.numel(), op,
                    _KERNEL_DTYPES[w.dtype], a32, om, stream),
                 "mix" if op == _MIX else "scaled_add")
    return out


def mix(w: torch.Tensor, u: torch.Tensor, a) -> torch.Tensor:
    """Model averaging over flat buffers: ``(1 - a) * w + a * u``."""
    _check(w, u)
    if w.device.type == "cpu" and u.device.type == "cpu":
        return mix_plain(w, u, a)
    out = _run(_MIX, w, u, a)
    if w.numel():
        mix.launches += 1
    return out


def scaled_add(w: torch.Tensor, u: torch.Tensor, a) -> torch.Tensor:
    """Gradient step over flat buffers: ``w - a * u``."""
    _check(w, u)
    if w.device.type == "cpu" and u.device.type == "cpu":
        return scaled_add_plain(w, u, a)
    out = _run(_SCALED_ADD, w, u, a)
    if w.numel():
        scaled_add.launches += 1
    return out


mix.launches = 0
scaled_add.launches = 0
