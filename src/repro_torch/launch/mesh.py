"""The emulated data axis: ``n`` ranks on one device.

NCCL refuses two ranks on one GPU, so the port emulates a data-parallel
mesh the way the reference's CPU tests emulate devices. A value "on the
mesh" carries the rank as a leading dimension: a leaf ``(n, *shape)`` whose
row ``r`` is what rank ``r`` holds. A transfer between ranks is then a copy
between two rows of one device's memory (HBM to HBM), not an NVLink or
InfiniBand hop; the executors (:mod:`repro_torch.comm.executors`) make
those copies row by row.

:class:`EmulatedMesh` exposes ``axis_names`` and ``devices.shape`` like a
``jax.sharding.Mesh``, so :mod:`repro_torch.dist.topology` reads it
unchanged.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..dist.topology import DP_AXES, dp_axes

__all__ = ["EmulatedMesh", "make_mesh", "resolve_device", "dp_axes"]


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, raising when CUDA is asked for and absent —
    the port never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the port's "
                "plain PyTorch path on the CPU"
            )
        if dev.index is None:  # name the card, so it compares equal to a tensor's
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class EmulatedMesh:
    """``n`` data ranks emulated on one ``device``."""

    n: int
    device: torch.device
    axis_names: tuple = (DP_AXES[-1],)

    @property
    def devices(self) -> np.ndarray:
        # one entry per rank, all naming the same physical device
        return np.full((self.n,), str(self.device), dtype=object)

    @property
    def size(self) -> int:
        return self.n


def make_mesh(n: int, *, device="cuda") -> EmulatedMesh:
    """A one-axis ('data') mesh of ``n`` ranks on ``device``."""
    if n < 1:
        raise ValueError(f"mesh needs at least one rank, got {n}")
    return EmulatedMesh(int(n), resolve_device(device))
