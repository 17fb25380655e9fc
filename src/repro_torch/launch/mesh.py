"""Emulated meshes: every rank of a ``('data',)``, ``('pod', 'data')`` or
``('pod', 'data', 'model')`` mesh on one device.

NCCL refuses two ranks on one GPU, so the port emulates a mesh the way the
reference's CPU tests emulate devices. A value "on the mesh" carries the
rank as one flat leading dimension of ``mesh.size`` rows: a leaf
``(size, *shape)`` whose row ``r`` is what rank ``r`` holds. Ranks are
numbered row-major over ``axis_names`` (pod-major), the order in which jax
lays out a mesh's devices and in which ``P(('pod', 'data'))`` splits a
batch. A transfer between ranks is then a copy between two rows of one
device's memory (HBM to HBM), not an NVLink or InfiniBand hop, whichever
level of the hierarchy it crosses; the executors
(:mod:`repro_torch.comm.executors`) make those copies row by row, and
:func:`repro_torch.comm.api.level_replay` runs one level's collective on
each group of ranks along one axis.

:class:`EmulatedMesh` exposes ``axis_names`` and ``devices.shape`` like a
``jax.sharding.Mesh``, so :mod:`repro_torch.dist.topology` reads it
unchanged.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..dist.topology import DP_AXES, TP_AXIS, dp_axes, tp_size

__all__ = ["EmulatedMesh", "make_mesh", "make_local_mesh", "make_production_mesh",
           "refuse_model_axis", "resolve_device", "dp_axes"]

# the axis names a mesh takes, by number of axes, when none are given
_DEFAULT_NAMES = {1: (DP_AXES[-1],), 2: DP_AXES, 3: DP_AXES + (TP_AXIS,)}


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
    """A mesh of ``shape`` ranks over ``axis_names``, emulated on one
    ``device``."""

    shape: tuple
    device: torch.device
    axis_names: tuple = (DP_AXES[-1],)

    def __post_init__(self) -> None:
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} does not fit axes {self.axis_names}")
        if not self.shape or any(int(s) < 1 for s in self.shape):
            raise ValueError(f"mesh needs at least one rank on every axis, got {self.shape}")
        known = DP_AXES + (TP_AXIS,)
        if len(set(self.axis_names)) != len(self.axis_names) \
                or any(a not in known for a in self.axis_names):
            raise ValueError(f"mesh axes {self.axis_names}: each one of {known}, once")

    @property
    def devices(self) -> np.ndarray:
        # one entry per rank, all naming the same physical device
        return np.full(tuple(self.shape), str(self.device), dtype=object)

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def refuse_model_axis(mesh, what: str) -> None:
    """``what`` (an explicit sync mode, the degraded step) is pure
    data-parallel, the paper's setting, as the reference asserts: it
    refuses a ``model`` axis of more than one rank. A model axis of one
    rank is a data-parallel mesh; on a larger one ``grad_allreduce`` trains
    (the FSDP + tensor-parallel step) and the engine serves."""
    if tp_size(mesh) != 1:
        raise ValueError(
            f"{what} is pure data-parallel (the paper's setting): the model axis of "
            f"{tuple(mesh.axis_names)} {tuple(mesh.devices.shape)} has {tp_size(mesh)} ranks; "
            "on a model axis, train with sync_mode='grad_allreduce'")


def make_mesh(shape, *, axis_names=None, device="cuda") -> EmulatedMesh:
    """A mesh on ``device``: ``make_mesh(4)`` is a one-axis ('data',) mesh of
    4 ranks, ``make_mesh((2, 4), axis_names=('pod', 'data'))`` two pods of 4.
    ``axis_names`` defaults to ('data',), ('pod', 'data') or ('pod', 'data',
    'model') by the number of axes."""
    shape = (int(shape),) if isinstance(shape, (int, np.integer)) else tuple(int(s) for s in shape)
    if axis_names is None:
        if len(shape) not in _DEFAULT_NAMES:
            raise ValueError(f"name the axes of a {len(shape)}-axis mesh")
        axis_names = _DEFAULT_NAMES[len(shape)]
    return EmulatedMesh(shape, resolve_device(device), tuple(axis_names))


def make_local_mesh(model_parallel: int = 1, *, n: int, device="cuda") -> EmulatedMesh:
    """The reference's local mesh, ``(n // model_parallel, model_parallel)``
    over ('data', 'model'), on ``n`` emulated ranks (the reference takes
    ``n`` from the devices that exist)."""
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"{n} ranks do not divide into model_parallel={model_parallel}")
    return make_mesh((n // model_parallel, model_parallel), axis_names=(DP_AXES[-1], TP_AXIS),
                     device=device)


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> EmulatedMesh:
    """The reference's production mesh: 16 x 16 over ('data', 'model'), or
    2 x 16 x 16 over ('pod', 'data', 'model') with ``multi_pod``. For
    host-side planning (``plan_distribution``, ``dist.topology``): a value
    stacked over its 256 or 512 ranks is not meant for one card."""
    if multi_pod:
        return make_mesh((2, 16, 16), axis_names=DP_AXES + (TP_AXIS,), device=device)
    return make_mesh((16, 16), axis_names=(DP_AXES[-1], TP_AXIS), device=device)
