"""Training the hybrid family in the port against the reference, on the
CPU: hymba-1.5b-smoke (windowed attention beside Mamba heads in every
layer) in f32 on 4 emulated ranks from the reference's own npz
checkpoint, 3 steps of 8 x 16 tokens, losses within 1e-4 of the
reference's single-device ``Trainer``: the restored parameters bit-equal
to the reference's; ``grad_allreduce``, ``param_bcast``,
``tuned_allreduce`` and ``param_bcast`` with
``bcast_algo='ring_allreduce'``, the synced rows bit-equal in the
explicit modes."""
from __future__ import annotations

import pytest
import torch
from _torch_train_reference import assert_restores, reference, track  # noqa: F401

# one intra-op thread: the suite runs in several worker processes at once, and
# the spinning OpenMP threads of each would contend for the same cores
torch.set_num_threads(1)

ARCH = "hymba-1.5b-smoke"
MODES = {"grad_allreduce": ("grad_allreduce", {}), "param_bcast": ("param_bcast", {}),
         "tuned_allreduce": ("tuned_allreduce", {}),
         "param_bcast_ring": ("param_bcast", {"bcast_algo": "ring_allreduce"})}


def test_reference_checkpoint_restores_into_the_port(reference):
    ckpt, ref_params, _ = reference(ARCH)
    assert_restores(ARCH, ckpt, ref_params)


@pytest.mark.parametrize("mode", list(MODES))
def test_trainer_tracks_reference_full_batch_steps(reference, mode):
    ckpt, _, ref_losses = reference(ARCH)
    sync_mode, kw = MODES[mode]
    track(ARCH, ckpt, ref_losses, sync_mode, **kw)
