"""Training the encoder-decoder and MHA families in the port against the
reference, on the CPU: whisper-large-v3-smoke (16 stub frames through the
encoder, cross attention in every decoder layer) and qwen1.5-32b-smoke
(MHA, QKV biases) in f32 on 4 emulated ranks, each from the reference's
own npz checkpoint with every QKV bias redrawn nonzero from a numpy seed
(the reference inits them to zeros), 3 steps of 8 x 16 tokens, losses
within 1e-4 of the reference's single-device ``Trainer``:

* the restored parameters bit-equal to the reference's;
* ``grad_allreduce``, ``param_bcast`` and ``tuned_allreduce``, the synced
  rows bit-equal in the explicit modes;
* whisper's stub frames split over the ranks with its tokens: with 8
  sequences on 4 ranks, rank r trains on sequences 2r and 2r + 1 of both
  the reference's ``tokens`` and ``embeds``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
from _torch_train_reference import (  # noqa: F401
    BATCH,
    N,
    SEQ,
    assert_restores,
    f32,
    port_trainer,
    reference,
    track,
)

from repro.configs import get_config as jget_config
from repro.data.pipeline import batches as jbatches
from repro.data.pipeline import make_source as jmake_source

# one intra-op thread: the suite runs in several worker processes at once, and
# the spinning OpenMP threads of each would contend for the same cores
torch.set_num_threads(1)

ARCHS = ("whisper-large-v3-smoke", "qwen1.5-32b-smoke")
MODES = ("grad_allreduce", "param_bcast", "tuned_allreduce")
BIAS_SEED = {"whisper-large-v3-smoke": 11, "qwen1.5-32b-smoke": 12}


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_checkpoint_restores_into_the_port(reference, arch):
    ckpt, ref_params, _ = reference(arch)
    assert_restores(arch, ckpt, ref_params)
    assert sum(1 for a in ref_params if a.ndim == 1 and a.any()) > 0


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_tracks_reference_full_batch_steps(reference, arch, mode):
    ckpt, _, ref_losses = reference(arch)
    track(arch, ckpt, ref_losses, mode)


def test_stub_frames_split_over_ranks_with_their_tokens(reference):
    """One ``tuned_allreduce`` step: every rank's pass sees sequences 2r
    and 2r + 1 of the reference's global batch, tokens and frames alike."""
    arch = "whisper-large-v3-smoke"
    ckpt, _, _ = reference(arch)
    tr = port_trainer(arch, "tuned_allreduce", ckpt)
    seen = []
    loss = tr.model.loss

    def spy(params, batch, **kw):
        seen.append({k: v.detach().numpy().copy() for k, v in batch.items()})
        return loss(params, batch, **kw)

    tr.model.loss = spy
    tr.train(batch=BATCH, seq=SEQ, steps=1, log_every=1)
    jcfg = f32(jget_config(arch))
    want = {k: np.asarray(v) for k, v in next(jbatches(jmake_source(jcfg, seed=tr.run.seed), jcfg,
                                                        batch=BATCH, seq=SEQ)).items()}
    assert set(want) == {"tokens", "labels", "embeds"} and want["embeds"].shape[1] == 16
    assert len(seen) == N, len(seen)
    per = BATCH // N
    for r, got in enumerate(seen):
        for key in ("tokens", "labels", "embeds"):
            np.testing.assert_array_equal(got[key], want[key][r * per:(r + 1) * per], err_msg=key)
    # the frames differ between sequences, so a split apart from the tokens shows
    assert all(not np.array_equal(want["embeds"][i], want["embeds"][i + 1])
               for i in range(BATCH - 1))
