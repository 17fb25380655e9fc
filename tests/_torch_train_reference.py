"""The reference's single-device ``Trainer`` as the port's training
tests hold it: the f32 smoke config's initial state saved as the
reference's own npz checkpoint at step 0 (its QKV biases, which it inits
to zeros, redrawn from a numpy seed when the test module's ``BIAS_SEED``
names the config, so a port that dropped one would not agree), then
``STEPS`` full-batch steps from that checkpoint. The port's ``Trainer``
restores the same checkpoint on 4 emulated CPU ranks. A test module
imports the ``reference`` fixture from here; ``tests/test_torch_train.py``
holds minitron-8b-smoke through the same helpers."""
from __future__ import annotations

import dataclasses
import os

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.configs.base import RunConfig as JRunConfig
from repro.launch.mesh import make_local_mesh
from repro.train import checkpoint as jckpt
from repro.train.trainer import Trainer as JTrainer
from repro_torch.configs import RunConfig, get_config
from repro_torch.core.tree import tree_leaves
from repro_torch.launch.mesh import make_mesh
from repro_torch.train.trainer import Trainer

N, BATCH, SEQ, STEPS = 4, 8, 16, 3
RUN = dict(total_steps=STEPS, warmup_steps=0, learning_rate=1e-3, seed=7)
TOL = 1e-4  # per-step losses, port against reference


def f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def with_biases(tree, seed: int):
    """The tree with every ``bq``/``bk``/``bv`` leaf redrawn from a seeded
    normal (scale 0.5), in the leaf's dtype and shape."""
    rng = np.random.RandomState(seed)

    def draw(path, a):
        if getattr(path[-1], "key", None) in ("bq", "bk", "bv"):
            return (rng.randn(*a.shape) * 0.5).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(draw, tree)


def reference_run(arch: str, ckpt: str, bias_seed=None):
    """Save the reference's initial state under ``ckpt`` (biases redrawn
    with ``bias_seed`` when given), train ``STEPS`` steps from it. Returns
    the saved parameters (numpy leaves) and the per-step losses."""
    trainer = JTrainer(f32(jget_config(arch)), JRunConfig(**RUN), mesh=make_local_mesh(1),
                       ckpt_dir=ckpt)
    params, opt = trainer.init_state()
    params = jax.tree.map(np.asarray, jax.device_get(params))
    if bias_seed is not None:
        params = with_biases(params, bias_seed)
        assert any(getattr(p[-1], "key", None) == "bq"
                   for p, _ in jax.tree_util.tree_flatten_with_path(params)[0])
    jckpt.save_checkpoint(ckpt, 0, params)
    jckpt.save_checkpoint(os.path.join(ckpt, "opt"), 0, opt)
    _, _, hist = trainer.train(batch=BATCH, seq=SEQ, steps=STEPS, log_every=1)
    return jax.tree.leaves(params), [h["loss"] for h in hist]


def port_trainer(arch: str, sync_mode: str, ckpt=None, check_rows=False, **kw) -> Trainer:
    return Trainer(f32(get_config(arch)), RunConfig(sync_mode=sync_mode, **RUN, **kw),
                   mesh=make_mesh(N, device="cpu"), ckpt_dir=ckpt, device="cpu",
                   check_rows=check_rows)


def track(arch: str, ckpt: str, ref_losses, sync_mode: str, **kw) -> list:
    """The port's run from ``ckpt`` under ``sync_mode`` (the synced rows
    compared in the explicit modes): its losses within ``TOL`` of
    ``ref_losses``, ``grad_rows_differ`` 0 (and not reported under
    grad_allreduce). Returns the history."""
    check = sync_mode != "grad_allreduce"  # its mean leaves one copy
    _, _, hist = port_trainer(arch, sync_mode, ckpt, check_rows=check, **kw).train(
        batch=BATCH, seq=SEQ, steps=STEPS, log_every=1)
    losses = [h["loss"] for h in hist]
    assert len(losses) == STEPS
    assert max(abs(a - b) for a, b in zip(losses, ref_losses)) <= TOL, (losses, ref_losses)
    if check:
        assert all(h["grad_rows_differ"] == 0 for h in hist), hist
    else:
        assert all("grad_rows_differ" not in h for h in hist), hist
    return hist


@pytest.fixture(scope="module")
def reference(tmp_path_factory, request):
    """Each config's reference run, made on first use in the module:
    (checkpoint directory, saved parameters, losses)."""
    seeds = getattr(request.module, "BIAS_SEED", {})
    runs = {}

    def get(arch):
        if arch not in runs:
            ckpt = str(tmp_path_factory.mktemp(arch))
            runs[arch] = (ckpt, *reference_run(arch, ckpt, bias_seed=seeds.get(arch)))
        return runs[arch]

    return get


def assert_restores(arch: str, ckpt: str, ref_params) -> None:
    """The port's ``Trainer`` restores the reference's checkpoint at step
    0, every parameter bit-equal to the reference's."""
    params, opt, step = port_trainer(arch, "tuned_allreduce", ckpt).restore_or_init()
    assert step == 0 and int(opt["step"]) == 0
    leaves = tree_leaves(params)
    assert len(leaves) == len(ref_params)
    for a, b in zip(ref_params, leaves):
        np.testing.assert_array_equal(b.numpy(), a)
