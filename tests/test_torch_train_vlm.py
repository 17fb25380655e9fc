"""Training PaliGemma (a vision-prefix decoder) in the port against the
reference, on the CPU.

* paligemma-3b-smoke in f32 (16 stub patches + 16 text tokens) on 4
  emulated ranks: ``tuned_allreduce`` and ``grad_allreduce`` against the
  reference's single-device ``Trainer`` from the same initial state (its
  own npz checkpoint), 3 steps, losses within 1e-4. Each rank's shard of
  ``batch['embeds']`` is split as its tokens are.
* One loss and gradient at 4096 positions (the 16-patch prefix + 4080
  text tokens, one sequence): training attention at 4096 keys leaves the
  dense softmax for the differentiable block loop (``_chunked_sdpa``, the
  flash kernels have no backward), here with the prefix-LM mask, against
  ``jax.value_and_grad`` of the reference's ``Model.loss``, which takes its
  own block loop.
"""
from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import RunConfig as JRunConfig
from repro.launch.mesh import make_local_mesh
from repro.models import Model as JModel
from repro.models import layers as jl
from repro.train import checkpoint as jckpt
from repro.train.trainer import Trainer as JTrainer
from repro_torch.configs import RunConfig, get_config
from repro_torch.core.tree import tree_flatten, tree_unflatten
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import Model
from repro_torch.models import layers as tl
from repro_torch.models.convert import params_from_jax
from repro_torch.train.trainer import Trainer

# one intra-op thread: the suite runs in several worker processes at once, and
# the spinning OpenMP threads of each would contend for the same cores
torch.set_num_threads(1)

ARCH = "paligemma-3b-smoke"
N, BATCH, SEQ, STEPS = 4, 8, 16, 3
RUN = dict(total_steps=STEPS, warmup_steps=0, learning_rate=1e-3, seed=7)
LONG = 4096  # positions: prefix + text


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("vlm_ckpt"))
    trainer = JTrainer(_f32(jget_config(ARCH)), JRunConfig(**RUN), mesh=make_local_mesh(1),
                       ckpt_dir=ckpt)
    params, opt = trainer.init_state()
    jckpt.save_checkpoint(ckpt, 0, params)
    jckpt.save_checkpoint(os.path.join(ckpt, "opt"), 0, opt)
    _, _, hist = trainer.train(batch=BATCH, seq=SEQ, steps=STEPS, log_every=1)
    return ckpt, [h["loss"] for h in hist]


@pytest.mark.parametrize("sync_mode", ["tuned_allreduce", "grad_allreduce"])
def test_trainer_tracks_reference_full_batch_steps(reference_run, sync_mode):
    ckpt, ref = reference_run
    cfg = _f32(get_config(ARCH))
    assert cfg.frontend == "vision" and cfg.prefix_len == 16
    tr = Trainer(cfg, RunConfig(sync_mode=sync_mode, **RUN), mesh=make_mesh(N, device="cpu"),
                 ckpt_dir=ckpt, device="cpu", check_rows=sync_mode != "grad_allreduce")
    _, _, hist = tr.train(batch=BATCH, seq=SEQ, steps=STEPS, log_every=1)
    losses = [h["loss"] for h in hist]
    assert len(losses) == STEPS
    assert max(abs(a - b) for a, b in zip(losses, ref)) <= 1e-4, (losses, ref)
    assert all(h.get("grad_rows_differ", 0) == 0 for h in hist)


def test_chunked_sdpa_gradient_with_a_prefix_matches_reference(monkeypatch):
    """Loss within 1e-5 and every gradient leaf within 1e-5 of the global
    gradient norm, as tests/test_torch_train.py holds the dense model's,
    with remat (the trainer's default) in both packages."""
    jcfg, tcfg = _f32(jget_config(ARCH)), _f32(get_config(ARCH))
    P = jcfg.prefix_len
    T = LONG - P
    assert LONG >= jl.CHUNKED_ATTN_MIN_S and LONG >= tl.CHUNKED_ATTN_MIN_S
    jm, tm = JModel(jcfg), Model(tcfg)
    jp = jm.init(jax.random.PRNGKey(4))
    rng = np.random.RandomState(4)
    toks = rng.randint(0, jcfg.vocab_size, size=(1, T + 1))
    emb = rng.randn(1, P, jcfg.d_model).astype(np.float32)
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:]),
          "embeds": jnp.asarray(emb)}
    vg = jax.jit(jax.value_and_grad(lambda p: jm.loss(p, jb, remat=True), has_aux=True))
    (jloss, _), jg = vg(jp)
    ref = [np.asarray(a) for a in jax.tree.leaves(jg)]
    del jg
    leaves, treedef = tree_flatten(params_from_jax(jax.device_get(jp)))
    ps = [p.requires_grad_(True) for p in leaves]
    tb = {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:]),
          "embeds": torch.from_numpy(emb)}
    calls = []
    chunked = tl._chunked_sdpa

    def spy(q, k, v, spec, prefix_len, *a, **kw):
        calls.append((k.shape[1], prefix_len))
        return chunked(q, k, v, spec, prefix_len, *a, **kw)

    monkeypatch.setattr(tl, "_chunked_sdpa", spy)
    loss, _ = tm.loss(tree_unflatten(treedef, ps), tb, remat=True)
    grads = torch.autograd.grad(loss, ps)
    loss = float(loss.detach())
    # every layer, in the forward and in its recompute, took the block loop
    assert calls == [(LONG, P)] * (2 * tcfg.num_layers), calls
    assert abs(loss - float(jloss)) <= 1e-5, (loss, float(jloss))
    norm = np.sqrt(sum(float((a.astype(np.float64) ** 2).sum()) for a in ref))
    err = max(float(np.abs(a - g.numpy()).max()) for a, g in zip(ref, grads))
    assert err <= 1e-5 * norm, (err, norm)
