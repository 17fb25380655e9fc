"""Trainer: wires model + data + optimizer + sync mode + checkpointing.

``Trainer(cfg, RunConfig(...), mesh=make_mesh(4)).train(batch=..., seq=...,
steps=...)`` trains on an emulated data axis of ``mesh.size`` ranks on one
device; ``mesh=make_mesh((2, 2), axis_names=('pod', 'data'))`` trains on
two pods of two, each explicit sync mode level by level as the reference
syncs on its ('pod', 'data') mesh (see :mod:`.train_step`). Parameters and optimizer state are held once. ``grad_allreduce``
takes one pass over the global batch (the reference's GSPMD step); every
other mode computes every rank's gradients on its shard of the global
batch, syncs them with the run's sync mode, and applies the update once
from row 0 of the synced gradients (see :mod:`.train_step`). Under
``compressed_allreduce`` the rows may differ: row 0 is rank 0's view, as
the reference's replicated output reads back rank 0's. A ``health`` report
with dead ranks replaces the sync mode with the mean over the survivors.

MoE and vision-prefix models train as dense ones do. A MoE model's loss
carries the router's aux loss, which reads the batch its pass sees: the
global batch under ``grad_allreduce``, each rank's shard in the other
modes (the reference's ``shard_map`` steps), as in the reference.
"""
from __future__ import annotations

import os
import time
from typing import Optional

from ..configs.base import ModelConfig, RunConfig
from ..core.tuner import Tuner
from ..data.pipeline import batches, make_source
from ..launch.mesh import make_mesh, refuse_model_axis, resolve_device
from ..models import Model
from ..optim.optimizers import get_optimizer
from ..optim.schedules import warmup_cosine
from . import checkpoint as ckpt_lib
from .train_step import (
    make_bcast_train_step,
    make_compressed_allreduce_train_step,
    make_degraded_psum_train_step,
    make_overlap_allreduce_train_step,
    make_train_step,
    make_tuned_allreduce_train_step,
    with_error_feedback,
)

__all__ = ["Trainer", "SYNC_MODES"]

SYNC_MODES = ("grad_allreduce", "param_bcast", "tuned_allreduce", "overlap_allreduce",
              "compressed_allreduce")


class Trainer:
    """``device`` defaults to the card and raises without one; pass
    ``device='cpu'`` for the plain PyTorch path. ``mesh`` (an emulated mesh
    on the same device) defaults to one rank. ``check_rows=True`` makes the
    ``comm`` sync modes report ``grad_rows_differ`` each step (see
    :mod:`.train_step`); ``grad_allreduce``'s mean leaves one copy, so it
    has no rows to compare. ``health`` (a
    :class:`~repro_torch.comm.faults.MeshHealth` over the data ranks) with
    dead ranks overrides ``sync_mode`` with
    :func:`~.train_step.make_degraded_psum_train_step`; a report of slow
    links only changes nothing in the step.

    A MoE config trains through the einsum dispatch, whatever its
    ``moe_dispatch``: the reference's trainer calls ``apply_lm`` without
    an ``axis_name``, so a ``moe_dispatch='alltoallv'`` config does not
    move its expert rows through ``palltoallv`` in training. The vision and
    audio frontends train as the text models do, on the stub embeddings of
    the port's ``batches``.

    ``mesh`` may be a ('data',) or a ('pod', 'data') mesh (a ``model`` axis
    of one rank allowed): the global batch splits over its ``mesh.size``
    ranks in row-major rank order. A ``model`` axis of more than one rank
    is refused (``ValueError``): the port has no tensor parallelism."""

    def __init__(self, cfg: ModelConfig, run: RunConfig, *, mesh=None,
                 data_path: Optional[str] = None, ckpt_dir: Optional[str] = None,
                 health=None, device="cuda", check_rows: bool = False):
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else make_mesh(1, device=self.device)
        if self.mesh.device != self.device:
            raise ValueError(f"mesh lies on {self.mesh.device}, trainer on {self.device}")
        refuse_model_axis(self.mesh, "the trainer")
        if run.sync_mode not in SYNC_MODES:
            raise ValueError(f"unknown sync_mode {run.sync_mode!r} (have {SYNC_MODES})")
        self.cfg = cfg
        self.run = run
        self.model = Model(cfg)
        self.optimizer = get_optimizer(run.optimizer, run.weight_decay)
        if run.sync_mode == "compressed_allreduce":
            # the residual rides in opt_state['ef'], one row per data rank,
            # so it checkpoints with the rest of the optimizer state
            self.optimizer = with_error_feedback(self.optimizer, self.mesh.size)
        self.lr_fn = warmup_cosine(run.learning_rate, run.warmup_steps, run.total_steps)
        self.source = make_source(cfg, path=data_path, seed=run.seed)
        self.ckpt_dir = ckpt_dir
        self.check_rows = check_rows
        self.health = health
        self._step_fn = self._build()

    def _build(self):
        args = (self.model, self.run, self.optimizer, self.lr_fn, self.mesh)
        if self.health is not None and self.health.dead_ranks:
            # the tuned schedules assume every rank is reachable: a dead-rank
            # report routes the sync to the survivors' mean until a replan
            print(f"trainer: mesh degraded (dead ranks {self.health.dead_ranks}); "
                  f"sync_mode {self.run.sync_mode!r} falls back to psum-over-survivors",
                  flush=True)
            return make_degraded_psum_train_step(*args, health=self.health)
        if self.run.sync_mode == "grad_allreduce":
            return make_train_step(*args)
        # measured decisions (Tuner.save format) when the run names a table
        tuner = Tuner.load(self.run.tuner_table) if self.run.tuner_table else None
        return {
            "param_bcast": make_bcast_train_step,
            "tuned_allreduce": make_tuned_allreduce_train_step,
            "overlap_allreduce": make_overlap_allreduce_train_step,
            "compressed_allreduce": make_compressed_allreduce_train_step,
        }[self.run.sync_mode](*args, tuner=tuner, check_rows=self.check_rows)

    def init_state(self, seed: Optional[int] = None):
        """Parameters from a ``torch.Generator`` seeded with ``seed`` (the
        run's by default) and the optimizer's initial state."""
        params = self.model.init(self.run.seed if seed is None else seed, device=self.device)
        return params, self.optimizer.init(params)

    def restore_or_init(self):
        """``(params, opt_state, step)`` from the latest checkpoint under
        ``ckpt_dir`` (parameters there, optimizer state in its ``opt``
        subdirectory), or a fresh state at step 0."""
        params, opt = self.init_state()
        if self.ckpt_dir:
            step = ckpt_lib.latest_step(self.ckpt_dir)
            if step is not None:
                params = ckpt_lib.restore_checkpoint(self.ckpt_dir, step, params)
                opt = ckpt_lib.restore_checkpoint(os.path.join(self.ckpt_dir, "opt"), step, opt)
                return params, opt, step
        return params, opt, 0

    def train(self, *, batch: int, seq: int, steps: int, log_every: int = 10,
              ckpt_every: int = 0):
        """Run ``steps`` steps of global batch ``batch`` x ``seq`` tokens.
        Returns ``(params, opt_state, history)``; ``history`` holds the
        logged steps' metrics and ``time_s``, the host seconds since the
        first step started, read after the step's metrics reached the host."""
        params, opt_state, start = self.restore_or_init()
        it = batches(self.source, self.cfg, batch=batch, seq=seq, start_step=start,
                     device=self.device)
        history = []
        t0 = time.time()
        for step in range(start, start + steps):
            params, opt_state, metrics = self._step_fn(params, opt_state, next(it))
            if log_every and (step % log_every == 0 or step == start + steps - 1):
                m = {k: float(v) for k, v in metrics.items()}
                dt = time.time() - t0
                history.append({"step": step, "time_s": dt, **m})
                print(f"step {step:6d} loss {m['loss']:.4f} nll {m['nll']:.4f} "
                      f"gnorm {m['grad_norm']:.2f} lr {m['lr']:.2e} ({dt:.1f}s)", flush=True)
            if ckpt_every and self.ckpt_dir and (step + 1) % ckpt_every == 0:
                ckpt_lib.save_checkpoint(self.ckpt_dir, step + 1, params)
                ckpt_lib.save_checkpoint(os.path.join(self.ckpt_dir, "opt"), step + 1, opt_state)
        return params, opt_state, history
