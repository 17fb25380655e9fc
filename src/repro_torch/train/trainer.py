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

On a ('data', 'model') or ('pod', 'data', 'model') mesh with a model axis
of more than one rank, ``grad_allreduce`` trains in the reference's FSDP +
TP layout (:func:`.train_step.make_tp_train_step`): parameters and
optimizer state are held blocked, each leaf ``(mesh.size, *block)`` with
row ``r`` rank ``r``'s block under ``param_specs(shapes, mesh)``.
Checkpoints hold the full tree whatever the layout, as the reference's do,
so a checkpoint written on one mesh restores on any other; ``train``
returns the full tree. The explicit modes and the degraded step refuse a
model axis: they are pure data-parallel, the paper's setting.

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
from ..core.tree import tree_flatten, tree_unflatten
from ..core.tuner import Tuner
from ..data.pipeline import batches, make_source
from ..dist.sharding import assemble_leaves, cut_leaves
from ..dist.topology import tp_size
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
    tp_specs,
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
    ranks in row-major rank order. On a ``model`` axis of more than one
    rank ``grad_allreduce`` trains tensor-parallel, in the blocked layout
    (see the module); the other sync modes and a dead-rank ``health``
    raise ``ValueError``, and so does a family the tensor-parallel forward
    does not cover in training, the recurrent and hybrid ones (naming the
    ROADMAP item "Tensor-parallel remainder"). The MoE, vision-prefix and
    encoder-decoder families train there as the dense decoders do, the
    aux over the whole global batch."""

    def __init__(self, cfg: ModelConfig, run: RunConfig, *, mesh=None,
                 data_path: Optional[str] = None, ckpt_dir: Optional[str] = None,
                 health=None, device="cuda", check_rows: bool = False):
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else make_mesh(1, device=self.device)
        if self.mesh.device != self.device:
            raise ValueError(f"mesh lies on {self.mesh.device}, trainer on {self.device}")
        if run.sync_mode not in SYNC_MODES:
            raise ValueError(f"unknown sync_mode {run.sync_mode!r} (have {SYNC_MODES})")
        if run.sync_mode != "grad_allreduce":
            refuse_model_axis(self.mesh, f"sync_mode {run.sync_mode!r}")
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
        # the blocked layout's specs on a model axis, else None (one copy)
        self.specs = tp_specs(self.model, self.mesh) if tp_size(self.mesh) > 1 else None
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
        run's by default) and the optimizer's initial state, blocked on a
        model axis."""
        params = self.model.init(self.run.seed if seed is None else seed, device=self.device)
        params = self._blocked(params)
        return params, self.optimizer.init(params)

    def _blocked(self, tree):
        """A full parameter-shaped tree, which the caller gives up, in the
        layout the step holds: cut into blocks on a model axis (its
        containers emptied, so each full leaf is freed once cut), itself
        otherwise."""
        if self.specs is None:
            return tree
        leaves, treedef = tree_flatten(tree)
        _empty(tree)
        return tree_unflatten(treedef, cut_leaves(leaves, self.specs, self.mesh))

    def _full(self, tree, *, consume: bool = False):
        """The full tree of a parameter-shaped one the step holds. With
        ``consume`` the caller gives up ``tree``: its containers are
        emptied, so each blocked leaf is freed once its full value is
        made."""
        if self.specs is None:
            return tree
        leaves, treedef = tree_flatten(tree)
        if consume:
            _empty(tree)
        return tree_unflatten(treedef, assemble_leaves(leaves, self.specs, self.mesh))

    def _opt_map(self, fn, opt_state):
        """``fn`` on each parameter-shaped tree of the optimizer state
        (``m``, ``v``), the step counter left as it is."""
        return {k: v if k == "step" else fn(v) for k, v in opt_state.items()}

    def restore_or_init(self):
        """``(params, opt_state, step)`` from the latest checkpoint under
        ``ckpt_dir`` (parameters there, optimizer state in its ``opt``
        subdirectory; both full trees), or a fresh state at step 0; blocked
        on a model axis."""
        step = ckpt_lib.latest_step(self.ckpt_dir) if self.ckpt_dir else None
        if step is None:
            return (*self.init_state(), 0)
        if self.specs is None:
            params, opt = self.init_state()
        else:  # shapes only: the restored full tree is cut into blocks
            params = self.model.param_shapes()
            opt = self.optimizer.init(params)
        params = ckpt_lib.restore_checkpoint(self.ckpt_dir, step, params, device=self.device)
        opt = ckpt_lib.restore_checkpoint(os.path.join(self.ckpt_dir, "opt"), step, opt,
                                          device=self.device)
        return self._blocked(params), self._opt_map(self._blocked, opt), step

    def train(self, *, batch: int, seq: int, steps: int, log_every: int = 10,
              ckpt_every: int = 0):
        """Run ``steps`` steps of global batch ``batch`` x ``seq`` tokens.
        Returns ``(params, opt_state, history)``, the state as full trees;
        ``history`` holds the logged steps' metrics and ``time_s``, the host
        seconds since the first step started, read after the step's metrics
        reached the host."""
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
                ckpt_lib.save_checkpoint(self.ckpt_dir, step + 1, self._full(params))
                ckpt_lib.save_checkpoint(os.path.join(self.ckpt_dir, "opt"), step + 1,
                                         self._opt_map(self._full, opt_state))
        full = self._full(params, consume=True)
        return full, self._opt_map(lambda t: self._full(t, consume=True), opt_state), history


def _empty(tree) -> None:
    """Empty the dicts and lists of a tree, innermost first."""
    if isinstance(tree, (dict, list)):
        for v in list(tree.values() if isinstance(tree, dict) else tree):
            _empty(v)
        tree.clear()
