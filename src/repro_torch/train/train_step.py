"""Train-step factories on an emulated mesh: a ('data',) or a ('pod',
'data') mesh (a model axis of one rank allowed), and for ``grad_allreduce``
also a ('data', 'model') or ('pod', 'data', 'model') mesh.

Five data-parallel synchronization modes, as in the reference's
``train/train_step.py``:

* ``grad_allreduce`` (:func:`make_train_step`) — the baseline: one pass
  over the global batch (the reference's GSPMD step, where the compiler
  inserts the all-reduce).
* ``param_bcast`` (:func:`make_bcast_train_step`) — the paper's CA-CNTK
  pattern: per-leaf reduce to the root over the reversed binomial tree,
  then the tuned bucketed broadcast (``core.bcast.pbcast_tree``); with
  ``bcast_algo='ring_allreduce'``, the explicit ring allreduce of
  ``core.algorithms`` per leaf instead.
* ``tuned_allreduce`` (:func:`make_tuned_allreduce_train_step`) — bucketed
  allreduce through the ``comm`` plan layer, per-bucket tuned algorithm.
* ``overlap_allreduce`` (:func:`make_overlap_allreduce_train_step`) — the
  same plans streamed through the overlap engine, optionally with a second
  stream that broadcasts the updated parameters.
* ``compressed_allreduce`` (:func:`make_compressed_allreduce_train_step`)
  — the same plans over a compressed wire, with error feedback.

On a mesh with dead ranks the trainer replaces any of them with
:func:`make_degraded_psum_train_step`, the mean over the surviving ranks.
The explicit modes and the degraded step are pure data-parallel, the
paper's setting, and refuse a model axis of more than one rank, as the
reference asserts. On a model axis ``grad_allreduce`` is the reference's
FSDP + tensor-parallel step (:func:`make_train_step`).

How ranks are emulated. In every mode but ``grad_allreduce`` the
reference's ``local_step`` runs once per rank inside ``shard_map``. Here
rank ``r`` computes its loss and gradients on its shard
``torch.tensor_split(batch, n)[r]``, one rank after another, and the
gradients fill rank-stacked ``(n, *shape)`` leaves that go through the
same bucketing, plans and executors as the reference's step. On a
('pod', 'data') mesh rank ``r`` is the row-major position over the two
axes (the reference's ``P(('pod', 'data'))`` batch split) and every
explicit mode syncs level by level in the reference's order, each level on
every group of ranks along its axis (``comm.api.level_replay``); the
degraded step and ``grad_allreduce`` take one pass over the ``n_dp``
ranks, as one mean does not depend on the levels. Parameters and
optimizer state are held ONCE: the reference's update is deterministic and
identical on every rank, so the port applies it once, from row 0 of the
synced gradients. With ``check_rows=True`` the ``comm`` modes' steps also
report ``grad_rows_differ``, the elements of rows 1..n-1 of the synced
gradients whose bits differ from row 0's: zero for the bf16-wire modes,
where every rank would apply the same update. The check makes n-1 more
passes over the synced gradients, so it is off unless asked for. Under a
compressed wire the rows legitimately differ (the owner of a chunk keeps
full precision, every other rank gets a dequantized copy); row 0 is rank
0's view, which is also what ``jax.device_get`` returns for the
reference's replicated output.

Steps update ``params`` and ``opt_state`` in place and return them with the
step's metrics ``(params, opt_state, out)``.
"""
from __future__ import annotations

import functools
import math
from typing import Callable

import numpy as np
import torch

from ..comm import (
    hierarchical_allreduce_axes,
    level_replay,
    overlap_allreduce_tree,
    pallgather,
    pallreduce,
    pallreduce_tree,
)
from ..comm.compress import CompressionState, normalize_wire_format
from ..comm.streams import StreamSpec, execute_stream_entry, plan_streams
from ..configs.base import RunConfig
from ..core import bucketing
from ..core.algorithms import ring_allreduce
from ..core.bcast import pbcast_tree, preduce_sum
from ..core.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from ..core.tuner import Tuner
from ..dist import topology
from ..dist.sharding import (
    drop_axis,
    is_spec,
    owner_ranks,
    param_specs,
    shard_slices,
    spec_axes,
)
from ..launch.mesh import dp_axes, refuse_model_axis
from ..models.tensor_parallel import check_tensor_parallel, tp_loss
from ..optim.optimizers import Optimizer, clip_by_global_norm

__all__ = [
    "make_train_step",
    "make_tp_train_step",
    "make_bcast_train_step",
    "make_tuned_allreduce_train_step",
    "make_overlap_allreduce_train_step",
    "make_compressed_allreduce_train_step",
    "make_degraded_psum_train_step",
    "with_error_feedback",
]


def _microbatches(batch: dict, k: int) -> list[dict]:
    parts = {key: torch.chunk(v, k) for key, v in batch.items()}
    return [{key: parts[key][i] for key in parts} for i in range(k)]


def _grad_fn(model, run_cfg: RunConfig):
    """``compute(params, batch) -> (loss, metrics, grads)``: ``grads`` is
    the list of gradient leaves in flatten order, from
    ``torch.autograd.grad`` over the parameter leaves (the functional form
    of ``jax.value_and_grad``). With microbatches, the f32 mean of each
    microbatch's gradients, as the reference accumulates them."""
    def one(params, mb):
        leaves, treedef = tree_flatten(params)
        ps = [p.detach().requires_grad_(True) for p in leaves]
        loss, metrics = model.loss(tree_unflatten(treedef, ps), mb, remat=run_cfg.remat)
        grads = torch.autograd.grad(loss, ps)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, list(grads)

    return _over_microbatches(one, run_cfg.num_microbatches)


def _over_microbatches(one, k: int):
    """``compute(state, batch)``: ``one(state, batch) -> (loss, metrics,
    grads)`` over the batch, or with ``k`` microbatches their mean loss and
    metrics and the f32 mean of their gradients."""
    def compute(state, batch):
        if k == 1:
            return one(state, batch)
        acc, losses, metricss = None, [], []
        for mb in _microbatches(batch, k):
            loss, metrics, grads = one(state, mb)
            if acc is None:
                acc = [torch.zeros(g.shape, dtype=torch.float32, device=g.device) for g in grads]
            for a, g in zip(acc, grads):
                a.add_(g.float() / k)
            del grads
            losses.append(loss)
            metricss.append(metrics)
        return _mean(losses), {key: _mean([m[key] for m in metricss]) for key in metricss[0]}, acc

    return compute


def _mean(values: list) -> torch.Tensor:
    return torch.stack(values).mean()


def _per_rank(compute, params, batch: dict, n: int, write, ranks=None) -> tuple:
    """Rank by rank over ``ranks`` (every rank of ``n`` by default): loss,
    metrics and gradients on the rank's shard of the batch;
    ``write(i, grads)`` stores the gradient leaves of the ``i``-th rank
    computed (rank ``i`` by default). Returns the mean loss and metrics
    over those ranks (every rank: the reference's ``pmean``)."""
    b = next(iter(batch.values())).shape[0]
    if b % n:
        raise ValueError(f"global batch {b} does not divide over {n} data ranks")
    parts = {key: torch.tensor_split(v, n) for key, v in batch.items()}
    losses, metricss = [], []
    for i, r in enumerate(range(n) if ranks is None else ranks):
        loss, metrics, grads = compute(params, {key: parts[key][r] for key in parts})
        write(i, grads)
        del grads
        losses.append(loss)
        metricss.append(metrics)
    return _mean(losses), {key: _mean([m[key] for m in metricss]) for key in metricss[0]}


def _stacked_writer(n: int):
    """Rank-stacked gradient leaves ``(n, *shape)`` and the writer that
    fills row ``r``."""
    stacked: list[torch.Tensor] = []

    def write(r: int, grads) -> None:
        if not stacked:
            stacked.extend(torch.empty((n,) + tuple(g.shape), dtype=g.dtype, device=g.device)
                           for g in grads)
        for s, g in zip(stacked, grads):
            s[r].copy_(g)

    return stacked, write


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def _tree_rows_differ(tree, check_rows: bool):
    """``_rows_differ`` summed over the leaves of a synced tree, or None
    when the check is off."""
    return sum(_rows_differ(t) for t in tree_leaves(tree)) if check_rows else None


def _rows_differ(stacked: torch.Tensor) -> torch.Tensor:
    """Elements of rows 1..n-1 whose bits differ from row 0's."""
    bits = _bits(stacked)
    out = torch.zeros((), dtype=torch.int64, device=stacked.device)
    for r in range(1, stacked.shape[0]):
        out += (bits[r] != bits[0]).sum()
    return out


def _finish(grads, params, opt_state, optimizer: Optimizer, lr_fn, loss, metrics,
            rows_differ=None):
    """Clip, step the optimizer once (in place), and report."""
    grads, gnorm = clip_by_global_norm(grads, 1.0)
    lr = lr_fn(opt_state["step"])
    params, opt_state = optimizer.update(grads, opt_state, params, lr)
    out = {"loss": loss, "grad_norm": gnorm, "lr": lr}
    if rows_differ is not None:
        out["grad_rows_differ"] = rows_differ
    out.update(metrics)
    return params, opt_state, out


def _data_ranks(mesh, mode: str) -> int:
    """The data-parallel ranks ``n_dp`` of a ('data',) or ('pod', 'data')
    mesh (a model axis of one rank allowed): the rank rows of the stacked
    gradients, rank ``r`` the row-major position over the data axes."""
    if not dp_axes(mesh):
        raise ValueError(f"{mode} needs a data axis, not {tuple(mesh.axis_names)}")
    refuse_model_axis(mesh, mode)
    return topology.dp_size(mesh)


def make_train_step(model, run_cfg: RunConfig, optimizer: Optimizer, lr_fn: Callable,
                    mesh=None):
    """The ``grad_allreduce`` baseline: one pass over the GLOBAL batch, the
    reference's GSPMD step, whose mean gradient is what the all-reduce of
    the per-rank gradients gives. The loss, and so a MoE model's aux
    ``E * sum(me * ce)``, reads the whole batch's router statistics: aux is
    a product of batch means, so the mean of per-rank values (the explicit
    modes' ``pmean``) is another number. On a data-parallel ``mesh`` its
    ranks do not split the pass; on a model axis of more than one rank the
    step is :func:`make_tp_train_step`'s."""
    if mesh is not None and topology.tp_size(mesh) > 1:
        return make_tp_train_step(model, run_cfg, optimizer, lr_fn, mesh)
    if mesh is not None:
        _data_ranks(mesh, "grad_allreduce")
    compute = _grad_fn(model, run_cfg)

    def train_step(params, opt_state, batch):
        treedef = tree_flatten(params)[1]
        loss, metrics, grads = compute(params, batch)
        return _finish(tree_unflatten(treedef, grads), params, opt_state, optimizer, lr_fn,
                       loss, metrics)

    return train_step


def tp_specs(model, mesh):
    """The training layout of ``model`` on ``mesh``: the reference's
    ``param_specs(shapes, mesh)``, FSDP on the data axes and
    ``attn_fallback='replicate'``."""
    return param_specs(model.param_shapes(), mesh, fsdp=True, attn_fallback="replicate")


def _fsdp_dim(spec) -> tuple:
    """``(dim, axes)`` of the one dim a training spec shards over data
    axes, or ``(None, ())``."""
    dims = [(i, e if isinstance(e, tuple) else (e,)) for i, e in enumerate(spec)
            if e is not None and e != topology.TP_AXIS]
    if len(dims) > 1:
        raise ValueError(f"spec {spec} shards more than one dim over the data axes")
    return dims[0] if dims else (None, ())


def gather_model_shards(leaf: torch.Tensor, spec, mesh, gather) -> list:
    """Each model rank's shard of a blocked leaf ``(mesh.size, *block)``
    (the training layout, row ``r`` rank ``r``'s block), in model-rank
    order: the FSDP blocks of its data ranks assembled along the dim they
    split. ``gather(frame, axis)`` all-gathers a rank-stacked frame over
    one data axis; it runs on every group of ranks along that axis
    (:func:`~repro_torch.comm.api.level_replay`, each model rank's strided
    data group), the innermost data axis first, so a dim split over
    ('pod', 'data') jointly ends in pod-major order. A leaf the model axis
    does not split comes back as one tensor, model rank 0's (the ranks
    hold copies). Without data axes in ``spec`` a shard is a view of its
    rank's row; otherwise a new tensor, bit-equal to the concatenation of
    the blocks."""
    names, shape = tuple(mesh.axis_names), tuple(mesh.devices.shape)
    k, axes = _fsdp_dim(spec)
    block = tuple(leaf.shape[1:])
    x = leaf
    for ax in reversed(axes):
        x = level_replay(x.reshape(mesh.size, -1), ax, functools.partial(gather, axis=ax),
                         mesh=mesh)
    parts = math.prod(shape[names.index(a)] for a in axes)
    sharded = topology.TP_AXIS in spec_axes(spec)
    out = []
    for j in range(shape[-1] if sharded else 1):
        row = x[_model_rank_row(mesh, j)]
        if axes:
            row = row.reshape((parts,) + block).movedim(0, k).clone(
                memory_format=torch.contiguous_format)
            row = row.view(block[:k] + (parts * block[k],) + block[k + 1:])
        out.append(row)
    return out


def _model_rank_row(mesh, j: int) -> int:
    """The rank at coordinate ``j`` on the model axis and 0 elsewhere."""
    names, shape = tuple(mesh.axis_names), tuple(mesh.devices.shape)
    coords = [j if a == topology.TP_AXIS else 0 for a in names]
    return int(np.ravel_multi_index(coords, shape))


def cut_model_grads(grads: list, spec, mesh) -> torch.Tensor:
    """The blocked gradient ``(mesh.size, *block)`` of a leaf from the
    gradients of its model ranks' shards ``grads`` (one tensor when the
    model axis does not split the leaf): row ``r`` rank ``r``'s block of
    its model rank's gradient under ``spec``."""
    inner = drop_axis(spec, topology.TP_AXIS)
    shape = tuple(grads[0].shape)
    blocks = [shard_slices(inner, shape, mesh, r) for r in range(mesh.size)]
    out = torch.empty((mesh.size,) + tuple(s.stop - s.start for s in blocks[0]),
                      dtype=grads[0].dtype, device=grads[0].device)
    model = np.unravel_index(np.arange(mesh.size), tuple(mesh.devices.shape))[
        tuple(mesh.axis_names).index(topology.TP_AXIS)]
    for r, sl in enumerate(blocks):
        out[r] = grads[int(model[r]) if len(grads) > 1 else 0][sl]
    return out


def make_tp_train_step(model, run_cfg: RunConfig, optimizer: Optimizer, lr_fn: Callable,
                       mesh):
    """``grad_allreduce`` on a ('data', 'model') or ('pod', 'data',
    'model') mesh: the reference's GSPMD step over its FSDP + TP layout,
    still one pass over the global batch.

    The parameters and the optimizer state are blocked: each leaf is
    ``(mesh.size, *block)``, row ``r`` rank ``r``'s block under
    :func:`tp_specs`. A step

    1. gathers each model rank's shard of every leaf from its data ranks'
       FSDP blocks (:func:`gather_model_shards`), through ``pallgather`` on
       each model rank's data group with the run's tuner table and
       ``compiled_collectives``, each leaf a frame of its own dtype (a
       router's f32 among bf16 ones): the all-gather GSPMD inserts;
    2. runs the tensor-parallel forward and backward
       (:func:`~repro_torch.models.tensor_parallel.tp_loss`, ``remat`` as
       the run says) over the global batch (a vision config's stub patch
       ``embeds`` and an encoder-decoder's stub frames ride in it, cut into
       microbatches with the tokens; a MoE's loss carries the router's aux
       over the whole batch a pass sees) and takes ``torch.autograd.grad``
       over the shards (the f32 mean over microbatches, as
       :func:`_grad_fn`); a leaf the model axis does not split (a norm
       scale, a router whose experts do not divide, a kv projection
       ``attn_fallback='replicate'`` leaves whole) is one tensor in every
       rank's tree, so its gradient is the sum of the ranks' uses;
    3. keeps each rank's FSDP block of its model rank's gradient (the
       reduce-scatter: the pass already took the data mean), clips by the
       global norm over the blocks their owners hold, each element of the
       full tree once (:func:`~repro_torch.dist.sharding.owner_ranks`),
       and steps the optimizer on every block in place. The ranks that
       hold copies of a block receive the same bits, so their rows stay
       bit-equal.

    The step's ``gather_events`` collects a CUDA event pair around each
    step's gathers on the card (empty on the CPU)."""
    cfg = model.cfg
    check_tensor_parallel(cfg, topology.tp_size(mesh))
    if not dp_axes(mesh):
        raise ValueError(f"grad_allreduce needs a data axis, not {tuple(mesh.axis_names)}")
    specs = tree_flatten(tp_specs(model, mesh), is_spec)[0]
    owners = [owner_ranks(sp, mesh) for sp in specs]
    tuner = Tuner.load(run_cfg.tuner_table) if run_cfg.tuner_table else None
    inter = topology.inter_pod_axes(mesh)
    m = topology.tp_size(mesh)

    def gather(frame, axis):
        return pallgather(frame, tuner=tuner, inter_pod=axis in inter,
                          compiled=run_cfg.compiled_collectives)

    def one(state, mb):
        shards, treedef = state
        trees = [tree_unflatten(treedef, [ts[j] if len(ts) > 1 else ts[0] for ts in shards])
                 for j in range(m)]
        loss, metrics = tp_loss(trees, cfg, mb, remat=run_cfg.remat)
        grads = torch.autograd.grad(loss, [t for ts in shards for t in ts])
        return loss.detach(), {key: v.detach() for key, v in metrics.items()}, list(grads)

    compute = _over_microbatches(one, run_cfg.num_microbatches)

    def train_step(params, opt_state, batch):
        leaves, treedef = tree_flatten(params)
        on_card = leaves[0].is_cuda
        if on_card:
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            events[0].record()
        with torch.no_grad():
            shards = [[t.detach().requires_grad_(True)
                       for t in gather_model_shards(leaf, sp, mesh, gather)]
                      for leaf, sp in zip(leaves, specs)]
        if on_card:
            events[1].record()
            train_step.gather_events.append(events)
        counts = [len(ts) for ts in shards]
        loss, metrics, flat = compute((shards, treedef), batch)
        del shards
        blocked = []
        for sp, c in zip(specs, counts):  # each shard's gradient freed once cut
            blocked.append(cut_model_grads([flat.pop(0) for _ in range(c)], sp, mesh))
        grads, gnorm = clip_by_global_norm(tree_unflatten(treedef, blocked), 1.0, owners)
        del blocked
        lr = lr_fn(opt_state["step"])
        params, opt_state = optimizer.update(grads, opt_state, params, lr)
        out = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        out.update(metrics)
        return params, opt_state, out

    train_step.gather_events = []
    return train_step


def make_degraded_psum_train_step(model, run_cfg: RunConfig, optimizer: Optimizer,
                                  lr_fn: Callable, mesh, *, health):
    """Graceful-degradation sync: the sum over the SURVIVING ranks divided
    by their count (``health``, a :class:`~repro_torch.comm.faults.MeshHealth`
    over the data ranks), the reference's masked ``psum``.

    The survivors' gradients are computed on their shards, rank after
    rank, as in the other modes; the dead ranks' shards are skipped (the
    reference masks their rows to zero: on the emulated ranks of one card
    their work would only be thrown away). The survivors' rows are summed
    and the sum divided by their count, so the update is exactly the
    survivors' data-parallel one (dividing by every rank would shrink the
    learning rate by ``n_surv / n``). The loss and the metrics are survivor
    means. Like ``grad_allreduce`` it launches no plan kernel: the
    reference's is a ``psum``."""
    from ..comm.faults import DeadRankError

    n = _data_ranks(mesh, "degraded_psum")
    if health.n != n:
        raise ValueError(f"health report is for n={health.n}, mesh has n_dp={n}")
    survivors = health.survivors()
    if not survivors:
        raise DeadRankError("no surviving data-parallel ranks; restore from checkpoint")
    compute = _grad_fn(model, run_cfg)

    def train_step(params, opt_state, batch):
        treedef = tree_flatten(params)[1]
        stacked, write = _stacked_writer(len(survivors))
        loss, metrics = _per_rank(compute, params, batch, n, write, ranks=survivors)
        grads = [s.sum(0).div_(len(survivors)) for s in stacked]
        del stacked
        return _finish(tree_unflatten(treedef, grads), params, opt_state, optimizer, lr_fn,
                       loss, metrics)

    return train_step


def make_bcast_train_step(model, run_cfg: RunConfig, optimizer: Optimizer, lr_fn: Callable,
                          mesh, *, tuner: Tuner | None = None, root: int = 0,
                          check_rows: bool = False):
    """The paper's sync mode: per-leaf reduce to ``root`` over the reversed
    binomial tree, the mean taken there, then the tuned bucketed broadcast
    of the root's gradients to every rank. With
    ``run_cfg.bcast_algo='ring_allreduce'`` (the paper's Sec. VII future
    work) each rank-stacked gradient leaf goes through the explicit ring
    allreduce of ``core.algorithms`` instead, then is divided by ``n``:
    no reduce to the root and no broadcast.

    On a ('pod', 'data') mesh the levels run as the reference's: the reduce
    over each data axis in mesh order, the division by ``n_dp``, then the
    broadcast over the axes in reverse order, the pod level priced with the
    inter-pod constants; the ring runs once per data axis in mesh order.
    Each level runs on every group of ranks along its axis
    (``comm.api.level_replay``)."""
    n = _data_ranks(mesh, "param_bcast")
    dp = dp_axes(mesh)
    compute = _grad_fn(model, run_cfg)
    ring = run_cfg.bcast_algo == "ring_allreduce"
    reduce = functools.partial(preduce_sum, root=root)

    def per_axis(fn, s):
        for ax in dp:
            s = level_replay(s, ax, fn, mesh=mesh)
        return s

    def train_step(params, opt_state, batch):
        treedef = tree_flatten(params)[1]
        stacked, write = _stacked_writer(n)
        loss, metrics = _per_rank(compute, params, batch, n, write)
        if ring:
            synced = tree_unflatten(treedef, [per_axis(ring_allreduce, s).div_(n)
                                              for s in stacked])
            del stacked
        else:
            synced = tree_unflatten(treedef, [per_axis(reduce, s).div_(n) for s in stacked])
            del stacked
            for ax in reversed(dp):
                synced = pbcast_tree(synced, root=root, algo=run_cfg.bcast_algo, tuner=tuner,
                                     bucket_bytes=run_cfg.bcast_bucket_bytes,
                                     inter_pod=ax == "pod", axis=ax, mesh=mesh)
        rows_differ = _tree_rows_differ(synced, check_rows)
        grads = tree_map(lambda t: t[0], synced)
        del synced
        return _finish(grads, params, opt_state, optimizer, lr_fn, loss, metrics, rows_differ)

    return train_step


def make_tuned_allreduce_train_step(model, run_cfg: RunConfig, optimizer: Optimizer,
                                    lr_fn: Callable, mesh, *, tuner: Tuner | None = None,
                                    check_rows: bool = False):
    """Gradient sync through the ``comm`` plan layer: per-rank gradients
    packed into same-dtype buckets and all-reduced bucket by bucket, each
    bucket's algorithm and chunking a tuned ``CollectivePlan``
    (``run_cfg.allreduce_algo`` pins one; ``compiled_collectives`` routes
    the replay)."""
    return _make_comm_sync_step(model, run_cfg, mesh, _tree_allreduce(run_cfg, tuner, mesh),
                                optimizer, lr_fn, mode="tuned_allreduce", check_rows=check_rows)


def make_overlap_allreduce_train_step(model, run_cfg: RunConfig, optimizer: Optimizer,
                                      lr_fn: Callable, mesh, *, tuner: Tuner | None = None,
                                      check_rows: bool = False):
    """Gradient sync through the overlap engine (``comm.overlap``): the
    buckets, hierarchy levels and per-bucket ``CollectivePlan`` objects of
    ``tuned_allreduce``, so the same parameters bit for bit, with buckets
    streamed in backward-dispatch order inside the tuned in-flight window
    (``run_cfg.overlap_depth``; None = tuned).

    With ``run_cfg.prefetch_stream`` the step carries a SECOND comm stream:
    right after the update, the updated parameters are broadcast as the
    lower-priority ``weight_prefetch`` entry of a 2-entry
    :class:`~repro_torch.comm.streams.StreamGraph`, DAG-ordered ``after``
    the ``grad_sync`` entry (the edge realized by program order). Both
    entries resolve through ``plan_streams``; the graph is planned at the
    first step, from the parameters' shapes (the grad-sync buckets at f32
    when microbatches accumulate in f32), and kept as the step's ``graph``.
    Every rank holds the same parameters, so the broadcast is
    value-identical: here it broadcasts a rank-stacked copy of them (each
    row the updated parameters) and the parameters are then read back from
    its row 0. When ``tuner`` is given, both stream decisions are recorded
    in it (``Tuner.record_stream``)."""
    if not run_cfg.prefetch_stream:
        def sync(grads, axes, inter_pod_axes):
            return overlap_allreduce_tree(
                grads, axes, algo=run_cfg.allreduce_algo, tuner=tuner,
                bucket_bytes=run_cfg.bcast_bucket_bytes, inter_pod_axes=inter_pod_axes,
                overlap_depth=run_cfg.overlap_depth, compute_s=run_cfg.overlap_compute_s,
                compiled=run_cfg.compiled_collectives, mesh=mesh,
            )

        return _make_comm_sync_step(model, run_cfg, mesh, sync, optimizer, lr_fn,
                                    mode="overlap_allreduce", check_rows=check_rows)

    if tuner is not None:
        # stream:* entries survive save/load, so a saved table pins them
        tuner.record_stream("grad_sync", priority=1, overlap_depth=run_cfg.overlap_depth)
        tuner.record_stream("weight_prefetch", priority=0)
    n = _data_ranks(mesh, "overlap_allreduce")
    sizes = topology.axis_sizes(mesh)
    sized_axes = tuple((a, sizes[a]) for a in hierarchical_allreduce_axes(mesh)
                       if sizes.get(a, 1) > 1)
    inter = tuple(topology.inter_pod_axes(mesh))

    def plan(params):
        def shapes(dtype=None):
            return tree_map(lambda p: torch.empty(p.shape, dtype=dtype or p.dtype,
                                                  device="meta"), params)

        # the microbatch accumulator holds the grads in f32 (see _grad_fn)
        gshapes = shapes(torch.float32 if run_cfg.num_microbatches > 1 else None)
        return plan_streams([
            StreamSpec(name="grad_sync", tree=gshapes, axes=sized_axes, op="allreduce",
                       algo=run_cfg.allreduce_algo, priority=1,
                       overlap_depth=run_cfg.overlap_depth,
                       compute_s=run_cfg.overlap_compute_s,
                       bucket_bytes=run_cfg.bcast_bucket_bytes,
                       inter_pod_axes=inter, reverse=True),
            StreamSpec(name="weight_prefetch", tree=shapes(), axes=sized_axes, op="bcast",
                       algo=run_cfg.bcast_algo, priority=0, after=("grad_sync",),
                       bucket_bytes=run_cfg.bcast_bucket_bytes,
                       inter_pod_axes=inter, reverse=False),
        ], tuner=tuner)

    def sync(grads, axes, inter_pod_axes):
        return execute_stream_entry(train_step.graph.entry("grad_sync"), grads,
                                    compiled=run_cfg.compiled_collectives, mesh=mesh)

    def post_update(params, axes, inter_pod_axes):
        # every rank's row holds the updated parameters; row 0 is the root
        stacked = tree_map(lambda p: p.expand((n,) + tuple(p.shape)).clone(
            memory_format=torch.contiguous_format), params)
        execute_stream_entry(train_step.graph.entry("weight_prefetch"), stacked,
                             compiled=run_cfg.compiled_collectives, mesh=mesh)
        for p, s in zip(tree_leaves(params), tree_leaves(stacked)):
            p.copy_(s[0])
        return params

    step = _make_comm_sync_step(model, run_cfg, mesh, sync, optimizer, lr_fn,
                                mode="overlap_allreduce", check_rows=check_rows,
                                post_update=post_update)

    def train_step(params, opt_state, batch):
        if train_step.graph is None:
            train_step.graph = plan(params)
        return step(params, opt_state, batch)

    train_step.graph = None  # the planned StreamGraph, read by callers that report it
    return train_step


def _tree_allreduce(run_cfg: RunConfig, tuner, mesh, wire_format: str | None = None):
    """The bucketed tuned allreduce of the ``comm`` sync modes."""
    def sync(grads, axes, inter_pod_axes):
        return pallreduce_tree(
            grads, axes, algo=run_cfg.allreduce_algo, tuner=tuner,
            bucket_bytes=run_cfg.bcast_bucket_bytes, inter_pod_axes=inter_pod_axes,
            compiled=run_cfg.compiled_collectives, wire_format=wire_format, mesh=mesh,
        )

    return sync


def with_error_feedback(optimizer: Optimizer, n: int = 1) -> Optimizer:
    """Wrap ``optimizer`` so its state carries the error-feedback residual
    at ``state['ef']``: f32 zeros like the parameters, one row per data
    rank (``(n, *shape)``; each rank keeps its own residual). ``update``
    leaves it alone: the compressed step updates it in place."""
    def init(params):
        state = dict(optimizer.init(params))
        state["ef"] = CompressionState.init(params, n)
        return state

    def update(grads, state, params, lr):
        inner = {k: v for k, v in state.items() if k != "ef"}
        params, inner = optimizer.update(grads, inner, params, lr)
        state.update(inner)
        return params, state

    return Optimizer(optimizer.name + "+ef", init, update)


def make_compressed_allreduce_train_step(model, run_cfg: RunConfig, optimizer: Optimizer,
                                         lr_fn: Callable, mesh, *,
                                         tuner: Tuner | None = None, check_rows: bool = False):
    """Gradient sync over a compressed wire with error feedback (EF-SGD):

        c_t = g_t + e_t            # compensate
        sync = allreduce(Q(c_t))   # every hop quantized
        e_{t+1} = c_t - Q(c_t)     # this rank's first-hop error

    ``optimizer`` must be wrapped by :func:`with_error_feedback` with the
    mesh's rank count. Rank ``r``'s ``c`` is built in place in row ``r`` of
    the residual as its backward finishes (no stacked gradient tree lives
    beside it); buckets sync one at a time on f32 copies, and only row 0 of
    each is kept; then every row becomes its new residual in place.

    ``wire_format='bf16'`` is the passthrough: no compensation, the bf16
    gradients sync exactly as in ``tuned_allreduce`` (bit-identical
    parameters) and the residual stays zero."""
    fmt = normalize_wire_format(run_cfg.wire_format)
    if not fmt.compressed:
        return _make_comm_sync_step(model, run_cfg, mesh,
                                    _tree_allreduce(run_cfg, tuner, mesh, fmt.value),
                                    optimizer, lr_fn, mode="compressed_allreduce",
                                    check_rows=check_rows)

    n = _data_ranks(mesh, "compressed_allreduce")
    axes = [a for a in hierarchical_allreduce_axes(mesh)
            if topology.axis_sizes(mesh).get(a, 1) > 1]
    inter = topology.inter_pod_axes(mesh)
    compute = _grad_fn(model, run_cfg)

    def train_step(params, opt_state, batch):
        residual = opt_state["ef"]
        res_leaves = tree_leaves(residual)

        def write(r, grads):
            for e, g in zip(res_leaves, grads):
                e[r].add_(g)  # c = g + e, in f32

        loss, metrics = _per_rank(compute, params, batch, n, write)
        spec = bucketing.plan_buckets(tree_map(lambda t: t[0], residual),
                                      run_cfg.bcast_bucket_bytes)
        rows = []
        rows_differ = torch.zeros((), dtype=torch.int64, device=loss.device) if check_rows else None
        for b in bucketing.pack_buckets(residual, spec):
            if b.shape[-1] and axes:
                c = b
                for ax in axes:  # the first level's result is new: the residual stays
                    b = level_replay(b, ax, functools.partial(
                        pallreduce, algo=run_cfg.allreduce_algo, tuner=tuner,
                        inter_pod=ax in inter, compiled=run_cfg.compiled_collectives,
                        wire_format=fmt.value), mesh=mesh, out=None if b is c else b)
                del c
                if check_rows:
                    rows_differ += _rows_differ(b)
            rows.append(b[0].div(n))
            del b
        grads = bucketing.unpack_buckets(rows, spec)
        del rows
        for e in res_leaves:
            CompressionState.update_(e, fmt)
        return _finish(grads, params, opt_state, optimizer, lr_fn, loss, metrics, rows_differ)

    return train_step


def _make_comm_sync_step(model, run_cfg: RunConfig, mesh, sync, optimizer: Optimizer,
                         lr_fn: Callable, *, mode: str, check_rows: bool, post_update=None):
    """Shared body of the ``comm`` gradient-sync modes: the per-rank
    gradients, rank-stacked, go through ``sync(grads, axes,
    inter_pod_axes)``; the update reads row 0 divided by the rank count.
    ``post_update(params, axes, inter_pod_axes)`` runs right after the
    update, the hook the weight-prefetch stream entry rides (it must
    return the parameters unchanged in value)."""
    n = _data_ranks(mesh, mode)
    sizes = topology.axis_sizes(mesh)
    axes = [a for a in hierarchical_allreduce_axes(mesh) if sizes.get(a, 1) > 1]
    inter = topology.inter_pod_axes(mesh)
    compute = _grad_fn(model, run_cfg)

    def train_step(params, opt_state, batch):
        treedef = tree_flatten(params)[1]
        stacked, write = _stacked_writer(n)
        loss, metrics = _per_rank(compute, params, batch, n, write)
        synced = sync(tree_unflatten(treedef, stacked), axes, inter)
        del stacked
        rows_differ = _tree_rows_differ(synced, check_rows)
        grads = tree_map(lambda t: t[0] / n, synced)
        del synced
        params, opt_state, out = _finish(grads, params, opt_state, optimizer, lr_fn, loss,
                                         metrics, rows_differ)
        del grads
        if post_update is not None:
            params = post_update(params, axes, inter)
        return params, opt_state, out

    return train_step
