"""Serving engine: batched prefill + step-synchronous decode, after the
paper's tuned broadcast has distributed the weights.

On an emulated mesh of ``n`` data ranks (a ('data',) or a ('pod', 'data')
mesh, ``n = mesh.size``) the engine holds one replica per rank as a
rank-stacked tree (leaf ``(n, *shape)``). With ``distribute=True``
the loaded weights enter on row 0 (the root) and the other rows start
empty; :func:`distribute_weights` broadcasts them with the planned
collectives, level by level, the pod level first.
:meth:`Engine.generate` splits the batch over the data ranks
and serves rank ``r``'s requests from rank ``r``'s replica, one rank after
another on the one card, so every served token depends on the broadcast.

On a mesh with a ``model`` axis of M > 1 ranks (('data', 'model') or
('pod', 'data', 'model')) the engine serves tensor-parallel, in the
reference's TP serving layout: the weights land on
``param_specs(fsdp=False, attn_fallback='head_dim')``, every leaf
``(mesh.size, *block)`` with row ``r`` rank ``r``'s block (ranks
row-major, so a data rank's M model ranks are consecutive rows); with
``distribute=True`` they arrive by the tuned broadcast along the data
axes, from the rows of data coordinate 0, and are then cut to the specs
(``distribute_weights(specs=)``). Any batch serves, split as
``batch_specs`` places it (:func:`serving_groups`): over the joint data
axes when it divides them, each data rank's requests computed by its M
model ranks together (:mod:`repro_torch.models.tensor_parallel`); over
'data' alone when only that divides, each data coordinate's requests by
the model ranks at pod 0 (the other pods' replicas would compute the same
values, so they are not run again); over no data axis, the whole batch by
one group of every data rank at pod 0, its replicated forward run once, on
the model ranks of data coordinate 0, and its caches cut over all the
group's ranks, the sequence on 'data' where it divides (one long prompt
over a node's data ranks). Every (data, model) rank's attention and cross
caches are its ``cache_specs`` block on the mesh (its kv heads, or its
slots of the sequence, or the whole cache where nothing divides), and each
model rank's recurrent state its block (mLSTM's key rows, sLSTM's slice of
d, Mamba's channels), kept once over the data ranks of a group. Every
family serves so.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from .. import comm
from ..comm import streams as comm_streams
from ..configs.base import ModelConfig
from ..core import bucketing
from ..core.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from ..dist import topology
from ..dist.sharding import batch_specs, cut_leaves, param_specs, shard_stacked, spec_axes
from ..dist.topology import DP_AXES, TP_AXIS
from ..launch.mesh import EmulatedMesh, resolve_device
from ..models import Model
from ..models import tensor_parallel as tp_lib

__all__ = [
    "Engine",
    "GenerationResult",
    "ServingGroup",
    "distribute_weights",
    "distribution_stream_graph",
    "plan_distribution",
    "replicate",
    "serving_groups",
]


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray          # (B, steps)
    logprobs: np.ndarray        # (B, steps)
    prefill_len: int


def replicate(params, n: int, *, fill_root_only: bool, roots=(0,)) -> dict:
    """The rank-stacked tree for ``n`` ranks: the rows ``roots`` hold
    ``params`` (row 0; on a model axis, the rows of data coordinate 0); the
    other rows are copies, or left uninitialized (``torch.empty``) when
    ``fill_root_only`` — the state right before a weight broadcast."""
    def stack(t):
        out = torch.empty((n,) + tuple(t.shape), dtype=t.dtype, device=t.device)
        if fill_root_only:
            for r in roots:
                out[r] = t
        else:
            out[:] = t
        return out
    return tree_map(stack, params)


def rank_rows(mesh) -> np.ndarray:
    """``(dp_size, tp_size)``: the row of each (data rank, model rank) of
    ``mesh``, data ranks row-major over the data axes."""
    names = tuple(mesh.axis_names)
    rows = np.arange(mesh.size).reshape(tuple(mesh.devices.shape))
    order = [names.index(a) for a in topology.dp_axes(mesh)]
    if topology.tp_axis(mesh):
        order.append(names.index(topology.tp_axis(mesh)))
    return rows.transpose(order).reshape(topology.dp_size(mesh), topology.tp_size(mesh))


@dataclasses.dataclass(frozen=True)
class ServingGroup:
    """Ranks that serve one share of a batch on a model axis: the requests
    ``[lo, hi)``, the rank rows ``ranks`` ((D, M): D data ranks of M model
    ranks, data-major) and ``mesh``, the ('data', 'model') mesh of that
    shape over which their caches are cut."""
    lo: int
    hi: int
    ranks: np.ndarray
    mesh: EmulatedMesh


def serving_groups(mesh, batch: int) -> list:
    """The groups that serve a batch of ``batch`` requests on ``mesh`` (a
    mesh with a model axis), as ``batch_specs`` places the batch: one group
    for each coordinate of the data axes the batch is on, its requests that
    coordinate's share, at coordinate 0 of every other data axis (whose
    replicas would compute the same values: they are not run again); a
    batch on no data axis is one group over the 'data' axis's ranks at
    coordinate 0 of 'pod', whose caches ``cache_specs`` cuts on the
    sequence over 'data'."""
    on = spec_axes(batch_specs({"tokens": torch.empty((batch,), device="meta")},
                               mesh)["tokens"])
    names, sizes = tuple(mesh.axis_names), topology.axis_sizes(mesh)
    tp = topology.tp_axis(mesh)
    keep = on + (() if on else (DP_AXES[-1],)) + (tp,)
    grid = np.arange(mesh.size).reshape(tuple(mesh.devices.shape))
    grid = grid[tuple(slice(None) if a in keep else 0 for a in names)]
    grid = grid.transpose([[a for a in names if a in keep].index(a) for a in keep])
    n = math.prod(sizes[a] for a in on)
    grid = grid.reshape(n, -1, sizes[tp])
    per = batch // n
    return [ServingGroup(i * per, (i + 1) * per, ranks,
                         EmulatedMesh(ranks.shape, mesh.device, (DP_AXES[-1], TP_AXIS)))
            for i, ranks in enumerate(grid)]


class Engine:
    """``params`` is the loaded (unstacked) parameter tree on ``device``.
    With ``mesh`` (an :class:`~repro_torch.launch.mesh.EmulatedMesh` on the
    same device) the engine serves from one replica per data rank, or, on a
    ``model`` axis of more than one rank, from each data rank's model-rank
    shards in the TP serving layout (see the module docstring; a config the
    tensor-parallel forward does not cover raises ``ValueError``)."""

    def __init__(self, cfg: ModelConfig, params, *, mesh: EmulatedMesh | None = None,
                 max_len: int = 0, distribute: bool = False, double_buffer: bool = False,
                 drain_dir: Optional[str] = None, device="cuda"):
        self.device = resolve_device(device)
        for leaf in tree_leaves(params):
            if leaf.device != self.device:
                raise ValueError(f"parameters lie on {leaf.device}, engine on {self.device}")
        if mesh is not None and mesh.device != self.device:
            raise ValueError(f"mesh lies on {mesh.device}, engine on {self.device}")
        self.cfg = cfg
        self.model = Model(cfg)
        self.mesh = mesh
        self.max_len = max_len
        self.n = 1 if mesh is None else topology.dp_size(mesh)  # data ranks
        self.tp = 1 if mesh is None else topology.tp_size(mesh)  # model ranks
        if self.tp > 1:
            tp_lib.check_tensor_parallel(cfg, self.tp, mode="serve")
            self.rows = rank_rows(mesh)
            pspecs = param_specs(self.model.param_shapes(), mesh, fsdp=False,
                                 attn_fallback="head_dim")
            if distribute:
                stacked = distribute_weights(
                    replicate(params, mesh.size, fill_root_only=True, roots=self.rows[0]),
                    mesh, specs=pspecs, double_buffer=double_buffer, drain_dir=drain_dir)
            else:
                stacked = shard_stacked(params, pspecs, mesh)
        elif self.n == 1:
            stacked = tree_map(lambda t: t.unsqueeze(0), params)
        elif distribute:
            stacked = replicate(params, self.n, fill_root_only=True)
            stacked = distribute_weights(stacked, mesh, double_buffer=double_buffer,
                                         drain_dir=drain_dir)
        else:
            stacked = replicate(params, self.n, fill_root_only=False)
        self.params = stacked

    def replica(self, rank: int):
        """Data rank ``rank``'s parameters (views of the stacked tree): its
        replica, or on a model axis its model ranks' shards (a list in
        model-rank order)."""
        if self.tp > 1:
            return self.shards(self.rows[rank])
        return tree_map(lambda t: t[rank], self.params)

    def shards(self, rows) -> list:
        """The model-rank shards of the rank rows ``rows`` (one data rank's
        M rows), views of the stacked tree in model-rank order."""
        return [tree_map(lambda t, r=r: t[r], self.params) for r in rows]

    def groups(self, batch: int) -> list:
        """On a model axis, the :class:`ServingGroup` s that serve a batch of
        ``batch`` requests (:func:`serving_groups`)."""
        return serving_groups(self.mesh, batch)

    def prefill(self, params, batch: dict, *, max_len: int, mesh=None):
        """One data rank's prefill on its :meth:`replica` (``Model.prefill``,
        or the tensor-parallel forward, whose caches, as ``Model.prefill``'s,
        hold a vision prefix's slots beside ``max_len``); on a model axis
        ``mesh`` is the serving group's (:attr:`ServingGroup.mesh`; default
        one data rank), over whose ranks the caches are cut."""
        if self.tp > 1:
            if self.cfg.frontend == "vision":
                max_len = max_len + self.cfg.prefix_len
            return tp_lib.apply_lm_tp(params, self.cfg, tokens=batch["tokens"],
                                      embeds=batch.get("embeds"), mode="prefill", max_len=max_len,
                                      cache_mesh=mesh)
        return self.model.prefill(params, batch, max_len=max_len)

    def decode_step(self, params, tokens: torch.Tensor, caches, cur_pos: int):
        """One data rank's (or serving group's) decode step
        (``Model.decode_step``, or the tensor-parallel forward); the caches
        are updated in place."""
        if self.tp > 1:
            return tp_lib.apply_lm_tp(params, self.cfg, tokens=tokens, mode="decode",
                                      caches=caches, cur_pos=int(cur_pos))
        return self.model.decode_step(params, tokens, caches, cur_pos)

    @torch.no_grad()
    def generate(self, batch: dict, *, steps: int, greedy: bool = True,
                 temperature: float = 1.0, seed: int = 0) -> GenerationResult:
        """``batch['tokens']``: (B, T) integer array or tensor, and
        ``batch['embeds']``: for a vision config (B, prefix, D), the stub
        patch embeddings, for an encoder-decoder (B, frames, D), the stub
        frame embeddings. The batch is split over the data ranks
        (``tensor_split``, as even as B allows), or on a model axis over the
        serving groups (:func:`serving_groups`, as ``batch_specs`` places
        it: any B); decode positions follow the text, and a vision prefix
        (audio frames take no position)."""
        tokens = batch["tokens"]
        if not torch.is_tensor(tokens):
            tokens = torch.as_tensor(np.asarray(tokens))
        tokens = tokens.to(self.device).long()
        T = tokens.shape[1]
        max_len = self.max_len or (T + steps)
        offset = self.cfg.prefix_len if self.cfg.frontend == "vision" else 0
        embeds = batch.get("embeds")
        if embeds is not None:
            embeds = torch.as_tensor(embeds, device=self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        toks, lps = [], []
        if self.tp > 1:
            shares = [((g.lo, g.hi), self.shards(g.ranks[0]), g.mesh)
                      for g in self.groups(tokens.shape[0])]
        else:
            bounds = np.cumsum([0] + [len(p) for p in np.array_split(
                np.arange(tokens.shape[0]), self.n)])
            shares = [((lo, hi), self.replica(r), None)
                      for r, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:]))]
        for (lo, hi), params, mesh in shares:
            if hi == lo:
                continue
            emb = None if embeds is None else embeds[lo:hi]
            logits, caches = self.prefill(params, {"tokens": tokens[lo:hi], "embeds": emb},
                                          max_len=max_len, mesh=mesh)
            cur = logits[:, -1]
            rt, rl = [], []
            for i in range(steps):
                if greedy:
                    nxt = torch.argmax(cur, dim=-1)
                else:
                    probs = torch.softmax(cur / temperature, dim=-1)
                    nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
                lp = torch.log_softmax(cur, dim=-1)
                rl.append(torch.gather(lp, 1, nxt[:, None])[:, 0])
                rt.append(nxt)
                logits, caches = self.decode_step(params, nxt[:, None], caches,
                                                  T + offset + i)
                cur = logits[:, 0]
            toks.append(torch.stack(rt, dim=1))
            lps.append(torch.stack(rl, dim=1))
        return GenerationResult(
            tokens=torch.cat(toks).cpu().numpy(),
            logprobs=torch.cat(lps).float().cpu().numpy(),
            prefill_len=T,
        )


def _rank_view(stacked):
    """One rank's leaves (views of row 0): the per-rank shapes planning uses."""
    return tree_map(lambda t: t[0], stacked)


def plan_distribution(stacked, mesh, *, algo: str = "auto", tuner=None,
                      bucket_bytes: int = 4 << 20, stream: str | None = None):
    """Host-side planning for weight distribution: pack one rank's
    parameter tree into same-dtype buckets and resolve one
    :class:`~repro_torch.comm.CollectivePlan` per (bucket, mesh level).
    Returns ``(bucket_spec, {axis_name: [plan per bucket]})``."""
    spec = bucketing.plan_buckets(_rank_view(stacked), bucket_bytes)
    sizes = topology.axis_sizes(mesh)
    plans = {}
    for ax in topology.bcast_axes(mesh):
        plans[ax] = [
            comm.plan_cached(
                "bcast", M, sizes[ax], algo=algo, tuner=tuner,
                inter_pod=topology.is_inter_pod(ax), stream=stream,
            )
            for M in spec.bucket_bytes()
        ]
    return spec, plans


def distribution_stream_graph(stacked, mesh, *, algo: str = "auto", tuner=None,
                              bucket_bytes: int = 4 << 20,
                              double_buffer: bool = False, overlap_depth: int = 2,
                              drain: bool = False):
    """Weight distribution as a :class:`~repro_torch.comm.StreamGraph` of
    prioritized entries on distinct links:

    * ``ckpt_drain`` (present when ``drain``): the host snapshot of the
      pre-distribution weights, priority 2 on the ``host`` link, with the
      same bucket mix and no collective plans;
    * ``distribute``: the tuned broadcast over ``topology.bcast_axes(mesh)``,
      DAG-ordered ``after`` the drain (the snapshot holds a valid copy before
      the broadcast writes the buffers), ``overlap_depth`` staging buffers
      deep when ``double_buffer``.

    The graph fingerprint keys ``plan_cached`` (``stream=``). Returns
    ``(graph, bucket_spec, plans)``."""
    spec = bucketing.plan_buckets(_rank_view(stacked), bucket_bytes)
    sizes = topology.axis_sizes(mesh)
    axes = list(topology.bcast_axes(mesh))
    depth = max(1, int(overlap_depth)) if double_buffer else 1
    gkey = comm_streams.graph_key({
        "consumer": "serve.distribute_weights",
        "op": "bcast",
        "algo": algo,
        "axes": [[ax, int(sizes[ax])] for ax in axes],
        "buckets": list(spec.bucket_bytes()),
        "depth": depth,
        "drain": bool(drain),
    })
    bucket_spec, plans = plan_distribution(
        stacked, mesh, algo=algo, tuner=tuner, bucket_bytes=bucket_bytes, stream=gkey,
    )
    order = tuple(range(bucket_spec.num_buckets))  # load order
    entries = []
    if drain:
        entries.append(comm_streams.StreamEntry(
            name="ckpt_drain", op="drain", spec=bucket_spec, axes=(), plans={}, order=order,
            overlap_depth=1, priority=2, link="host",
        ))
    entries.append(comm_streams.StreamEntry(
        name="distribute", op="bcast", spec=bucket_spec, axes=tuple(plans),
        plans={ax: tuple(ax_plans) for ax, ax_plans in plans.items()},
        order=order, overlap_depth=depth, priority=1,
        after=("ckpt_drain",) if drain else (), link="ici",
    ))
    return comm_streams.StreamGraph(tuple(entries), key=gkey), bucket_spec, plans


def distribute_weights(stacked, mesh, *, algo: str = "auto", tuner=None, specs=None,
                       bucket_bytes: int = 4 << 20, return_plans: bool = False,
                       double_buffer: bool = False, overlap_depth: int = 2,
                       stage_chunk: int = 64 * 1024, donate: bool = False,
                       compiled: bool | None = None,
                       drain_dir: Optional[str] = None):
    """Broadcast the root's weights (row 0 of the rank-stacked tree) to
    every data rank with the tuned library (the paper's 'training
    parameters exchange' applied at load), and return the stacked tree with
    every row equal to row 0. On a mesh with a ``model`` axis, every model
    coordinate has its root (the rows of data coordinate 0), and each
    broadcasts along the data axes to its own rows.

    ``specs`` (a ``param_specs`` tree): the replicated result is then laid
    out per those specs, as the reference's ``device_put`` does: each leaf
    becomes ``(mesh.size, *block)``, row ``r`` rank ``r``'s block
    (:func:`~repro_torch.dist.sharding.shard_stacked`), a contiguous copy,
    and each full leaf is dropped once it is cut (freed, unless the caller
    holds it). The broadcast itself is planned and replayed on the full
    buckets, as without ``specs``.

    The sequence is planned on the host (:func:`distribution_stream_graph`)
    and replayed bucket by bucket through ``comm.apply_plan``, one level of
    ``topology.bcast_axes(mesh)`` after another (the pod level first), each
    level's plan on every group of ranks along its axis
    (``comm.api.level_replay``).
    ``double_buffer=True`` stages each bucket through the ``chunked_copy``
    kernel, ``overlap_depth`` buckets ahead; the per-bucket collectives are
    the same plans either way, so the weights are identical.
    ``stage_chunk`` is accepted and ignored, as
    :func:`~repro_torch.comm.streams.execute_stream_entry`'s is. ``donate`` is
    accepted and ignored: the reference donates the incoming buffers to its
    jitted broadcast so that no bucket is held twice, and here the replicas
    are updated in place, which holds no second copy either. ``compiled``
    routes the per-bucket replay (None = the tuned policy).

    Without ``specs``, ``stacked`` is updated in place and returned: every
    leaf keeps its own contiguous layout, so each rank's replica starts
    where the leaf's row starts (a result left in a padded bucket buffer
    would put rank ``r``'s row ``r`` padded bucket lengths in, off the
    16-byte boundary that cuBLAS's fast matmul kernels need).

    ``drain_dir``: graceful degradation on an unrecoverable failure. Before
    the first bucket moves, a host copy of row 0 of every leaf (the root's
    weights, the payload of the broadcast) is taken; the graph's
    ``ckpt_drain`` entry runs before ``distribute``. If the distribution
    raises (a rank lost mid-broadcast, a kernel that fails to launch, out of
    memory), that copy is saved as an atomic checkpoint at step 0 under
    ``drain_dir`` and a typed :class:`~repro_torch.comm.WeightSyncError` is
    raised, chained to the cause: never a silent partial distribution (the
    rows may then be half-written)."""
    for leaf in tree_leaves(stacked):
        if leaf.shape[:1] != (mesh.size,) or leaf.device != mesh.device:
            raise ValueError(
                f"leaf {tuple(leaf.shape)} on {leaf.device} is not stacked over the "
                f"mesh's {mesh.size} ranks on {mesh.device}")
    graph, _spec, plans = distribution_stream_graph(
        stacked, mesh, algo=algo, tuner=tuner, bucket_bytes=bucket_bytes,
        double_buffer=double_buffer, overlap_depth=overlap_depth,
        drain=drain_dir is not None,
    )
    snapshot = None
    if drain_dir is not None:
        # host RAM is the cheap side of the serving node, device memory is not
        snapshot = tree_map(lambda t: t[0].to("cpu", copy=True), stacked)
    try:
        out = comm_streams.execute_stream_entry(
            graph.entry("distribute"), stacked, stage=double_buffer, compiled=compiled,
            mesh=mesh,
        )
        if specs is not None:
            leaves, treedef = tree_flatten(out)
            stacked = out = None  # the leaves list holds the full leaves, cut one by one
            out = tree_unflatten(treedef, cut_leaves(leaves, specs, mesh, rows_full=True))
    except Exception as e:  # noqa: BLE001 — rewrapped as a typed, actionable error
        if snapshot is None:
            raise
        from ..comm.faults import WeightSyncError
        from ..train import checkpoint as ckpt_lib

        try:
            fname = ckpt_lib.save_checkpoint(drain_dir, 0, snapshot)
        except Exception as drain_err:
            raise WeightSyncError(
                f"weight distribution failed ({type(e).__name__}: {e}) AND the "
                f"drain to {drain_dir!r} also failed "
                f"({type(drain_err).__name__}: {drain_err}); weights may be lost"
            ) from e
        raise WeightSyncError(
            f"weight distribution failed ({type(e).__name__}: {e}); "
            f"pre-distribution weights drained to {fname} — restore from the "
            f"checkpoint and replan on a healthy mesh"
        ) from e
    return (out, plans) if return_plans else out
