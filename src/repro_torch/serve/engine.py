"""Serving engine: batched prefill + step-synchronous decode, after the
paper's tuned broadcast has distributed the weights.

On an emulated mesh of ``n`` data ranks the engine holds one replica per
rank as a rank-stacked tree (leaf ``(n, *shape)``). With ``distribute=True``
the loaded weights enter on row 0 (the root) and the other rows start
empty; :func:`distribute_weights` broadcasts them with the planned
collectives. :meth:`Engine.generate` splits the batch over the data ranks
and serves rank ``r``'s requests from rank ``r``'s replica, one rank after
another on the one card, so every served token depends on the broadcast.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import comm
from ..comm import streams as comm_streams
from ..configs.base import ModelConfig
from ..core import bucketing
from ..core.tree import tree_leaves, tree_map
from ..dist import topology
from ..launch.mesh import EmulatedMesh, resolve_device
from ..models import Model

__all__ = [
    "Engine",
    "GenerationResult",
    "distribute_weights",
    "distribution_stream_graph",
    "plan_distribution",
    "replicate",
]


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray          # (B, steps)
    logprobs: np.ndarray        # (B, steps)
    prefill_len: int


def replicate(params, n: int, *, fill_root_only: bool) -> dict:
    """The rank-stacked tree for ``n`` ranks: row 0 holds ``params``; the
    other rows are copies, or left uninitialized (``torch.empty``) when
    ``fill_root_only`` — the state right before a weight broadcast."""
    def stack(t):
        out = torch.empty((n,) + tuple(t.shape), dtype=t.dtype, device=t.device)
        out[0] = t
        if not fill_root_only:
            out[1:] = t
        return out
    return tree_map(stack, params)


class Engine:
    """``params`` is the loaded (unstacked) parameter tree on ``device``.
    With ``mesh`` (an :class:`~repro_torch.launch.mesh.EmulatedMesh` on the
    same device) the engine serves from one replica per data rank."""

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
        self.n = 1 if mesh is None else mesh.size
        if self.n == 1:
            stacked = tree_map(lambda t: t.unsqueeze(0), params)
        elif distribute:
            stacked = replicate(params, self.n, fill_root_only=True)
            stacked = distribute_weights(stacked, mesh, double_buffer=double_buffer,
                                         drain_dir=drain_dir)
        else:
            stacked = replicate(params, self.n, fill_root_only=False)
        self.params = stacked

    def replica(self, rank: int):
        """Rank ``rank``'s parameters (views of the stacked tree)."""
        return tree_map(lambda t: t[rank], self.params)

    @torch.no_grad()
    def generate(self, batch: dict, *, steps: int, greedy: bool = True,
                 temperature: float = 1.0, seed: int = 0) -> GenerationResult:
        """``batch['tokens']``: (B, T) integer array or tensor. The batch is
        split over the data ranks (``tensor_split``, as even as B allows)."""
        tokens = batch["tokens"]
        if not torch.is_tensor(tokens):
            tokens = torch.as_tensor(np.asarray(tokens))
        tokens = tokens.to(self.device).long()
        T = tokens.shape[1]
        max_len = self.max_len or (T + steps)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        toks, lps = [], []
        for rank, part in enumerate(torch.tensor_split(tokens, self.n)):
            if not part.shape[0]:
                continue
            params = self.replica(rank)
            logits, caches = self.model.prefill(params, {"tokens": part}, max_len=max_len)
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
                logits, caches = self.model.decode_step(params, nxt[:, None], caches, T + i)
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
                              double_buffer: bool = False, overlap_depth: int = 2):
    """Weight distribution as a one-entry :class:`~repro_torch.comm.StreamGraph`:
    the tuned broadcast over ``topology.bcast_axes(mesh)``, ``overlap_depth``
    staging buffers deep when ``double_buffer``. The graph fingerprint keys
    ``plan_cached`` (``stream=``). Returns ``(graph, bucket_spec, plans)``."""
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
        "drain": False,
    })
    bucket_spec, plans = plan_distribution(
        stacked, mesh, algo=algo, tuner=tuner, bucket_bytes=bucket_bytes, stream=gkey,
    )
    entry = comm_streams.StreamEntry(
        name="distribute", op="bcast", spec=bucket_spec, axes=tuple(plans),
        plans={ax: tuple(ax_plans) for ax, ax_plans in plans.items()},
        order=tuple(range(bucket_spec.num_buckets)),  # load order
        overlap_depth=depth,
    )
    return comm_streams.StreamGraph((entry,), key=gkey), bucket_spec, plans


def distribute_weights(stacked, mesh, *, algo: str = "auto", tuner=None,
                       bucket_bytes: int = 4 << 20, return_plans: bool = False,
                       double_buffer: bool = False, overlap_depth: int = 2,
                       stage_chunk: int = 64 * 1024, compiled: bool | None = None,
                       drain_dir: Optional[str] = None):
    """Broadcast the root's weights (row 0 of the rank-stacked tree) to
    every data rank with the tuned library (the paper's 'training
    parameters exchange' applied at load), and return the stacked tree with
    every row equal to row 0.

    The sequence is planned on the host (:func:`distribution_stream_graph`)
    and replayed bucket by bucket through ``comm.apply_plan``.
    ``double_buffer=True`` stages each bucket through the ``chunked_copy``
    kernel, ``overlap_depth`` buckets ahead; the per-bucket collectives are
    the same plans either way, so the weights are identical. ``compiled``
    routes the per-bucket replay (None = the tuned policy).

    Buckets are updated in place: without staging, a bucket that is one
    contiguous leaf of ``stacked`` is that leaf, so ``stacked`` itself
    receives the broadcast. The returned tree is always the result."""
    if drain_dir is not None:
        raise NotImplementedError(
            "draining the weights to a checkpoint on failure needs the "
            "checkpoint layer, not ported yet (ROADMAP A.10)")
    for leaf in tree_leaves(stacked):
        if leaf.shape[:1] != (mesh.size,) or leaf.device != mesh.device:
            raise ValueError(
                f"leaf {tuple(leaf.shape)} on {leaf.device} is not stacked over the "
                f"mesh's {mesh.size} ranks on {mesh.device}")
    graph, _spec, plans = distribution_stream_graph(
        stacked, mesh, algo=algo, tuner=tuner, bucket_bytes=bucket_bytes,
        double_buffer=double_buffer, overlap_depth=overlap_depth,
    )
    out = comm_streams.execute_stream_entry(
        graph.entry("distribute"), stacked, stage=double_buffer,
        stage_chunk=stage_chunk, compiled=compiled,
    )
    return (out, plans) if return_plans else out
