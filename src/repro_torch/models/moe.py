"""Mixture-of-Experts FFN: GShard-style top-k dispatch with capacity.

Formulation, as in the reference: tokens are grouped (B, nG, S); the
router's top-k choices are turned into a (B, nG, S, E, C) combine tensor;
expert inputs and outputs move through einsums. Tokens overflowing an
expert's capacity are dropped (the residual passes through), as in
GShard/Switch.

Two dispatch transports (``cfg.moe_dispatch``):

- ``"einsum"`` (default): the dense one-hot einsum formulation above, on
  the whole batch; also the oracle the explicit path is held against.
- ``"alltoallv"`` with ``mesh=`` (an emulated mesh of ``n`` data ranks):
  explicit expert parallelism. The batch splits into ``n`` contiguous
  shards, one a rank; experts are contiguously partitioned across ranks
  (:func:`expert_partition`; E need not divide n), and the expert inputs
  and outputs move through :func:`repro_torch.comm.palltoallv` — the ragged
  block sizes are exactly the ``sizes`` matrix of the schedule-IR
  alltoallv. On the one card the routing, expert and combine arithmetic
  are the einsum path's, on its shapes, with the two transports in
  between (see :func:`_expert_parallel`): a comparison of the two
  dispatches holds the transports, not per-rank arithmetic.

Shared experts (DeepSeek/Moonlight style) run densely for every token.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..comm.api import palltoallv
from .layers import _norm_init, down_proj

__all__ = ["init_moe", "moe_ffn", "expert_partition", "expert_shard_outs", "ffn_shard_outs",
           "group_tokens", "route_logits", "router_logits"]


def init_moe(gen: torch.Generator, cfg, dtype=torch.bfloat16, lead: tuple = ()) -> dict:
    """The router (f32), the experts' stacked SwiGLU weights and, with
    ``cfg.num_shared_experts``, the shared experts' dense ones; ``lead``
    prepends stacked dimensions (layers of a superblock)."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {
        "router": _norm_init(gen, lead + (d, E), d**-0.5, torch.float32),
        "w_gate": _norm_init(gen, lead + (E, d, f), d**-0.5, dtype),
        "w_up": _norm_init(gen, lead + (E, d, f), d**-0.5, dtype),
        "w_down": _norm_init(gen, lead + (E, f, d), f**-0.5, dtype),
    }
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        p["shared"] = {
            "w_gate": _norm_init(gen, lead + (d, fs), d**-0.5, dtype),
            "w_up": _norm_init(gen, lead + (d, fs), d**-0.5, dtype),
            "w_down": _norm_init(gen, lead + (fs, d), fs**-0.5, dtype),
        }
    return p


def _capacity(S: int, k: int, E: int, cf: float) -> int:
    c = int(S * k * cf / E) + 1
    # the floor of 4 keeps tiny groups from thrashing drops, but it must
    # never exceed the S*k slot supply (S=2, k=1 has only 2 slots total)
    return max(min(4, S * k), min(c, S * k)) if S > 1 else max(1, k)


def _group_size(T: int, cfg) -> int:
    """Dispatch group length: ``cfg.moe_group_size`` when it divides T,
    else the largest divisor of T that fits (T=520, group 512 -> 260;
    prime T degrades to 1 rather than asserting)."""
    S = min(cfg.moe_group_size, T)
    if T % S:
        S = max(d for d in range(1, S + 1) if T % d == 0)
    return S


def _one_hot(idx: torch.Tensor, width: int) -> torch.Tensor:
    """f32 one-hot of ``idx`` over ``width`` classes; an index at or beyond
    ``width`` gives a zero row (``jax.nn.one_hot``'s rule)."""
    return (idx[..., None] == torch.arange(width, device=idx.device)).float()


def _route(p, xg: torch.Tensor, cfg, ranks: int = 1):
    """Router + capacity bookkeeping on grouped tokens (B, nG, S, D).

    Returns (combine, dispatch, me, ce): the (B, nG, S, E, C) combine /
    dispatch tensors and the load-balancing statistics — ``me`` the mean
    router probability and ``ce`` the fraction of tokens routed per expert
    (normalized by k so it sums to ~1 regardless of top-k width). With
    ``ranks`` > 1 the batch is that many contiguous shards, one a rank: each
    statistic is each rank's mean, averaged over the ranks (``pmean``).

    The top k come from a stable descending sort, so equal probabilities
    are taken lowest expert first, as ``jax.lax.top_k`` takes them (under
    a uniform router every probability ties, and the order decides which
    tokens overflow an expert's capacity).
    """
    return route_logits(router_logits(p, xg), cfg, xg.dtype, ranks)


def router_logits(p, xg: torch.Tensor) -> torch.Tensor:
    """The f32 router logits (B, nG, S, E') of grouped tokens ``xg`` against
    ``p['router']`` (D, E'): every expert's, or on a model rank its
    expert columns' (the reference's ``router`` cut on ``model``)."""
    return torch.einsum("bgsd,de->bgse", xg.float(), p["router"])


def route_logits(logits: torch.Tensor, cfg, dtype, ranks: int = 1):
    """:func:`_route` from the router's f32 ``logits`` (B, nG, S, E) over
    all experts: the seam the one-axis path and the tensor-parallel one
    (whose model ranks' logits are concatenated in expert order) share, so
    top-k, its ties and the capacity are decided by one code. ``dtype``
    is the tokens' (the dispatch and combine tensors')."""
    B, nG, S, E = logits.shape
    k = cfg.experts_per_token

    probs = torch.softmax(logits, dim=-1)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = vals[..., :k], order[..., :k]               # (B,nG,S,k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    C = _capacity(S, k, E, cfg.capacity_factor)
    onehot_e = _one_hot(expert_idx, E)                                  # (B,nG,S,k,E)
    # position-in-expert: cumulative count over the flattened (S, k) order
    flat = onehot_e.reshape(B, nG, S * k, E)
    pos_in_e = (torch.cumsum(flat, dim=2) - flat).reshape(B, nG, S, k, E)
    pos_in_e = (pos_in_e * onehot_e).sum(dim=-1)                        # (B,nG,S,k)
    keep = pos_in_e < C
    gate_vals = gate_vals * keep.to(gate_vals.dtype)
    onehot_c = _one_hot(pos_in_e.to(torch.int64), C)

    combine = torch.einsum("bgske,bgsk,bgskc->bgsec", onehot_e, gate_vals, onehot_c)
    dispatch = (combine > 0).to(dtype)                                  # (B,nG,S,E,C)
    combine = combine.to(dtype)

    # GShard load-balancing statistics (each a length-E batch mean)
    if ranks == 1:
        me = probs.mean(dim=(0, 1, 2))
        ce = onehot_e.sum(dim=3).mean(dim=(0, 1, 2)) / max(k, 1)
    else:
        me = probs.reshape(ranks, -1, E).mean(dim=1).mean(dim=0)
        ce = (onehot_e.sum(dim=3).reshape(ranks, -1, E).mean(dim=1) / max(k, 1)).mean(dim=0)
    return combine, dispatch, me, ce


def _shared_out(p, x: torch.Tensor) -> torch.Tensor:
    sp = p["shared"]
    hs = F.silu(x @ sp["w_gate"]) * (x @ sp["w_up"])
    return down_proj(hs, sp["w_down"])


def _experts(din: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """SwiGLU of each expert's rows: ``din`` (E, B, nG, C, D) against the
    experts' stacked weights; the output in ``din``'s layout and dtype."""
    h = F.silu(torch.einsum("ebgcd,edf->ebgcf", din, w_gate))
    h = h * torch.einsum("ebgcd,edf->ebgcf", din, w_up)
    return torch.einsum("ebgcf,efd->ebgcd", h, w_down)


def expert_shard_outs(ps: list, dispatch: torch.Tensor, xg: torch.Tensor) -> list:
    """Expert shards (E divides the model ranks): each model rank's experts,
    ``ps[r]`` holding its E / M of them, run on their slice of the expert
    inputs. Returns the ranks' outputs (E / M, B, nG, C, D), in model-rank
    order, which concatenate along E to every expert's."""
    n = ps[0]["w_up"].shape[0]
    return [_experts(torch.einsum("bgsec,bgsd->ebgcd", dispatch[..., r * n:(r + 1) * n, :], xg),
                     p["w_gate"], p["w_up"], p["w_down"]) for r, p in enumerate(ps)]


def ffn_shard_outs(ps: list, expert_in: torch.Tensor) -> list:
    """Expert-FFN shards (E does not divide the model ranks): each model
    rank runs every expert on its slice of the FFN width. Returns the
    ranks' partial outputs (E, B, nG, C, D), which sum to the experts'."""
    return [_experts(expert_in, p["w_gate"], p["w_up"], p["w_down"]) for p in ps]


def group_tokens(x: torch.Tensor, cfg) -> torch.Tensor:
    """``x`` (B, T, D) as dispatch groups (B, nG, S, D) (:func:`_group_size`)."""
    B, T, D = x.shape
    S = _group_size(T, cfg)
    return x.reshape(B, T // S, S, D)


def expert_partition(E: int, n: int) -> tuple[int, ...]:
    """Contiguous expert counts per rank: the first ``E % n`` ranks take one
    extra (E=6, n=4 -> (2, 2, 1, 1)). Ranks beyond E hold zero experts."""
    base, rem = divmod(E, n)
    return tuple(base + (1 if r < rem else 0) for r in range(n))


def moe_ffn(p, x: torch.Tensor, cfg, *, mesh=None, transport=None):
    """x: (B, T, D) -> (out, aux_loss).

    With ``mesh`` set and ``cfg.moe_dispatch == "alltoallv"`` the batch is
    ``mesh.size`` contiguous shards, one a rank (the reference's
    ``P(axis)``; B must divide), and the experts run expert-parallel
    (:func:`_expert_parallel`): their rows travel out and back through
    ``transport``, :func:`repro_torch.comm.palltoallv` by default (with
    its plan's executor; ``functools.partial(palltoallv, compiled=True)``
    or ``inkernel=True`` pins one). The aux loss is then the global-batch
    value (me/ce averaged over the ranks, as ``pmean`` does). Otherwise the
    experts run on the whole batch: the dense einsum formulation."""
    ep = mesh is not None and cfg.moe_dispatch == "alltoallv"
    n = mesh.size if ep else 1
    B, T, D = x.shape
    if B % n:
        raise ValueError(f"expert-parallel dispatch splits the batch over the mesh's {n} "
                         f"ranks; a batch of {B} does not divide")
    E = cfg.num_experts
    xg = group_tokens(x, cfg)

    combine, dispatch, me, ce = _route(p, xg, cfg, ranks=n)

    expert_in = torch.einsum("bgsec,bgsd->ebgcd", dispatch, xg)
    if ep:
        expert_out = _expert_parallel(p, expert_in, n, transport or palltoallv)
    else:
        expert_out = _experts(expert_in, p["w_gate"], p["w_up"], p["w_down"])
    del expert_in
    y = torch.einsum("bgsec,ebgcd->bgsd", combine, expert_out).reshape(B, T, D)

    if "shared" in p:
        y = y + _shared_out(p, x)

    aux = E * torch.sum(me * ce) * cfg.router_aux_coef
    return y, aux


def _expert_parallel(p, expert_in: torch.Tensor, n: int, transport) -> torch.Tensor:
    """The experts' outputs (E, B, nG, C, D) for ``expert_in`` of the same
    shape, whose rows of rank ``r`` are its batch shard ``[r*B/n,
    (r+1)*B/n)`` of dim 1, computed expert-parallel over ``n`` ranks.

    Experts partition contiguously across the ranks
    (:func:`expert_partition`; ragged when n does not divide E). Per expert
    a rank's shard supplies R = B/n * nG * C capacity rows, so the forward
    block matrix is m[s][d] = cnt[d] * R (uniform per destination) and the
    return matrix its transpose: exactly the ragged ``sizes`` of the
    schedule-IR alltoallv. ``transport`` moves them out (padded output) and
    back (padded input).

    On the one card this is the einsum path's arithmetic with the two
    transports in between, not the reference's per-rank programs: the
    caller routes every shard in one call, and every rank's local experts
    run in one batched call (expert ``e`` is slot ``j`` of the rank that
    owns it), on the einsum path's shapes. Per row the arithmetic is the
    same as routing each shard and running each rank's experts alone, but
    GEMMs of other shapes may sum in another order, and in bf16 a near tie
    in the router can then take another expert. A comparison of the two
    dispatches therefore holds the transports and the bookkeeping around
    them, not per-rank GEMM shapes.
    """
    E, B, nG, C, D = expert_in.shape
    R = B // n * nG * C
    cnt = expert_partition(E, n)
    cnt_max = max(cnt)

    # ---- forward transport: rank r's (E, B/n, nG, C, D) flattened
    # expert-major is its destination-major compact layout (experts
    # contiguous per rank). Out as padded (n, n, cnt_max*R, D) blocks: rank
    # r's rows from source s for its cnt[r] local experts live in out[r, s]'s
    # valid prefix.
    send = expert_in.reshape(E, n, R, D).transpose(0, 1).reshape(n, E * R, D)
    din = transport(send, sizes=[c * R for c in cnt], out_padded=True)
    del send
    din = din.reshape(n, n, cnt_max, R, D)

    # ---- local experts: expert e is slot j of rank r; its rows from every
    # source s, (s, b, g, c) in order, are (B, nG, C) as on the einsum path
    owner = [(r, j) for r in range(n) for j in range(cnt[r])]
    rows = torch.stack([din[r, :, j] for r, j in owner]).reshape(E, B, nG, C, D)
    del din
    out = _experts(rows, p["w_gate"], p["w_up"], p["w_down"])
    del rows
    out = out.reshape(E, n, R, D)
    # slot j >= cnt[r] of a rank's padded block stays 0, and the return
    # transport never reads it (the reference computes it against
    # zero-masked weights: silu(0) * 0 = 0)
    eo = out.new_zeros((n, n, cnt_max, R, D))
    e0 = 0
    for r in range(n):
        eo[r, :, :cnt[r]] = out[e0:e0 + cnt[r]].transpose(0, 1)
        e0 += cnt[r]
    del out

    # ---- return transport: the block to source d is eo[r, d]'s valid
    # prefix (cnt[r] local experts), the transposed matrix, padded input;
    # out comes each rank's source-major compact layout, i.e. global expert
    # order
    back = transport(eo.reshape(n, n, cnt_max * R, D), sizes=[[c * R] * n for c in cnt],
                     in_padded=True)
    del eo
    return back.reshape(n, E, R, D).transpose(0, 1).reshape(E, B, nG, C, D)
