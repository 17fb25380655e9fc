"""The tensor-parallel (TP) forward: one data rank's M model ranks serving
or training together, each from its own shard of every weight.

The shards are the reference's TP layout on the model axis: each rank holds
its query and kv heads of ``wq``/``wk``/``wv`` (and the QKV biases), its
rows of ``wo``, its columns of ``w_up``/``w_gate``, its rows of ``w_down``,
its experts (or, when they do not divide, every expert's slice of the FFN
width) and their router columns, and its vocab rows of the embedding; norm
scales are replicated. Serving reads them under ``param_specs(fsdp=False,
attn_fallback='head_dim')``; training gathers them from the FSDP blocks of
``param_specs(fsdp=True, attn_fallback='replicate')``
(:mod:`repro_torch.train.train_step`), which for the families it covers cut
the model axis the same way. The math is the unsharded model's, cut where
GSPMD inserts the reference's model-axis all-reduce or all-gather:

  * the embedding lookup: each rank looks up the tokens of its vocab
    slice, and zero rows for the others (partial rows); in training its
    slice's gradient sums each row's occurrences in f32 and rounds once,
    as the one-axis embedding does (:func:`.layers.row_grad`);
  * attention: each rank attends on its heads, giving a partial of the
    output projection (``layers._out_proj``). Where the kv heads do not
    divide (``attn_fallback='head_dim'``: paligemma's one kv head, and the
    query heads too when they do not divide), each rank projects
    head-width slices, which are gathered into full-width heads, and
    prefill attends on the rank's query heads (all of them when they do
    not divide). Training's ``attn_fallback='replicate'`` leaves such
    projections whole in every shard: the keys and values are projected
    once, each rank's query heads attend over them and the partials are
    summed, or, when the query heads do not divide either, the whole
    attention is computed once;
  * the caches, in one place (:func:`_cut_cache`): prefill computes each
    attention and cross cache once and cuts it over the serving group's
    ('data', 'model') mesh as ``cache_specs`` places it there
    (``shard_slices``), so every (data, model) rank holds exactly its
    block: its kv heads on 'model' when they divide, else the sequence
    (or a cross cache's frames) on 'model' when it divides; for a batch
    that divides no data axis, the sequence on 'data' too where it
    divides (on ('data', 'model') jointly, data-major, over one kv head);
    a block several ranks hold (a cache whole on an axis, ``pos``) is one
    tensor. Decode writes the new token into the one block that owns slot
    ``cur_pos % S``, attends over each block's slots and merges the blocks'
    partials in slot order by their f32 log-sum-exp (flash decoding,
    :func:`merge_shards`): every query head over every block on the
    head-dim split, each rank's heads over its kv heads' blocks (one a
    data rank) on the heads;
  * a decoder block's cross attention to the encoder's keys and values,
    which prefill keeps as its cache: on the rank's heads, or on its
    head-width slices of q, k and v, gathered into full-width heads, when
    the kv heads do not divide (whisper-large-v3's 20 on 8 ranks); in
    training, where they do not divide, as the self-attention's replicated
    projections;
  * the MLP: a partial of ``down_proj`` from each rank's width slice;
  * MoE: the ranks' f32 router logits concatenated in expert order and
    routed by the one-axis code (``moe.route_logits``), the expert shards'
    outputs gathered along the experts, or the expert-FFN shards' partials
    summed; shared experts as the MLP; the router's aux loss over the whole
    batch, summed over the blocks as the one-axis stack sums it;
  * the recurrent mixers, each rank's state its ``cache_specs`` block of
    the one-axis state, kept and updated in place by prefill and every
    decode step, never another rank's: Mamba (a hybrid block's, beside its
    attention) on the rank's channels, which own its conv, dt, scan, skip
    and state; it takes its channels of xb and z from whichever ranks
    projected them, gathers B and C and the conv output, reads A's rows
    for its channels from every rank's ``a_log`` block (cut on N), and
    ``y * silu(z)`` is gathered along the channels for the ranks' ``w_out``
    columns. mLSTM on the rank's key dims of every head (its rows of ``C``
    and ``n``): q and k cut so from the ranks' head-cut projections (a
    piece may hold part of a head: xlstm-350m's 4 heads on 8 ranks), v, g
    and the gates whole (the gates computed once from rank 0's copy where
    ``param_specs`` replicates them); its partial numerator and normalizer
    are summed over the ranks before ``num / (|nq| + 1)``. sLSTM on the rank's slice
    of d (its c, n, h): the prompt's input projection gathered once, then a
    token at a time h gathered, each rank's columns of the head-major
    recurrent mixing gathered, each rank's cell on its slice of the four
    gates. Each output projection's columns are gathered along d;
  * the unembedding: each rank's vocab slice of the f32 logits,
    concatenated in model-rank order.

Partials are summed by :func:`model_axis_sum`, the plain sum over the rank
rows in model-rank order: two runs give the same bits, and pieces are
concatenated by :func:`model_axis_gather`; where a rank needs only its part
of other ranks' pieces it takes that part (:func:`model_axis_take`, the
all-to-all). The sum's backward hands
every rank's partial the whole upstream gradient, GSPMD's model-axis
all-reduce in reverse. The emulation is a loop over the model ranks inside
each layer (all ranks on one device); no rank reads another's shard, and no
layer's full weight is ever assembled. A replicated value (the residual
stream, a norm's output, the gathered heads) is the same on every rank, so
it is computed once, from rank 0's copy of a replicated weight.

Serving covers the decoders over text and over a vision prefix (the
prefix-LM mask, the prefix dropped before the unembedding), the
encoder-decoder (the encoder's blocks through the same TP block,
bidirectional), and the recurrent and hybrid families, with attention, MoE,
mLSTM, sLSTM and hybrid blocks, for any batch: one serving group's
requests (``serve.engine.serving_groups``, as ``batch_specs`` places the
batch) are computed once, on the model ranks of its data coordinate 0, and
its caches are cut over all its ranks; a recurrent state's batch is
replicated over the data axes, so each model rank's is kept once, listed
at every data rank of the group. Training covers the decoders over text
and over a vision prefix and the encoder-decoder, with attention and MoE
blocks, whatever their heads, under training's layout: the train-mode
forward returns the blocks' aux loss beside the logits, and
:func:`tp_loss` is ``Model.loss``'s ``nll + aux``. Everything else on a
model axis (in training the SSM mixers, xlstm-350m's and hymba-1.5b's)
raises a ``ValueError`` naming the ROADMAP item "Tensor-parallel
remainder" (:func:`check_tensor_parallel`).
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from ..dist.hints import hint
from ..dist.sharding import cache_specs, shard_slices
from ..dist.topology import DP_AXES, TP_AXIS
from ..launch.mesh import EmulatedMesh
from . import moe as moe_lib
from . import ssm
from .blocks import attn_spec_for, prefill_cache
from .layers import (
    _fill_cache,
    _out_proj,
    _qkv,
    _sdpa,
    attend,
    attention,
    cross_entropy_loss,
    decode_shard,
    down_proj,
    mlp,
    rms_norm,
    rope,
    row_grad,
    unembed,
)
from .transformer import StackLayout, _apply_stack, _dtype

__all__ = ["TP_REMAINDER", "apply_lm_tp", "check_tensor_parallel", "merge_shards",
           "model_axis_gather", "model_axis_sum", "model_axis_take", "tp_loss"]

TP_REMAINDER = 'ROADMAP item "Tensor-parallel remainder"'


def check_tensor_parallel(cfg, m: int, *, mode: str = "train") -> None:
    """Raise unless ``cfg`` runs on a model axis of ``m`` ranks in ``mode``.

    Both modes: a decoder (over text or a vision prefix) or the
    encoder-decoder whose experts or expert width divide ``m``, whose dense
    and shared-expert MLP widths and padded vocab divide. ``'train'``
    (under ``param_specs(fsdp=True, attn_fallback='replicate')``): any
    attention, an attention projection whose heads do not divide whole in
    every shard; no recurrent mixer (:func:`_block`'s train mode), whose
    families keep the MLP-width reason too. ``'serve'`` (under
    ``attn_fallback='head_dim'``): attention whose query and kv heads, self
    and cross, or else their head width divide ``m``, and recurrent mixers
    cut where the TP mixers read them (:func:`_mixer_cuts`: an mLSTM's
    heads need not divide, its state's key rows must). Any batch serves:
    :func:`apply_lm_tp` cuts each cache as ``cache_specs`` places it on the
    serving group's mesh."""
    if mode not in ("train", "serve"):
        raise ValueError(f"mode {mode!r}: a model axis trains or serves")
    why = []
    kinds = set(cfg.layer_kinds())
    mixers = kinds & set(_MIXERS)
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if mode == "train" and mixers:
        why.append(f"training the SSM mixers ({', '.join(sorted(mixers))} blocks)")
    if mode == "serve":
        why += _mixer_cuts(cfg, m, mixers)
        attends = bool(kinds & {"attn", "moe", "hybrid"}) or cfg.arch_type == "encdec"
        cuts = (_head_cut(H, hd, m), _head_cut(KV, hd, m))
        if attends and None in cuts:
            why.append(f"{H} query and {KV} kv heads of width {hd}, neither dividing")
    E, f = cfg.num_experts, cfg.d_ff
    if "moe" in kinds and E % m and f % m:
        why.append(f"{E} experts of width {f}, neither dividing")
    if "moe" in kinds and cfg.num_shared_experts and (f * cfg.num_shared_experts) % m:
        why.append(f"shared experts of width {f * cfg.num_shared_experts}")
    dense = (bool(kinds & {"attn", "hybrid"}) or cfg.arch_type == "encdec"
             or (mode == "train" and bool(mixers)))
    if dense and (not cfg.d_ff or cfg.d_ff % m):
        why.append(f"an MLP of width {cfg.d_ff}")
    if cfg.padded_vocab % m:
        why.append(f"a padded vocab of {cfg.padded_vocab}")
    if why:
        raise ValueError(f"{cfg.name} on a model axis of {m} ranks: the tensor-parallel "
                         f"forward does not cover {'; '.join(why)} ({TP_REMAINDER})")


def _state_cut(dims, m: int):
    """The dim of a recurrent state's trailing ``dims`` (the batch's left
    out) that ``cache_specs`` puts the model axis on: the widest that
    divides ``m``, the first of equals; None when none does."""
    return next((i for i in sorted(range(len(dims)), key=lambda i: -dims[i])
                 if dims[i] % m == 0), None)


def _mixer_cuts(cfg, m: int, kinds) -> list:
    """Why the recurrent mixers ``kinds`` of ``cfg`` do not serve on ``m``
    model ranks: each TP mixer reads its leaves cut on their last dim
    (``param_specs``' rule for them) and keeps its states cut on the dim
    that ``cache_specs`` picks: mLSTM's ``C`` and ``n`` on the key dim, sLSTM's
    c, n, h on d, Mamba's ``h`` and ``conv`` on the channels."""
    why = []
    d, H = cfg.d_model, cfg.num_heads
    di = cfg.ssm_expand * d
    if "mlstm" in kinds:
        hd = di // H
        if (di % m or hd % m or d % m or _state_cut((H, hd, hd), m) != 1
                or _state_cut((H, hd), m) != 1):
            why.append(f"an mLSTM of {H} heads of {hd} (its state cut off the key dim)")
    if "slstm" in kinds and (d % m or (4 * d // H) % m):
        why.append(f"an sLSTM of width {d} over {H} heads")
    if "hybrid" in kinds:
        N, W = cfg.ssm_state, cfg.ssm_conv
        if (di % m or N % m or d % m or _state_cut((di, N), m) != 0
                or _state_cut((W - 1, di), m) != 1):
            why.append(f"a Mamba of {di} channels and state {N}")
    return why


def model_axis_sum(parts: list) -> torch.Tensor:
    """The model-axis sum of the ranks' partials: the port's plain sum over
    the rank rows, in model-rank order (the counterpart of the reference's
    GSPMD all-reduce)."""
    return torch.stack(parts).sum(0)


def model_axis_gather(parts, dim: int) -> torch.Tensor:
    """The model-axis all-gather of the ranks' pieces: concatenated along
    ``dim`` in model-rank order (the counterpart of the reference's GSPMD
    all-gather)."""
    return torch.cat(list(parts), dim=dim)


def model_axis_take(parts, dim: int, spans, fn=None) -> torch.Tensor:
    """The model-axis all-to-all: of the whole that the ranks' pieces
    ``parts`` form concatenated along ``dim`` in model-rank order, the
    ``(start, stop)`` ranges ``spans``, concatenated in their order, each
    read from the pieces that hold it: the whole is never assembled (the
    counterpart of the all-to-all GSPMD inserts where a rank needs only its
    part of another rank's piece). ``fn``, an element-wise function, is
    applied to each view read, before the concatenation, as the one-axis
    code applies it to the same view of its whole."""
    n = parts[0].shape[dim]
    out = []
    for a, b in spans:
        while a < b:
            r = a // n
            e = min(b, (r + 1) * n)
            piece = parts[r].narrow(dim, a - r * n, e - a)
            out.append(piece if fn is None else fn(piece))
            a = e
    return torch.cat(out, dim=dim)


class _ShardRowGather(torch.autograd.Function):
    """Rank ``rank``'s partial rows of ``tokens`` from its vocab slice
    ``table``: the rows of the tokens in the slice, zero rows for the
    others. The backward is the one-axis ``_RowGather``'s restricted to
    the slice: the occurrences outside it are dropped, each row's
    gradients summed in f32 in the order they come and rounded once."""

    @staticmethod
    def forward(ctx, table, tokens, rank):
        local = tokens - rank * table.shape[0]
        mine = (local >= 0) & (local < table.shape[0])
        ctx.save_for_backward(local, mine)
        ctx.table_shape, ctx.table_dtype = table.shape, table.dtype
        rows = table[torch.where(mine, local, 0)]
        return torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                              device=rows.device))

    @staticmethod
    def backward(ctx, grad):
        local, mine = ctx.saved_tensors
        keep = mine.reshape(-1)
        return row_grad(local.reshape(-1)[keep], grad.reshape(-1, grad.shape[-1])[keep],
                        ctx.table_shape, ctx.table_dtype), None, None


def _embed_shard(table: torch.Tensor, tokens: torch.Tensor, rank: int) -> torch.Tensor:
    """Rank ``rank``'s partial rows: its vocab slice's rows of the tokens
    in it, zero rows for the others (:class:`_ShardRowGather`)."""
    return _ShardRowGather.apply(table, tokens, rank)


def _head_cut(heads: int, hd: int, m: int) -> str | None:
    """Where ``param_specs(attn_fallback='head_dim')`` cuts an attention
    projection over ``m`` model ranks: its heads when they divide, else its
    head width when that divides, else nowhere (replicated)."""
    if heads % m == 0:
        return "heads"
    return "head_dim" if hd % m == 0 else None


def merge_shards(parts: list) -> torch.Tensor:
    """The flash-decoding merge of the cache shards' ``(out, lse)`` pairs
    (:func:`.layers.decode_shard`, in model-rank order): ``sum_r exp(lse_r -
    lse) out_r`` with ``lse = logsumexp_r lse_r``, in f32. A shard with no
    valid slot (lse -inf, out 0) adds exactly nothing."""
    lse = torch.logsumexp(torch.stack([l for _, l in parts]), dim=0)
    lse = torch.where(torch.isfinite(lse), lse, 0.0)
    return model_axis_sum([torch.exp(l - lse)[..., None] * o for o, l in parts])


def _heads_kv(k, v, r: int, hq: int, group: int):
    """The kv heads that rank ``r``'s query heads ``[r hq, (r+1) hq)`` read
    (query head ``h`` reads kv head ``h // group``), as a (k, v) pair GQA
    maps them onto: a slice of kv heads when the rank's heads fill whole
    groups or share one, else every query head's kv head repeated."""
    if hq % group == 0 or group % hq == 0:
        k0 = r * hq // group
        k1 = k0 + max(1, hq // group)
        return k[:, :, k0:k1], v[:, :, k0:k1]
    pick = lambda t: t.repeat_interleave(group, dim=2)[:, :, r * hq:(r + 1) * hq]  # noqa: E731
    return pick(k), pick(v)


def one_data_rank(m: int) -> EmulatedMesh:
    """The ('data', 'model') mesh of one data rank's ``m`` model ranks: the
    serving group of :func:`apply_lm_tp` called without ``cache_mesh``
    (only its axes and shape are read)."""
    return EmulatedMesh((1, m), torch.device("meta"), (DP_AXES[-1], TP_AXIS))


@functools.lru_cache(maxsize=None)
def _cache_blocks(shape: tuple, mesh) -> tuple:
    """Each rank of ``mesh``'s block of an attention or cross cache whose
    ``k``/``v`` are ``shape`` (B, S, KV, hd): ``(its slices of k and v, of
    pos (S,))`` a rank, as ``cache_specs`` places the cache on ``mesh``."""
    specs = cache_specs({"k": torch.empty(shape, device="meta"),
                         "pos": torch.empty(shape[1:2], device="meta")}, mesh, None)
    return tuple((shard_slices(specs["k"], shape, mesh, r),
                  shard_slices(specs["pos"], shape[1:2], mesh, r)) for r in range(mesh.size))


def _block_of(pieces: list, sl: tuple, dim: int) -> torch.Tensor:
    """The block ``sl`` (a slice a dim) of the whole that ``pieces`` form
    concatenated along ``dim``, read from the one piece that holds it (the
    whole is never assembled): the piece itself when the block is all of
    it, else a copy of its part."""
    j, lo = divmod(sl[dim].start, pieces[0].shape[dim])
    piece = pieces[j]
    local = sl[:dim] + (slice(lo, lo + sl[dim].stop - sl[dim].start),) + sl[dim + 1:]
    if all(s.start == 0 and s.stop == n for s, n in zip(local, piece.shape)):
        return piece
    return piece[local].clone(memory_format=torch.contiguous_format)


def _cut_cache(cache, mesh) -> list:
    """An attention or cross cache cut over the ranks of ``mesh`` (a
    serving group's ('data', 'model') mesh, ranks data-major; an int M: one
    data rank's M model ranks) as ``cache_specs`` places it: rank ``r``'s
    dict holds its block of ``k`` and ``v`` and the replicated ``pos``.
    ``cache`` is the whole cache, or the model ranks' caches of their kv
    heads in model-rank order (the spec then cuts the kv heads on 'model').
    A block that several ranks hold (a cache whole on an axis, ``pos``) is
    one tensor, held once."""
    if isinstance(mesh, int):
        mesh = one_data_rank(mesh)
    parts = cache if isinstance(cache, list) else [cache]
    shape = list(parts[0]["k"].shape)
    shape[2] *= len(parts)
    held, out = {}, []
    for kv_sl, pos_sl in _cache_blocks(tuple(shape), mesh):
        block = {}
        for key in parts[0]:
            sl = pos_sl if key == "pos" else kv_sl
            tag = (key,) + tuple((s.start, s.stop) for s in sl)
            if tag not in held:
                pieces = [parts[0][key]] if key == "pos" else [p[key] for p in parts]
                held[tag] = _block_of(pieces, sl, 0 if key == "pos" else 2)
            block[key] = held[tag]
        out.append(block)
    return out


def _distinct(caches: list) -> list:
    """The caches of ``caches`` (the ranks' blocks of one cache, in rank
    order) that hold distinct blocks: a block held once is listed at every
    rank that holds it, and read once. In rank order they are in slot
    order."""
    seen, out = set(), []
    for c in caches:
        if c["k"].data_ptr() not in seen:
            seen.add(c["k"].data_ptr())
            out.append(c)
    return out


def _decode_over_shards(q: torch.Tensor, caches: list, valid: torch.Tensor) -> torch.Tensor:
    """Decode attention of the query heads ``q`` (B, 1, H, hd) over the
    ranks' blocks ``caches`` of one cache, cut on the sequence as
    :func:`_cut_cache` cuts it, ``valid`` (S,) the slots that hold a key:
    over each distinct block's slots, the blocks' partials merged in slot
    order (:func:`merge_shards`), or over the whole cache once when one
    block holds it. Returns f32 (B, 1, H, hd)."""
    blocks = _distinct(caches)
    if len(blocks) == 1:
        return decode_shard(q, blocks[0]["k"], blocks[0]["v"], valid)[0]
    n = blocks[0]["k"].shape[1]
    return merge_shards([decode_shard(q, c["k"], c["v"], valid[i * n:(i + 1) * n])
                         for i, c in enumerate(blocks)])


def _write_token(caches: list, k: torch.Tensor, v: torch.Tensor, cur_pos: int) -> None:
    """Decode's new token: its ``k``/``v`` (B, 1, KV, hd) into the one block
    of ``caches`` that owns slot ``cur_pos % S``, and ``cur_pos`` into the
    replicated ``pos`` (once each, however many ranks hold them)."""
    blocks = _distinct(caches)
    S, n = caches[0]["pos"].shape[0], blocks[0]["k"].shape[1]
    slot = cur_pos % S
    c = blocks[slot // n]
    c["k"][:, slot % n] = k[:, 0].to(c["k"].dtype)
    c["v"][:, slot % n] = v[:, 0].to(c["v"].dtype)
    for pos in {c["pos"].data_ptr(): c["pos"] for c in caches}.values():
        pos[slot] = cur_pos


def _valid(cache: dict, cur_pos: int, spec) -> torch.Tensor:
    """The slots of a cache's ``pos`` that decode at ``cur_pos`` attends."""
    valid = cache["pos"] >= 0
    if spec.window is not None:
        valid = valid & (cache["pos"] > cur_pos - spec.window)
    return valid


def _fallback_attention(ps: list, h: torch.Tensor, cfg, spec, *, mode: str, caches, cur_pos,
                        max_len: int, prefix_len: int, mesh):
    """Attention under ``attn_fallback='head_dim'`` (the kv heads, and maybe
    the query heads, do not divide the model ranks): each rank projects its
    head-width slices (``wk``/``wv``, and ``wq`` when the query heads do not
    divide), which are gathered along the head width into full-width heads.

    Train and prefill: each rank attends with its own query heads, or, when
    they do not divide, all of them (computed once: every rank's inputs are
    the same), and takes its part of the output for its block of ``wo``;
    prefill cuts the full-width cache over the group's ranks ``mesh``
    (:func:`_cut_cache`: the sequence on 'model', on 'data' or on both when
    they divide it, else whole). Decode: the new token's k/v go into the
    block that owns slot ``cur_pos % S`` (:func:`_write_token`), all query
    heads attend over each block's slots (:func:`.layers.decode_shard`) and
    the partials are merged in (data, model) rank order
    (:func:`merge_shards`). Returns (the model-axis sum of the ranks'
    output-projection partials, the ranks' attention caches)."""
    m = len(ps)
    H, KV, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim
    q_cut = _head_cut(H, hd, m)
    qs, ks, vs = zip(*(_qkv(p["attn"], spec, h) for p in ps))
    k, v = model_axis_gather(ks, -1), model_axis_gather(vs, -1)
    B, T = h.shape[:2]
    if mode == "decode":
        pos = torch.full((B, 1), cur_pos, dtype=torch.int32, device=h.device)
    else:
        pos = torch.arange(T, device=h.device)[None, :]
    rot = (lambda t: rope(t, pos, spec.rope_theta)) if spec.use_rope else (lambda t: t)
    k = rot(k)
    if mode == "decode":
        q = rot(model_axis_gather(qs, 2 if q_cut == "heads" else -1))
        _write_token(caches, k, v, cur_pos)
        out = _decode_over_shards(q, caches, _valid(caches[0], cur_pos, spec)).to(q.dtype)
        outs = out.chunk(m, dim=2 if q_cut == "heads" else -1)
    elif q_cut == "heads":
        hq = H // m
        outs = [attend(rot(qr), *_heads_kv(k, v, r, hq, H // KV), spec, mode=mode,
                       prefix_len=prefix_len) for r, qr in enumerate(qs)]
    else:
        out = attend(rot(model_axis_gather(qs, -1)), k, v, spec, mode=mode,
                     prefix_len=prefix_len)
        outs = out.chunk(m, dim=-1)
    y = model_axis_sum([_out_proj(o, p["attn"]["wo"]) for o, p in zip(outs, ps)])
    if mode == "prefill":
        caches = _cut_cache(prefill_cache(_fill_cache(k, v, spec, T), max_len, spec, cfg), mesh)
    return y, (None if mode == "train" else caches)


def _decode_heads(p, h: torch.Tensor, spec, blocks: list, cur_pos: int) -> torch.Tensor:
    """Decode on one model rank's heads (``spec`` cut to them) over its kv
    heads' blocks ``blocks``, one a data rank (the cache's sequence on
    'data'): the new token into the block that owns its slot, the partials
    of each block's slots merged in data-rank order. Returns the rank's
    output-projection partial."""
    q, k, v = _qkv(p, spec, h)
    if spec.use_rope:
        pos = torch.full((h.shape[0], 1), cur_pos, dtype=torch.int32, device=h.device)
        q, k = rope(q, pos, spec.rope_theta), rope(k, pos, spec.rope_theta)
    _write_token(blocks, k, v, cur_pos)
    out = _decode_over_shards(q, blocks, _valid(blocks[0], cur_pos, spec))
    return _out_proj(out.to(q.dtype), p["wo"])


def _self_attention(ps: list, h: torch.Tensor, cfg, spec, *, mode: str, caches, cur_pos,
                    max_len: int, prefix_len: int, mesh):
    """The block's self-attention over the model ranks: on each rank's heads
    when the heads and kv heads divide, else :func:`_fallback_attention`
    (serving's head-dim split) or :func:`_replicated_attention` (training's
    whole projections).
    On the heads, prefill cuts the model ranks' caches of their kv heads
    over the group's ranks ``mesh`` (:func:`_cut_cache`: the sequence on
    'data' too when the group spans data ranks and it divides), and decode
    runs each rank's heads over its kv heads' blocks: through
    ``layers.attention`` when one block holds its whole sequence, else
    :func:`_decode_heads`. Returns (the summed output, the ranks' attention
    caches, None in train mode)."""
    m = len(ps)
    if _replicated([p["attn"] for p in ps], spec):
        return _replicated_attention([p["attn"] for p in ps], h, spec,
                                     prefix_len=prefix_len), None
    if _head_cut(spec.num_kv_heads, spec.head_dim, m) != "heads":
        return _fallback_attention(ps, h, cfg, spec, mode=mode, caches=caches, cur_pos=cur_pos,
                                   max_len=max_len, prefix_len=prefix_len, mesh=mesh)
    spec = dataclasses.replace(spec, num_heads=spec.num_heads // m,
                               num_kv_heads=spec.num_kv_heads // m)
    ys, out = [], []
    for r, p in enumerate(ps):
        if mode == "decode" and len(_distinct(caches[r::m])) > 1:
            ys.append(_decode_heads(p["attn"], h, spec, caches[r::m], cur_pos))
            continue
        y, ac = attention(p["attn"], h, spec, mode=mode, cur_pos=cur_pos, prefix_len=prefix_len,
                          cache=None if caches is None else caches[r])
        ys.append(y)
        if mode == "prefill":
            out.append(prefill_cache(ac, max_len, spec, cfg))
    if mode == "prefill":
        caches = _cut_cache(out, mesh)
    return model_axis_sum(ys), (None if mode == "train" else caches)


def _cross_proj(p, x: torch.Tensor, name: str) -> torch.Tensor:
    """A model rank's heads or head-width slices of the cross attention's
    ``name`` ('q', 'k' or 'v') projection of ``x``, its bias added; also
    the projections of a training attention that ``attn_fallback=
    'replicate'`` leaves whole (:func:`_replicated_attention`)."""
    y = torch.einsum("btd,dhk->bthk", x, p["w" + name])
    return y + p["b" + name] if "b" + name in p else y


def _replicated(ps: list, spec) -> bool:
    """Whether the attention shards ``ps`` hold ``wk``/``wv`` whole: the kv
    heads do not divide the model ranks and training's
    ``attn_fallback='replicate'`` leaves the projections uncut (the
    head-dim split cuts their head width)."""
    return (_head_cut(spec.num_kv_heads, spec.head_dim, len(ps)) != "heads"
            and ps[0]["wk"].shape[-1] == spec.head_dim)


def _replicated_attention(ps: list, h: torch.Tensor, spec, *, prefix_len: int = 0,
                          kv_inputs=None) -> torch.Tensor:
    """Training's attention under ``attn_fallback='replicate'`` (the kv heads
    do not divide the model ranks ``ps``, each a rank's attention or cross
    attention leaves): ``wk``/``wv`` are whole in every shard, so the keys and
    values are projected once, from rank 0's copy. When the query heads
    divide, each rank attends with its own query heads (its ``wq`` heads)
    over the kv heads they read and the output projections' partials are
    summed; when they do not, ``wq`` and ``wo`` are whole too and the whole
    attention is computed once, from rank 0's, with no sum. ``kv_inputs``,
    the encoder's normed output, makes it a cross attention: no rotation,
    no mask. A replicated leaf is one tensor in every shard, so its
    gradient is the sum of the ranks' uses."""
    m, p0 = len(ps), ps[0]
    src = h if kv_inputs is None else kv_inputs
    k, v = _cross_proj(p0, src, "k"), _cross_proj(p0, src, "v")
    T = h.shape[1]
    rot = lambda t: t  # noqa: E731
    if kv_inputs is None and spec.use_rope:
        pos = torch.arange(T, device=h.device)[None, :]
        rot = lambda t: rope(t, pos, spec.rope_theta)  # noqa: E731
        k = rot(k)

    def attend_heads(q, kr, vr):
        if kv_inputs is not None:
            mask = torch.ones((1, T, kr.shape[1]), dtype=torch.bool, device=h.device)
            return _sdpa(q, kr, vr, mask, spec)
        return attend(rot(q), kr, vr, spec, mode="train", prefix_len=prefix_len)

    if p0["wq"].shape[-2] == spec.num_heads:  # every projection whole
        return _out_proj(attend_heads(_cross_proj(p0, h, "q"), k, v), p0["wo"])
    hq, group = spec.num_heads // m, spec.num_heads // spec.num_kv_heads
    return model_axis_sum([_out_proj(attend_heads(_cross_proj(p, h, "q"),
                                                  *_heads_kv(k, v, r, hq, group)), p["wo"])
                           for r, p in enumerate(ps)])


def _attend_frames(q: torch.Tensor, caches: list, spec) -> torch.Tensor:
    """Cross attention of ``q`` (B, T, H, hd) over every frame of the
    ranks' blocks ``caches`` of the cross keys and values, no mask: over the
    one block that holds them all as the one-axis cross attention attends
    (``_sdpa``), else each block's partial merged in rank order. Returns
    q's dtype."""
    blocks = _distinct(caches)
    frames = sum(c["k"].shape[1] for c in blocks)
    if len(blocks) == 1:
        mask = torch.ones((1, q.shape[1], frames), dtype=torch.bool, device=q.device)
        return _sdpa(q, blocks[0]["k"], blocks[0]["v"], mask, spec)
    valid = torch.ones(frames, dtype=torch.bool, device=q.device)
    return _decode_over_shards(q, blocks, valid).to(q.dtype)


def _cross_attention(ps: list, h: torch.Tensor, cross_inputs, spec, *, mode: str, caches, mesh):
    """A decoder block's cross attention over the model ranks. Train and
    prefill project the encoder's normed output ``cross_inputs`` to keys
    and values, which prefill cuts over the group's ranks ``mesh`` as its
    cross cache (:func:`_cut_cache`: the kv heads on 'model' when they
    divide, the frames on 'model' when they do not and the frames divide,
    on 'data' when the group spans data ranks and they divide, else
    whole); decode reads the blocks from ``caches`` and hands them back, the
    same tensors. On each rank's heads when the kv heads divide (through
    ``layers.attention`` when one block holds a rank's frames); else, under
    ``attn_fallback='head_dim'``, each rank projects its head-width slices
    of q, k and v, gathered into full-width heads, and takes its slice of
    the output for its rows of ``wo``; in training, under
    ``attn_fallback='replicate'``, :func:`_replicated_attention`. Decode
    over blocks of the frames merges each block's partial
    (:func:`_attend_frames`). Returns (the summed output, the ranks' cross
    caches)."""
    m = len(ps)
    cps = [p["cross"] for p in ps]
    H, KV, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim
    if _replicated(cps, spec):
        return _replicated_attention(cps, h, spec, kv_inputs=cross_inputs), None
    if _head_cut(KV, hd, m) == "heads":
        spec = dataclasses.replace(spec, num_heads=H // m, num_kv_heads=KV // m)
        ys, out = [], []
        for r, cp in enumerate(cps):
            if mode == "decode":
                mine = caches[r::m]
                if len(_distinct(mine)) > 1:
                    ys.append(_out_proj(_attend_frames(_cross_proj(cp, h, "q"), mine, spec),
                                        cp["wo"]))
                    continue
                cc = mine[0]
            else:
                cc = {"k": _cross_proj(cp, cross_inputs, "k"),
                      "v": _cross_proj(cp, cross_inputs, "v")}
                out.append(cc)
            ys.append(attention(cp, h, spec, cross_kv=(cc["k"], cc["v"]))[0])
        if mode == "prefill":
            caches = _cut_cache(out, mesh)
        return model_axis_sum(ys), caches
    q_dim = 2 if _head_cut(H, hd, m) == "heads" else -1
    q = model_axis_gather([_cross_proj(cp, h, "q") for cp in cps], q_dim)
    if mode == "decode":
        out = _attend_frames(q, caches, spec)
    else:
        whole = {key: model_axis_gather([_cross_proj(cp, cross_inputs, key) for cp in cps], -1)
                 for key in ("k", "v")}
        out = _attend_frames(q, [whole], spec)
        if mode == "prefill":
            caches = _cut_cache(whole, mesh)
    y = model_axis_sum([_out_proj(o, cp["wo"]) for o, cp in zip(out.chunk(m, dim=q_dim), cps)])
    return y, caches


def _moe(ps: list, h: torch.Tensor, cfg):
    """The MoE FFN over the model ranks' shards (``moe_ffn``'s einsum
    dispatch): the ranks' f32 router logits concatenated in expert order
    (the router replicated when E does not divide: one rank's), routed by
    ``moe.route_logits``; the experts run as expert shards, their outputs
    gathered along E, or as expert-FFN shards, their partials summed; the
    shared experts by the dense-MLP rule. Returns (out, aux)."""
    E = cfg.num_experts
    xg = moe_lib.group_tokens(h, cfg)
    mps = [p["moe"] for p in ps]
    if mps[0]["router"].shape[-1] == E:
        logits = moe_lib.router_logits(mps[0], xg)
    else:
        logits = model_axis_gather([moe_lib.router_logits(p, xg) for p in mps], -1)
    combine, dispatch, me, ce = moe_lib.route_logits(logits, cfg, xg.dtype)
    if E % len(ps) == 0:
        expert_out = model_axis_gather(moe_lib.expert_shard_outs(mps, dispatch, xg), 0)
    else:
        expert_in = torch.einsum("bgsec,bgsd->ebgcd", dispatch, xg)
        expert_out = model_axis_sum(moe_lib.ffn_shard_outs(mps, expert_in))
    y = torch.einsum("bgsec,ebgcd->bgsd", combine, expert_out).reshape(h.shape)
    if "shared" in mps[0]:
        y = y + model_axis_sum([moe_lib._shared_out(p, h) for p in mps])
    return y, E * torch.sum(me * ce) * cfg.router_aux_coef


# --------------------------------------------------------------------------
# the recurrent mixers: each rank's state its cache_specs block, in place
# --------------------------------------------------------------------------


def _mlstm_proj(p, x: torch.Tensor):
    """A model rank's mLSTM projections from its blocks: its columns of q,
    k, v and g."""
    return x @ p["wq"], x @ p["wk"], x @ p["wv"], x @ p["wg"]


def _mlstm_gates(p, x: torch.Tensor):
    """The f32 input and forget gates' logits of ``p``'s columns of ``wi``
    and ``wf``."""
    xf = x.float()
    return xf @ p["wi"], xf @ p["wf"]


def _mlstm_tp(ps: list, x: torch.Tensor, cfg, *, mode: str, caches):
    """The mLSTM over the model ranks, each rank's state (``C`` (B, H, hd /
    M, hd), ``n`` (B, H, hd / M)) its key rows of every head: rank ``r``
    takes its key dims of every head of q and k from the ranks' head-cut
    projections (:func:`model_axis_take`; a piece may hold part of a head
    when H does not divide M), v, g and the gates whole (the gates' logits
    gathered from the ranks' columns, or, when H does not divide and
    ``param_specs`` replicates ``wi``/``wf``, computed once from rank 0's
    copy), and computes its partial numerator and normalizer (linear in its
    key slice); the partials are summed before ``num / (|nq| + 1)``, whose
    abs is not linear. Each rank carries its own rows. The output ``g * h``
    goes through each rank's ``wo`` columns, gathered along d. Returns (y,
    the ranks' states: prefill's new ones, decode's written in place)."""
    m = len(ps)
    B, T, d = x.shape
    H = cfg.num_heads
    di = cfg.ssm_expand * d
    hd = di // H
    kd = hd // m
    qs, ks, vs, gs = zip(*(_mlstm_proj(p["ssm"], x) for p in ps))
    keys = [[(h * hd + r * kd, h * hd + (r + 1) * kd) for h in range(H)] for r in range(m)]
    q = [model_axis_take(qs, -1, sp).reshape(B, T, H, kd) * hd**-0.5 for sp in keys]
    k = [model_axis_take(ks, -1, sp).reshape(B, T, H, kd) * hd**-0.5 for sp in keys]
    v = model_axis_gather(vs, -1).reshape(B, T, H, hd)
    g = torch.sigmoid(model_axis_gather(gs, -1))
    if ps[0]["ssm"]["wi"].shape[-1] == H:  # replicated: one rank's
        li, lf = _mlstm_gates(ps[0]["ssm"], x)
    else:
        li, lf = (model_axis_gather(t, -1) for t in zip(*(_mlstm_gates(p["ssm"], x)
                                                          for p in ps)))
    lf = F.logsigmoid(lf + ps[0]["ssm"]["bf"])  # (B,T,H)
    li = F.logsigmoid(li)
    if mode == "decode":
        states = [c["ssm"] for c in caches]
        vf = v[:, 0].reshape(B, H, hd).float()
        f = torch.exp(lf[:, 0])[..., None]  # (B,H,1)
        i = torch.exp(li[:, 0])[..., None]
        nums, nqs = [], []
        for qr, kr, st in zip(q, k, states):
            num, nq, C, n = ssm._mlstm_step_partial(qr[:, 0].reshape(B, H, kd).float(),
                                                    kr[:, 0].reshape(B, H, kd).float(), vf, f,
                                                    i, st["C"], st["n"])
            st["C"].copy_(C)
            st["n"].copy_(n)
            nums.append(num)
            nqs.append(nq)
        h = ssm._mlstm_normalize(model_axis_sum(nums), model_axis_sum(nqs))
        h = h.reshape(B, 1, di).to(x.dtype)
    else:
        L = ssm._pick_chunk(T, cfg.ssm_chunk)
        Cs = [torch.zeros((B, H, kd, hd), dtype=torch.float32, device=x.device) for _ in ps]
        ns = [torch.zeros((B, H, kd), dtype=torch.float32, device=x.device) for _ in ps]
        causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
        hs = torch.empty((B, T, H, hd), dtype=torch.float32, device=x.device)
        for c0 in range(0, T, L):
            vf = v[:, c0:c0 + L].transpose(1, 2).float()
            qf = [a[:, c0:c0 + L].transpose(1, 2).float() for a in q]
            kf = [a[:, c0:c0 + L].transpose(1, 2).float() for a in k]
            lii = li[:, c0:c0 + L].transpose(1, 2)  # (B,H,L)
            Fc, eF, E = ssm._mlstm_decay(lf[:, c0:c0 + L].transpose(1, 2), lii, causal)
            nums, nqs = zip(*(ssm._mlstm_partial(qr, kr, vf, eF, E, C, n)
                              for qr, kr, C, n in zip(qf, kf, Cs, ns)))
            hs[:, c0:c0 + L] = ssm._mlstm_normalize(model_axis_sum(nums),
                                                    model_axis_sum(nqs)).transpose(1, 2)
            Cs, ns = zip(*(ssm._mlstm_carry(kr, vf, Fc, lii, C, n)
                           for kr, C, n in zip(kf, Cs, ns)))
        h = hs.reshape(B, T, di).to(x.dtype)
        states = [{"C": C, "n": n} for C, n in zip(Cs, ns)]
    gh = g * h
    return model_axis_gather([down_proj(gh, p["ssm"]["wo"]) for p in ps], -1), states


def _slstm_in(p, x: torch.Tensor) -> torch.Tensor:
    """A model rank's columns of the sLSTM's f32 input projection."""
    return x.float() @ p["w"]


def _slstm_rec(p, hr: torch.Tensor) -> torch.Tensor:
    """A model rank's columns of every head's recurrent mixing of the whole
    ``hr`` (B, H, hd): (B, H, its 4 hd / M columns)."""
    return torch.einsum("bhk,hkm->bhm", hr, p["r"])


def _slstm_tp(ps: list, x: torch.Tensor, cfg, *, mode: str, caches):
    """The sLSTM over the model ranks, each rank's state (c, n, h) its
    d-slice: the prompt's input projection once, each rank's columns
    gathered to (B, T, 4d) f32; then a token at a time, ``h`` gathered from
    the ranks' slices, each rank's columns of ``r`` mixing it, gathered to
    (B, 4d) in the head-major layout, and each rank's cell on its slice of
    z, i, f and o. The ``h`` sequence goes through each rank's ``wo_r``
    columns, gathered along d. Returns (y, the ranks' states)."""
    m = len(ps)
    B, T, d = x.shape
    H = cfg.num_heads
    dm = d // m
    if mode == "decode":
        states = [c["ssm"] for c in caches]
        carry = [(st["c"], st["n"], st["h"]) for st in states]
        xp = model_axis_gather([_slstm_in(p["ssm"], x[:, 0]) for p in ps], -1)[:, None]
    else:
        carry = [tuple(torch.zeros((B, dm), dtype=torch.float32, device=x.device)
                       for _ in range(3)) for _ in ps]
        xp = model_axis_gather([_slstm_in(p["ssm"], x) for p in ps], -1)  # (B,T,4d)
    h = model_axis_gather([c[2] for c in carry], -1)
    hs = []
    for t in range(T):
        hr = h.reshape(-1, H, d // H)
        rec = model_axis_gather([_slstm_rec(p["ssm"], hr) for p in ps], -1).reshape(-1, 4 * d)
        pre = (xp[:, t] + rec + ps[0]["ssm"]["b"]).reshape(-1, 4, d)
        carry = [ssm._slstm_update(*pre[:, :, r * dm:(r + 1) * dm].unbind(1), c, n)
                 for r, (c, n, _) in enumerate(carry)]
        h = model_axis_gather([c[2] for c in carry], -1)
        hs.append(h)
    y = torch.stack(hs, dim=1).to(x.dtype)
    if mode == "decode":
        for st, new in zip(states, carry):
            for key, t in zip(("c", "n", "h"), new):
                st[key].copy_(t)
    else:
        states = [dict(zip(("c", "n", "h"), c)) for c in carry]
    return model_axis_gather([down_proj(y, p["ssm"]["wo_r"]) for p in ps], -1), states


def _mamba_in(p, x: torch.Tensor) -> torch.Tensor:
    """A model rank's columns of Mamba's input projection (of xb | z)."""
    return x @ p["w_in"]


def _mamba_xproj(p, xc: torch.Tensor):
    """A model rank's columns of dt's and of B/C's projections of the
    gathered f32 conv output ``xc``."""
    return xc @ p["w_dt"], xc @ p["w_bc"]


def _a_rows(blocks: list, lo: int, hi: int) -> torch.Tensor:
    """A's rows ``[lo, hi)`` (a rank's channels, every N): each rank's
    ``a_log`` block (di, N / M) read for those rows only, gathered along N;
    the (di, N) leaf is never assembled."""
    return -torch.exp(model_axis_gather([a[lo:hi] for a in blocks], -1))


def _mamba_tp(ps: list, x: torch.Tensor, cfg, *, mode: str, caches):
    """Mamba over the model ranks, rank ``r`` owning channels ``[r di / M,
    (r+1) di / M)``, its state (``h`` (B, di / M, N), ``conv`` (B, W-1, di /
    M)) theirs: it takes its channels of xb and z from whichever ranks
    projected them (:func:`model_axis_take`), runs its conv, its columns of
    dt over the gathered conv output, B and C gathered whole, A's rows
    (:func:`_a_rows`), the scan and the skip on its channels; ``y *
    silu(z)`` is gathered along the channels, each rank's ``w_out`` columns
    gathered along d. Returns (y, the ranks' states)."""
    m = len(ps)
    B, T, d = x.shape
    di, N = cfg.ssm_expand * d, cfg.ssm_state
    chans = [(r * di // m, (r + 1) * di // m) for r in range(m)]
    us = [_mamba_in(p["ssm"], x) for p in ps]
    states = [c["ssm"] for c in caches] if mode == "decode" else None
    convs = [ssm._mamba_conv(p["ssm"], model_axis_take(us, -1, [c]).float(),
                             None if states is None else states[r]["conv"])
             for r, (p, c) in enumerate(zip(ps, chans))]
    xc = model_axis_gather([c[0] for c in convs], -1)
    dts, bcs = zip(*(_mamba_xproj(p["ssm"], xc) for p in ps))
    Bm, Cm = torch.chunk(model_axis_gather(bcs, -1), 2, dim=-1)  # (B,T,N)
    blocks = [p["ssm"]["a_log"] for p in ps]
    ys, new = [], []
    for r, (p, (lo, hi)) in enumerate(zip(ps, chans)):
        pr, (xr, conv) = p["ssm"], convs[r]
        dt = ssm._softplus(dts[r] + pr["b_dt"][lo:hi])
        A = _a_rows(blocks, lo, hi)
        if mode == "decode":
            y, h = ssm._mamba_step_scan(dt, xr, Bm, Cm, A, states[r]["h"])
            y = (y + pr["d_skip"][lo:hi] * xr[:, 0])[:, None]
            states[r]["h"].copy_(h)
            states[r]["conv"].copy_(conv)
        else:
            h = torch.zeros((B, hi - lo, N), dtype=torch.float32, device=x.device)
            y, h = ssm._mamba_scan(dt, xr, Bm, Cm, A, h, ssm._pick_chunk(T, cfg.ssm_chunk))
            y = y + pr["d_skip"][lo:hi] * xr
            new.append({"h": h, "conv": conv})
        ys.append(y.to(x.dtype) * model_axis_take(us, -1, [(di + lo, di + hi)], F.silu))
    g = model_axis_gather(ys, -1)
    return (model_axis_gather([down_proj(g, p["ssm"]["w_out"]) for p in ps], -1),
            states if mode == "decode" else new)


_MIXERS = {"hybrid": _mamba_tp, "mlstm": _mlstm_tp, "slstm": _slstm_tp}


def _block(ps: list, x: torch.Tensor, cfg, kind: str, window, *, mode: str,
           cache: list | None = None, cur_pos: int | None = None, max_len: int = 0,
           prefix_len: int = 0, causal: bool = True, cross_inputs=None, mesh=None,
           transport=None, cache_mesh=None):
    """A block over the model ranks' shards ``ps``; the block interface of
    ``transformer._apply_stack`` and the counterpart of
    ``blocks.apply_block``: ``prefix_len`` (the vision prefix's
    bidirectional keys), ``causal`` (False in an encoder) and
    ``cross_inputs`` (a decoder block's cross attention) as there; a hybrid
    block's attention and Mamba on the same normed input, mixed by its
    replicated ``mix_a``/``mix_m``. The caches are a list of the serving
    group's ranks' caches, data-major: prefill cuts them over
    ``cache_mesh`` (the group's ('data', 'model') mesh; default one data
    rank's), decode reads them from ``cache``; a recurrent state is each
    model rank's, held once, the group's data ranks all listing it. Returns
    (x, the ranks' caches, aux); the caches are None in train mode. The
    recurrent kinds in train mode and the expert-parallel dispatch
    (``mesh``, ``transport``) raise ``ValueError``."""
    if kind in _MIXERS and mode == "train":
        raise ValueError(f"a {kind} block in train mode on a model axis: the tensor-parallel "
                         f"forward serves the SSM mixers only ({TP_REMAINDER})")
    if mesh is not None or transport is not None:
        raise ValueError("the tensor-parallel forward keeps the einsum dispatch: no mesh= or "
                         "transport= for its MoE blocks")
    m = len(ps)
    if cache_mesh is None:
        cache_mesh = one_data_rank(m)
    spec = attn_spec_for(cfg, window, causal)
    p0 = ps[0]
    h = rms_norm(p0["norm1"], x, cfg.norm_eps)
    caches = None
    if mode != "train":
        caches = [{} for _ in range(cache_mesh.size if cache is None else len(cache))]
    if kind in ("attn", "moe", "hybrid"):
        y, attn_caches = _self_attention(
            ps, h, cfg, spec, mode=mode,
            caches=None if cache is None else [c["attn"] for c in cache], cur_pos=cur_pos,
            max_len=max_len, prefix_len=prefix_len, mesh=cache_mesh)
        if caches is not None:
            for c, ac in zip(caches, attn_caches, strict=True):
                c["attn"] = ac
    if kind in _MIXERS:
        mixed, states = _MIXERS[kind](ps, h, cfg, mode=mode,
                                      caches=None if cache is None else cache[:m])
        y = mixed if kind != "hybrid" else (p0["mix_a"].to(x.dtype) * y
                                            + p0["mix_m"].to(x.dtype) * mixed)
        for i, c in enumerate(caches):
            c["ssm"] = states[i % m]
    x = x + y
    if "cross" in p0:
        y, cross = _cross_attention(ps, rms_norm(p0["norm_x"], x, cfg.norm_eps), cross_inputs,
                                    spec, mode=mode,
                                    caches=None if cache is None else [c["cross"] for c in cache],
                                    mesh=cache_mesh)
        x = x + y
        if caches is not None:
            for c, cc in zip(caches, cross, strict=True):
                c["cross"] = cc
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "mlp" in p0:
        h = rms_norm(p0["norm2"], x, cfg.norm_eps)
        x = x + model_axis_sum([mlp(p["mlp"], h, cfg.act) for p in ps])
    elif "moe" in p0:
        y, a = _moe(ps, rms_norm(p0["norm2"], x, cfg.norm_eps), cfg)
        x = x + y
        aux = aux + a
    return x, caches, aux


def _zip_ranks(stacks: list) -> dict:
    """The decoder stacks of the ranks as one stack whose every block entry
    is a list of the ranks' entries."""
    return {key: [list(ranks) for ranks in zip(*(s[key] for s in stacks))]
            for key in ("blocks", "tail")}


def apply_lm_tp(shards: list, cfg, *, tokens: torch.Tensor, embeds: torch.Tensor | None = None,
                mode: str, caches=None, cur_pos: int | None = None, max_len: int = 0,
                remat: bool = False, cache_mesh=None):
    """Train, prefill or decode of one serving group's requests on the model
    ranks' parameter shards ``shards`` (a list in model-rank order, each a
    tree shaped like the model's, with every leaf cut to its rank's block
    on the model axis). The group is ``cache_mesh``, a ('data', 'model')
    mesh of D data ranks of ``len(shards)`` model ranks (default: one data
    rank): the forward, replicated over its data ranks, runs once, on the
    shards of its data rank 0, and each rank of the group holds its
    ``cache_specs`` block of every attention and cross cache (with D > 1,
    the sequence on 'data' where it divides). ``embeds`` as ``transformer.apply_lm``'s: a vision
    config's patch embeddings (replicated, in front of the text unscaled, a
    bidirectional prefix, dropped before the unembedding) or an
    encoder-decoder's frame embeddings, which the encoder's blocks read
    through the tensor-parallel block, bidirectional, normed by the
    replicated ``enc_norm`` for the decoder's cross attention. Returns
    (logits (B, T, V) f32 of the text positions, caches): the caches are the
    unsharded structure with a list of the group's ranks' caches, data-major
    (model-rank order within a data rank), at each block; decode updates
    them in place. Train mode has no caches and returns (logits, aux)
    instead, aux the decoder blocks' summed auxiliary loss (0-d f32: the
    MoE router's load-balancing loss over the whole batch, 0 for a dense
    model), as ``transformer.apply_lm`` sums it; ``remat`` recomputes each
    superblock in the backward pass (``transformer._apply_stack``). A leaf
    the ranks hold replicated may be one tensor in every shard: its
    gradient is then the sum of the ranks' uses."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode {mode!r}: the tensor-parallel forward trains, prefills and "
                         "decodes")
    check_tensor_parallel(cfg, len(shards), mode="train" if mode == "train" else "serve")
    if cache_mesh is not None and (tuple(cache_mesh.axis_names) != (DP_AXES[-1], TP_AXIS)
                                   or cache_mesh.devices.shape[1] != len(shards)):
        raise ValueError(f"cache_mesh {tuple(cache_mesh.axis_names)} "
                         f"{tuple(cache_mesh.devices.shape)}: a ('data', 'model') mesh of "
                         f"{len(shards)} model ranks")
    dt = _dtype(cfg)
    scale = torch.tensor(cfg.d_model**0.5, dtype=dt, device=tokens.device)
    x = model_axis_sum([_embed_shard(s["embed"]["tokens"], tokens, r)
                        for r, s in enumerate(shards)]) * scale
    prefix_len, cross_inputs = 0, None
    if cfg.arch_type == "encdec" and mode != "decode":
        if embeds is None:
            raise ValueError(f"{cfg.name}: train and prefill need the frame embeddings")
        h, _, _ = _apply_stack(_zip_ranks([s["encoder"] for s in shards]), embeds.to(dt), cfg,
                               StackLayout(cfg, encoder=True), mode="train", causal=False,
                               remat=remat, block=_block)
        cross_inputs = rms_norm(shards[0]["enc_norm"], h, cfg.norm_eps)
    elif cfg.frontend == "vision":
        if mode == "decode":
            prefix_len = cfg.prefix_len
        else:
            if embeds is None:
                raise ValueError(f"{cfg.name}: train and prefill need the patch embeddings")
            x = torch.cat([embeds.to(dt), x], dim=1)
            prefix_len = embeds.shape[1]
    x = hint(x, "btd")
    x, new_caches, aux = _apply_stack(_zip_ranks([s["decoder"] for s in shards]), x, cfg,
                                      StackLayout(cfg), mode=mode, caches=caches,
                                      cur_pos=cur_pos, max_len=max_len, prefix_len=prefix_len,
                                      cross_inputs=cross_inputs, remat=remat,
                                      block=functools.partial(_block, cache_mesh=cache_mesh))
    x = rms_norm(shards[0]["final_norm"], x, cfg.norm_eps)
    if mode != "decode" and prefix_len:
        x = x[:, prefix_len:]
    logits = hint(model_axis_gather([unembed(s["embed"], x) for s in shards], -1), "btv")
    return logits, (aux if mode == "train" else new_caches)


def tp_loss(shards: list, cfg, batch: dict, *, remat: bool = False):
    """``Model.loss`` on the model ranks' shards: ``(nll + aux, {"nll":
    nll, "aux": aux})`` over ``batch['tokens']`` (and ``batch['embeds']``,
    a vision config's patches or an encoder-decoder's frames) and
    ``batch['labels']`` of the text positions, the labels clamped to the
    padded vocab, the nll over the concatenated f32 logits; aux the
    blocks' summed router loss over the whole batch, as one pass computes
    it (exactly 0 for a dense family)."""
    logits, aux = apply_lm_tp(shards, cfg, tokens=batch["tokens"], embeds=batch.get("embeds"),
                              mode="train", remat=remat)
    labels = torch.clamp(batch["labels"], max=cfg.padded_vocab - 1)
    nll = cross_entropy_loss(logits, labels, batch.get("loss_mask"))
    return nll + aux, {"nll": nll, "aux": aux}
