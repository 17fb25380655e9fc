"""The tensor-parallel (TP) forward: one data rank's M model ranks serving
or training together, each from its own shard of every weight.

The shards are the reference's TP layout on the model axis: each rank holds
its query and kv heads of ``wq``/``wk``/``wv`` (and the QKV biases), its
rows of ``wo``, its columns of ``w_up``/``w_gate``, its rows of ``w_down``
and its vocab rows of the embedding; norm scales are replicated. Serving
reads them under ``param_specs(fsdp=False, attn_fallback='head_dim')``;
training gathers them from the FSDP blocks of ``param_specs(fsdp=True,
attn_fallback='replicate')`` (:mod:`repro_torch.train.train_step`), which
for the families covered here cut the model axis the same way. The math is
the unsharded model's, cut at the four points where GSPMD inserts the
reference's model-axis all-reduce or gather:

  * the embedding lookup: each rank looks up the tokens of its vocab
    slice, and zero rows for the others (partial rows); in training its
    slice's gradient sums each row's occurrences in f32 and rounds once,
    as the one-axis embedding does (:func:`.layers.row_grad`);
  * attention: each rank attends on its heads, giving a partial of the
    output projection (``layers._out_proj``), its cache holding its kv
    heads (``cache_specs``' share);
  * the MLP: a partial of ``down_proj`` from each rank's width slice;
  * the unembedding: each rank's vocab slice of the f32 logits,
    concatenated in model-rank order.

Partials are summed by :func:`model_axis_sum`, the plain sum over the rank
rows in model-rank order: two runs give the same bits. Its backward hands
every rank's partial the whole upstream gradient, GSPMD's model-axis
all-reduce in reverse. The emulation is a loop over the model ranks inside
each layer (all ranks on one device); no rank reads another's shard, and no
layer's full weight is ever assembled. A replicated value (the residual
stream, a norm's output) is the same on every rank, so it is computed once,
from rank 0's copy of a replicated weight.

The families covered are the dense decoders whose heads, kv heads,
``d_ff`` and padded vocab divide the model axis (minitron-8b, gemma3-27b,
qwen1.5-32b and their smoke configs at M = 2). Everything else on a model
axis raises a ``ValueError`` naming the ROADMAP item "Tensor-parallel
remainder" (:func:`check_tensor_parallel`).
"""
from __future__ import annotations

import dataclasses

import torch

from ..dist.hints import hint
from .blocks import attn_spec_for, prefill_cache
from .layers import attention, cross_entropy_loss, mlp, rms_norm, row_grad, unembed
from .transformer import StackLayout, _apply_stack, _dtype

__all__ = ["TP_REMAINDER", "apply_lm_tp", "check_tensor_parallel", "model_axis_sum", "tp_loss"]

TP_REMAINDER = 'ROADMAP item "Tensor-parallel remainder"'


def check_tensor_parallel(cfg, m: int) -> None:
    """Raise unless ``cfg`` serves or trains on a model axis of ``m`` ranks: a dense
    decoder over text whose heads, kv heads, ``d_ff`` and padded vocab
    divide ``m``."""
    why = []
    if cfg.arch_type != "decoder" or cfg.frontend is not None:
        why.append("the encoder-decoder and the vision prefix")
    kinds = set(cfg.layer_kinds()) - {"attn"}
    if "moe" in kinds:
        why.append("MoE expert or expert-FFN shards")
    if kinds - {"moe"}:
        why.append(f"the SSM mixers ({', '.join(sorted(kinds - {'moe'}))} blocks)")
    if cfg.num_heads % m or cfg.num_kv_heads % m:
        why.append(f"attn_fallback's head-dim split and the sequence-split cache "
                   f"({cfg.num_heads} query and {cfg.num_kv_heads} kv heads)")
    if not cfg.d_ff or cfg.d_ff % m:
        why.append(f"an MLP of width {cfg.d_ff}")
    if cfg.padded_vocab % m:
        why.append(f"a padded vocab of {cfg.padded_vocab}")
    if why:
        raise ValueError(f"{cfg.name} on a model axis of {m} ranks: the tensor-parallel "
                         f"forward does not cover {'; '.join(why)} ({TP_REMAINDER})")


def model_axis_sum(parts: list) -> torch.Tensor:
    """The model-axis sum of the ranks' partials: the port's plain sum over
    the rank rows, in model-rank order (the counterpart of the reference's
    GSPMD all-reduce)."""
    return torch.stack(parts).sum(0)


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


def _block(ps: list, x: torch.Tensor, cfg, kind: str, window, *, mode: str,
           cache: list | None = None, cur_pos: int | None = None, max_len: int = 0, **_):
    """A dense attention block over the model ranks' shards ``ps`` (and
    their caches, a list of as many); the block interface of
    ``transformer._apply_stack``. Returns (x, the ranks' caches, aux 0);
    the caches are None in train mode."""
    m = len(ps)
    spec = attn_spec_for(cfg, window)
    spec = dataclasses.replace(spec, num_heads=spec.num_heads // m,
                               num_kv_heads=spec.num_kv_heads // m)
    h = rms_norm(ps[0]["norm1"], x, cfg.norm_eps)
    ys, caches = [], []
    for r, p in enumerate(ps):
        y, ac = attention(p["attn"], h, spec, mode=mode, cur_pos=cur_pos,
                          cache=None if cache is None else cache[r]["attn"])
        ys.append(y)
        caches.append({"attn": prefill_cache(ac, max_len, spec, cfg) if mode == "prefill"
                       else ac})
    x = x + model_axis_sum(ys)
    h = rms_norm(ps[0]["norm2"], x, cfg.norm_eps)
    x = x + model_axis_sum([mlp(p["mlp"], h, cfg.act) for p in ps])
    return (x, None if mode == "train" else caches,
            torch.zeros((), dtype=torch.float32, device=x.device))


def _zip_ranks(stacks: list) -> dict:
    """The decoder stacks of the ranks as one stack whose every block entry
    is a list of the ranks' entries."""
    return {key: [list(ranks) for ranks in zip(*(s[key] for s in stacks))]
            for key in ("blocks", "tail")}


def apply_lm_tp(shards: list, cfg, *, tokens: torch.Tensor, mode: str, caches=None,
                cur_pos: int | None = None, max_len: int = 0, remat: bool = False):
    """Train, prefill or decode of one data rank on its model ranks'
    parameter shards ``shards`` (a list in model-rank order, each a tree
    shaped like the model's, with every leaf cut to its rank's block on the
    model axis). Returns (logits (B, T, V) f32, caches): the caches are the
    unsharded structure with a list of the ranks' caches, in model-rank
    order, at each block; decode updates them in place; train mode returns
    None for them, and ``remat`` recomputes each superblock in the backward
    pass (``transformer._apply_stack``). A leaf the ranks hold replicated
    may be one tensor in every shard: its gradient is then the sum of the
    ranks' uses."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode {mode!r}: the tensor-parallel forward trains, prefills and "
                         "decodes")
    check_tensor_parallel(cfg, len(shards))
    scale = torch.tensor(cfg.d_model**0.5, dtype=_dtype(cfg), device=tokens.device)
    x = model_axis_sum([_embed_shard(s["embed"]["tokens"], tokens, r)
                        for r, s in enumerate(shards)]) * scale
    x = hint(x, "btd")
    x, new_caches, _ = _apply_stack(_zip_ranks([s["decoder"] for s in shards]), x, cfg,
                                    StackLayout(cfg), mode=mode, caches=caches,
                                    cur_pos=cur_pos, max_len=max_len, remat=remat,
                                    block=_block)
    x = rms_norm(shards[0]["final_norm"], x, cfg.norm_eps)
    logits = torch.cat([unembed(s["embed"], x) for s in shards], dim=-1)
    return hint(logits, "btv"), new_caches


def tp_loss(shards: list, cfg, batch: dict, *, remat: bool = False):
    """``Model.loss`` on the model ranks' shards: ``(nll + aux, {"nll":
    nll, "aux": aux})`` over ``batch['tokens']`` and ``batch['labels']``,
    the labels clamped to the padded vocab, the nll over the concatenated
    f32 logits; aux is 0, as for every dense family."""
    logits, _ = apply_lm_tp(shards, cfg, tokens=batch["tokens"], mode="train", remat=remat)
    labels = torch.clamp(batch["labels"], max=cfg.padded_vocab - 1)
    nll = cross_entropy_loss(logits, labels, batch.get("loss_mask"))
    aux = torch.zeros((), dtype=torch.float32, device=nll.device)
    return nll + aux, {"nll": nll, "aux": aux}
