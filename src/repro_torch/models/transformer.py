"""Stack assembly: decoder over stacked superblocks.

Layers are grouped into *superblocks* of length P = lcm(|block_pattern|,
|attn_pattern|), as in the reference. Parameters keep the reference's
stacked layout: ``decoder.blocks[i]`` holds pattern slot ``i`` for every
superblock, with a leading ``num_layers // P`` dimension, so the port's
parameter tree flattens and buckets exactly like the reference's. Layer
``l`` of slot ``i`` is row ``l`` of that stack. ``num_layers % P`` leftover
layers live unstacked in ``decoder.tail``. Decode caches are stacked the
same way. A vision config's stub patch embeddings enter in front of the
text tokens as a bidirectional prefix (prefix-LM), as in the reference. An
encoder-decoder (whisper) adds a bidirectional ``encoder`` stack of the
same layout over its stub frame embeddings, normed by ``enc_norm``; each
decoder block attends to that output through its ``cross`` attention.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from ..core.tree import tree_map
from ..dist.hints import hint
from .blocks import apply_block, init_block, init_block_cache
from .layers import embed_tokens, init_embedding, init_rms_norm, rms_norm, unembed

__all__ = ["StackLayout", "init_lm", "apply_lm", "init_decode_cache"]


class StackLayout:
    """Derived layer layout for a config: its decoder's, or with
    ``encoder=True`` its encoder's (``encoder_layers`` global attention
    blocks, a period of 1)."""

    def __init__(self, cfg, *, encoder: bool = False):
        self.cfg = cfg
        if encoder:
            self.period = 1
            self.num_layers = cfg.encoder_layers
            self.kinds = ["attn"] * cfg.encoder_layers
            self.windows = [None] * cfg.encoder_layers
        else:
            bp, ap = cfg.block_pattern, cfg.attn_pattern
            self.period = math.lcm(len(bp), len(ap))
            self.num_layers = cfg.num_layers
            self.kinds = cfg.layer_kinds()
            self.windows = cfg.layer_windows()
        self.num_super = self.num_layers // self.period
        self.tail = self.num_layers % self.period


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_arch(cfg) -> None:
    """The two structures of the reference: a decoder over text (with a
    vision prefix or none), and the encoder-decoder over audio frames."""
    if (cfg.arch_type, cfg.frontend) not in (("decoder", None), ("decoder", "vision"),
                                             ("encdec", "audio")):
        raise ValueError(
            f"{cfg.name}: arch_type {cfg.arch_type!r} with frontend {cfg.frontend!r}; the "
            "models are decoders over text or a vision prefix, and encoder-decoders over "
            "audio frames")


def _init_stack(gen: torch.Generator, cfg, layout: StackLayout, *, cross: bool,
                causal: bool) -> dict:
    dt = _dtype(cfg)
    blocks = []
    for i in range(layout.period):
        if layout.num_super:
            blocks.append(init_block(gen, cfg, layout.kinds[i], layout.windows[i], cross=cross,
                                     causal=causal, dtype=dt, lead=(layout.num_super,)))
        else:
            blocks.append(None)
    tail = []
    for j in range(layout.tail):
        i = (layout.num_super * layout.period + j) % layout.period
        tail.append(init_block(gen, cfg, layout.kinds[i], layout.windows[i], cross=cross,
                               causal=causal, dtype=dt))
    return {"blocks": blocks, "tail": tail}


def init_lm(gen: torch.Generator, cfg) -> dict:
    """Full parameter tree for a config, drawn from ``gen`` on its device."""
    _check_arch(cfg)
    dt = _dtype(cfg)
    encdec = cfg.arch_type == "encdec"
    # the decoder draws first, then the embedding: the order a seed's parameters rest on
    decoder = _init_stack(gen, cfg, StackLayout(cfg), cross=encdec, causal=True)
    params = {
        "embed": init_embedding(gen, cfg.padded_vocab, cfg.d_model, cfg.tie_embeddings, dt),
        "decoder": decoder,
        "final_norm": init_rms_norm(cfg.d_model, gen.device),
    }
    if encdec:
        params["encoder"] = _init_stack(gen, cfg, StackLayout(cfg, encoder=True), cross=False,
                                        causal=False)
        params["enc_norm"] = init_rms_norm(cfg.d_model, gen.device)
    return params


def _train_superblock(x, stack, l: int, cfg, layout: StackLayout, prefix_len: int, causal,
                      cross_inputs, mesh, transport, block=apply_block):
    """Superblock ``l`` in train mode (the reference's scan body). Returns
    (x, aux) with ``aux`` the superblock's summed auxiliary loss."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(layout.period):
        p = tree_map(lambda t: t[l], stack["blocks"][i])
        x, _, a = block(p, x, cfg, layout.kinds[i], layout.windows[i], mode="train",
                        prefix_len=prefix_len, causal=causal, cross_inputs=cross_inputs,
                        mesh=mesh, transport=transport)
        x = hint(x, "btd_res")  # optional sequence-parallel residual
        aux = aux + a
    return x, aux


def _stack_once(held: dict):
    """``torch.stack`` of the layers' leaves, once for each distinct tuple
    of tensors: a cache held once that several ranks list (the
    tensor-parallel group's, :mod:`.tensor_parallel`) stays one tensor."""
    def stack(*ts):
        key = tuple(id(t) for t in ts)
        if key not in held:
            held[key] = torch.stack(ts)
        return held[key]
    return stack


def _apply_stack(stack, x, cfg, layout: StackLayout, *, mode: str, caches=None,
                 cur_pos=None, max_len: int = 0, prefix_len: int = 0, causal: bool = True,
                 cross_inputs=None, remat: bool = False, mesh=None, transport=None,
                 block=apply_block):
    """Returns (x, caches, aux) with caches ``{'blocks': [...], 'tail':
    [...]}``, or ``None`` in train mode, and ``aux`` the blocks' summed
    auxiliary loss (0-d f32). ``prefix_len`` reaches every block (the
    bidirectional prefix of a vision config), and so do ``mesh`` and
    ``transport`` (a moe block's expert-parallel dispatch, see
    :func:`apply_block`), and ``causal`` and ``cross_inputs`` (an encoder's
    bidirectional blocks, a decoder's cross attention to the encoder's
    output). ``remat`` (train mode) recomputes each superblock in the
    backward pass instead of keeping its activations: the reference's
    ``jax.checkpoint`` around its scan body. ``block`` computes a block in
    every mode (:func:`apply_block`, or the tensor-parallel block of
    :mod:`.tensor_parallel`, whose stack holds each layer's rank shards as
    a list)."""
    P = layout.period
    kinds, wins = layout.kinds, layout.windows
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    if mode == "train":
        auxs = []
        for l in range(layout.num_super):
            if remat:
                x, a = checkpoint(_train_superblock, x, stack, l, cfg, layout, prefix_len,
                                  causal, cross_inputs, mesh, transport, block,
                                  use_reentrant=False)
            else:
                x, a = _train_superblock(x, stack, l, cfg, layout, prefix_len, causal,
                                         cross_inputs, mesh, transport, block)
            auxs.append(a)
        if auxs:
            aux_total = aux_total + torch.stack(auxs).sum()
        for j, tp in enumerate(stack["tail"]):
            i = (layout.num_super * P + j) % P
            x, _, a = block(tp, x, cfg, kinds[i], wins[i], mode="train",
                            prefix_len=prefix_len, causal=causal,
                            cross_inputs=cross_inputs, mesh=mesh, transport=transport)
            aux_total = aux_total + a
        return x, None, aux_total
    slot_caches: list[list] = [[] for _ in range(P)]
    auxs = []
    for l in range(layout.num_super):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(P):
            p = tree_map(lambda t: t[l], stack["blocks"][i])
            c = None if caches is None else tree_map(lambda t: t[l], caches["blocks"][i])
            x, nc, a = block(p, x, cfg, kinds[i], wins[i], mode=mode, cache=c,
                             cur_pos=cur_pos, max_len=max_len, prefix_len=prefix_len,
                             causal=causal, cross_inputs=cross_inputs, mesh=mesh,
                             transport=transport)
            x = hint(x, "btd_res")  # optional sequence-parallel residual
            aux = aux + a
            slot_caches[i].append(nc)
        auxs.append(aux)
    new_caches = {"blocks": None, "tail": []}
    if layout.num_super:
        aux_total = aux_total + torch.stack(auxs).sum()
        if mode == "prefill":
            new_caches["blocks"] = [tree_map(_stack_once({}), *cs) for cs in slot_caches]
        else:  # decode wrote its token and recurrent states into the stacked caches in place
            new_caches["blocks"] = caches["blocks"]
    for j, tp in enumerate(stack["tail"]):
        i = (layout.num_super * P + j) % P
        tc = None if caches is None else caches["tail"][j]
        x, nc, a = block(tp, x, cfg, kinds[i], wins[i], mode=mode, cache=tc,
                         cur_pos=cur_pos, max_len=max_len, prefix_len=prefix_len,
                         causal=causal, cross_inputs=cross_inputs, mesh=mesh,
                         transport=transport)
        aux_total = aux_total + a
        new_caches["tail"].append(nc)
    return x, new_caches, aux_total


def apply_lm(params, cfg, *, tokens: torch.Tensor | None = None,
             embeds: torch.Tensor | None = None, mode: str = "train", caches=None,
             cur_pos: int | None = None, max_len: int = 0, remat: bool = False, mesh=None,
             transport=None):
    """train/prefill: ``tokens`` (B, T_text), and for a vision config the
    stub patch ``embeds`` (B, prefix, D), which go in front unscaled, or
    for an encoder-decoder the stub frame ``embeds`` (B, frames, D), which
    the encoder reads (in train mode, bidirectional, as the reference runs
    it in prefill too) and the decoder's cross attention sees normed by
    ``enc_norm``; decode: ``tokens`` (B, 1) + ``caches`` + ``cur_pos`` (an
    encoder-decoder's cross keys and values come from the caches). Returns
    (logits_f32 of the text positions, caches, aux); caches are None in
    train mode, and ``aux`` is the blocks' summed auxiliary loss (0-d f32:
    the MoE router's load-balancing loss, 0 for a dense model).

    ``mesh`` (an :class:`~repro_torch.launch.mesh.EmulatedMesh`) with
    ``cfg.moe_dispatch == 'alltoallv'`` runs every moe block's experts in
    parallel over the mesh's ranks: the batch splits into ``mesh.size``
    contiguous shards (B must divide), the reference's ``shard_map`` with
    the batch on the axis and the parameters replicated. Every other layer
    is per-row arithmetic and runs on the whole batch at once. ``transport``
    moves the experts' rows (:func:`repro_torch.comm.palltoallv` by
    default, with its plan's executor; see :func:`.moe.moe_ffn`)."""
    _check_arch(cfg)
    if tokens is None:
        raise ValueError(f"{cfg.name}: every ported family embeds text tokens; pass tokens=")
    layout = StackLayout(cfg)
    dt = _dtype(cfg)
    scale = torch.tensor(cfg.d_model**0.5, dtype=dt, device=tokens.device)
    x = embed_tokens(params["embed"], tokens) * scale
    prefix_len = 0
    cross_inputs = None
    if cfg.arch_type == "encdec" and mode != "decode":
        if embeds is None:
            raise ValueError(f"{cfg.name}: train and prefill need the frame embeddings")
        h, _, _ = _apply_stack(params["encoder"], embeds.to(dt), cfg,
                               StackLayout(cfg, encoder=True), mode="train", causal=False,
                               remat=remat)
        cross_inputs = rms_norm(params["enc_norm"], h, cfg.norm_eps)
    elif cfg.frontend == "vision":
        if mode == "decode":
            prefix_len = cfg.prefix_len
        else:
            if embeds is None:
                raise ValueError(f"{cfg.name}: train and prefill need the patch embeddings")
            x = torch.cat([embeds.to(dt), x], dim=1)
            prefix_len = embeds.shape[1]
    x = hint(x, "btd")
    x, new_caches, aux = _apply_stack(params["decoder"], x, cfg, layout, mode=mode,
                                      caches=caches, cur_pos=cur_pos, max_len=max_len,
                                      prefix_len=prefix_len, cross_inputs=cross_inputs,
                                      remat=remat, mesh=mesh, transport=transport)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    if mode != "decode" and prefix_len:
        x = x[:, prefix_len:]
    return hint(unembed(params["embed"], x), "btv"), new_caches, aux


def init_decode_cache(cfg, batch: int, max_len: int, device) -> dict:
    """Zero decode cache matching :func:`apply_lm`'s cache structure; an
    encoder-decoder's blocks also hold zero ``cross`` keys and values of
    ``frontend_len`` frames in the compute dtype."""
    layout = StackLayout(cfg)
    P = layout.period

    def one(i: int) -> dict:
        c = init_block_cache(cfg, layout.kinds[i], layout.windows[i], batch, max_len, device)
        if cfg.arch_type == "encdec":
            shape = (batch, cfg.frontend_len, cfg.num_kv_heads, cfg.head_dim)
            c["cross"] = {key: torch.zeros(shape, dtype=_dtype(cfg), device=device)
                          for key in ("k", "v")}
        return c

    blocks = None
    if layout.num_super:
        blocks = [tree_map(lambda t: t.expand((layout.num_super,) + tuple(t.shape)).clone(),
                           one(i)) for i in range(P)]
    tail = [one((layout.num_super * P + j) % P) for j in range(layout.tail)]
    return {"blocks": blocks, "tail": tail}
