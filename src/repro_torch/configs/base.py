"""Model architecture configuration. Run settings and input shapes come with
the trainer slice (ROADMAP A.4)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ModelConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description. One instance per assigned architecture
    (``configs/<id>.py``); ``reduced()`` derives the CPU smoke
    variant of the same family."""

    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 512       # GShard dispatch group length
    router_aux_coef: float = 0.01
    moe_dispatch: str = "einsum"

    # --- attention ---
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    # per-layer window pattern, repeated over depth; None entry = global attn.
    # e.g. gemma3: (1024, 1024, 1024, 1024, 1024, None)  -> 5 local : 1 global
    attn_pattern: Tuple[Optional[int], ...] = (None,)

    # --- block pattern (ssm / hybrid); entries: 'attn'|'moe'|'mlstm'|'slstm'|'hybrid'
    block_pattern: Optional[Tuple[str, ...]] = None
    ssm_state: int = 0              # mamba state dim N
    ssm_expand: int = 2             # mamba/mlstm inner expansion
    ssm_conv: int = 4               # mamba short-conv width
    ssm_chunk: int = 128            # chunkwise-scan chunk length

    # --- structure ---
    arch_type: str = "decoder"      # decoder | encdec
    encoder_layers: int = 0
    frontend: Optional[str] = None  # 'audio' | 'vision' (STUB embeddings)
    frontend_len: int = 0           # frames / patches supplied by the stub
    prefix_len: int = 0             # bidirectional prefix (VLM prefix-LM)
    tie_embeddings: bool = True
    act: str = "silu"               # mlp nonlinearity: silu (swiglu) | gelu
    norm_eps: float = 1e-6
    vocab_pad_to: int = 256
    dtype: str = "bfloat16"
    kv_cache_dtype: str = "bfloat16"

    # --- citation ---
    source: str = ""

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.block_pattern is None:
            kind = "moe" if self.num_experts else "attn"
            object.__setattr__(self, "block_pattern", (kind,))
        if self.num_heads % self.num_kv_heads:
            raise ValueError("num_heads must be divisible by num_kv_heads")

    # ---- derived ----

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return ((self.vocab_size + p - 1) // p) * p

    @property
    def pattern_period(self) -> int:
        return max(len(self.block_pattern), len(self.attn_pattern))

    def layer_kinds(self) -> list[str]:
        bp = self.block_pattern
        return [bp[i % len(bp)] for i in range(self.num_layers)]

    def layer_windows(self) -> list[Optional[int]]:
        ap = self.attn_pattern
        return [ap[i % len(ap)] for i in range(self.num_layers)]

    def reduced(self) -> "ModelConfig":
        """CPU smoke variant of the same family: 2 pattern periods of layers,
        d_model <= 512, <= 4 experts."""
        period = self.pattern_period
        n_layers = min(self.num_layers, 2 * period)
        d = min(self.d_model, 256)
        hd = 32
        kv = min(self.num_kv_heads, 2)
        heads = max(kv, min(self.num_heads, 4))
        heads = (heads // kv) * kv
        enc = min(self.encoder_layers, 2)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=n_layers,
            d_model=d,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=hd,
            d_ff=min(self.d_ff, 512) if self.d_ff else self.d_ff,
            vocab_size=min(self.vocab_size, 1024),
            num_experts=min(self.num_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            num_shared_experts=min(self.num_shared_experts, 1),
            moe_group_size=64,
            encoder_layers=enc,
            frontend_len=min(self.frontend_len, 16) if self.frontend_len else 0,
            prefix_len=min(self.prefix_len, 16) if self.prefix_len else 0,
            attn_pattern=tuple(
                (min(w, 64) if w is not None else None) for w in self.attn_pattern
            ),
            ssm_chunk=16,
            vocab_pad_to=64,
        )

