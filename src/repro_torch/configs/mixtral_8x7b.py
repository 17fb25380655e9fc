"""Mixtral-8x7B — 8-expert top-2 MoE with sliding-window attention
[arXiv:2401.04088]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    num_experts=8,
    experts_per_token=2,
    block_pattern=("moe",),
    attn_pattern=(4096,),  # sliding window (Mistral-style)
    rope_theta=1e6,
    source="arXiv:2401.04088 (Mixtral); 8 experts top-2, SWA 4096",
)
