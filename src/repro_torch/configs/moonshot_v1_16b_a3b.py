"""Moonlight-16B-A3B (moonshot) — DeepSeek-style MoE: 64 experts top-6 + 2
shared experts [hf:moonshotai/Moonlight-16B-A3B]; the reference's config,
built as MoE (DESIGN.md Sec. 6)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    num_experts=64,
    experts_per_token=6,
    num_shared_experts=2,
    block_pattern=("moe",),
    source="hf:moonshotai/Moonlight-16B-A3B; 64e top-6 + 2 shared",
)
