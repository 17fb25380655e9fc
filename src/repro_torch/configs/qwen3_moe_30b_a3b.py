"""Qwen3-30B-A3B — 128-expert top-8 MoE [hf:Qwen/Qwen3-30B-A3B]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=768,
    vocab_size=151936,
    head_dim=128,  # explicit head_dim per model card (not d_model/H)
    num_experts=128,
    experts_per_token=8,
    block_pattern=("moe",),
    rope_theta=1e6,
    source="hf:Qwen/Qwen3-30B-A3B; 128 experts, top-8, moe_ff=768, head_dim=128",
)
