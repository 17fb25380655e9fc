"""Gemma-3-27B — 5:1 local(1024):global attention, 128k context
[hf:google/gemma-3-1b-pt family card]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    d_ff=21504,
    vocab_size=262144,
    head_dim=128,
    attn_pattern=(1024, 1024, 1024, 1024, 1024, None),  # 5 local : 1 global
    act="geglu",
    rope_theta=1e6,
    source="hf:google/gemma-3 family; 5:1 local:global, window 1024",
)
