"""Qwen1.5-32B — dense with QKV bias [hf:Qwen/Qwen1.5-0.5B family card]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    source="hf:Qwen/Qwen1.5 family; QKV bias, MHA (kv == q heads)",
)
