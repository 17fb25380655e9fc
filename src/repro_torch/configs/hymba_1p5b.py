"""Hymba-1.5B — parallel attention + mamba heads per layer
[arXiv:2411.13676]. As in the reference, every attention layer is a
sliding window of 1024 (the paper's few global layers and meta tokens are
dropped), so every layer is sub-quadratic."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    ssm_expand=2,
    block_pattern=("hybrid",),
    attn_pattern=(1024,),
    source="arXiv:2411.13676 (Hymba); parallel attn+SSM heads, ssm_state=16",
)
