"""PaliGemma-3B — SigLIP vision encoder (STUB) + Gemma-2B decoder
[arXiv:2407.07726]. The vision tower is a stub: the data pipeline supplies
256 patch embeddings; the decoder uses a bidirectional prefix-LM mask over
them."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    d_ff=16384,
    vocab_size=257216,
    head_dim=256,
    frontend="vision",
    frontend_len=256,
    prefix_len=256,
    act="geglu",
    source="arXiv:2407.07726 (PaliGemma); gemma-2B decoder, MQA, 256 patches",
)
