"""Whisper-large-v3 — encoder-decoder ASR backbone [arXiv:2212.04356].
As in the reference, the mel-spectrogram and conv frontend is a stub: the
encoder takes 1500 frame embeddings directly."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,            # decoder layers
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    arch_type="encdec",
    encoder_layers=32,
    frontend="audio",
    frontend_len=1500,
    qkv_bias=True,
    act="gelu",
    source="arXiv:2212.04356 (Whisper); enc-dec, conv frontend stubbed",
)
