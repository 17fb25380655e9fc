"""xLSTM-350M — sLSTM + mLSTM blocks in a 7:1 ratio [arXiv:2405.04517]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=256,
    block_pattern=("mlstm",) * 7 + ("slstm",),
    ssm_expand=2,
    ssm_chunk=128,
    source="arXiv:2405.04517 (xLSTM); 7:1 mLSTM:sLSTM block ratio",
)
