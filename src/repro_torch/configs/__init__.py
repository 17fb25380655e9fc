"""Config registry of the port: the reference's ten architectures."""
from .base import ModelConfig, RunConfig

from . import (gemma3_27b, hymba_1p5b, minitron_8b, mixtral_8x7b, moonshot_v1_16b_a3b,
               paligemma_3b, qwen15_32b, qwen3_moe_30b_a3b, whisper_large_v3, xlstm_350m)

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (gemma3_27b, hymba_1p5b, minitron_8b, mixtral_8x7b, moonshot_v1_16b_a3b,
              paligemma_3b, qwen15_32b, qwen3_moe_30b_a3b, whisper_large_v3, xlstm_350m)
}


def get_config(name: str) -> ModelConfig:
    """Resolve '--arch <id>'; '<id>-smoke' gives the reduced CPU variant."""
    if name.endswith("-smoke"):
        return get_config(name[: -len("-smoke")]).reduced()
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = [
    "ARCHS",
    "get_config",
    "ModelConfig",
    "RunConfig",
]
