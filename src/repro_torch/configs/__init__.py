"""Config registry of the port: the architectures its slices serve."""
from .base import ModelConfig

from . import minitron_8b

ARCHS: dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in (minitron_8b,)}


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
]
