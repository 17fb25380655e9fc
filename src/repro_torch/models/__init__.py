"""The dense model family of the port."""
from .model import Model
from .transformer import StackLayout, apply_lm, init_decode_cache, init_lm

__all__ = ["Model", "StackLayout", "apply_lm", "init_decode_cache", "init_lm"]
