"""Model definitions: primitives, attention, MLP, LM assembly."""
from . import attention, common, ffn, lm
from .common import Config, reduced

__all__ = ["attention", "common", "ffn", "lm", "Config", "reduced"]
