"""Model definitions: primitives, attention, MLP, recurrent mixers, LM
assembly."""
from . import attention, common, ffn, lm, recurrent
from .common import Config, reduced

__all__ = ["attention", "common", "ffn", "lm", "recurrent", "Config",
           "reduced"]
