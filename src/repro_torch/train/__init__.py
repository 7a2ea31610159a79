"""Training: AdamW (+int8 v), microbatched step, fault-tolerant loop."""
from . import loop, optimizer, step

__all__ = ["loop", "optimizer", "step"]
