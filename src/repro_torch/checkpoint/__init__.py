"""Fault-tolerant checkpointing."""
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
