"""Serving: prefill/decode engine and continuous batching."""
from . import engine

__all__ = ["engine"]
