"""Bit-plane quantization and packing."""
from . import bitplane

__all__ = ["bitplane"]
