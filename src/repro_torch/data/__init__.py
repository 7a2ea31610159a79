"""Deterministic synthetic data pipeline (stateless by step)."""
from . import pipeline

__all__ = ["pipeline"]
