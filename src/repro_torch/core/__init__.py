"""Core models: the CoMeFa compute-in-memory RAM (`comefa`)."""
from . import comefa

__all__ = ["comefa"]
