"""Hand-written Hopper kernels, their plain PyTorch versions and the
public wrappers (`ops`) and oracles (`ref`) around them."""
from . import bitplane_matmul, ops, ref

__all__ = ["bitplane_matmul", "ops", "ref"]
