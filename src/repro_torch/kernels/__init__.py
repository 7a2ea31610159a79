"""Hand-written Hopper kernels, their plain PyTorch versions and the
public wrappers (`ops`) and oracles (`ref`) around them, plus the
simulator-backed CoMeFa kernels (`comefa_sim`)."""
from . import bitplane_matmul, comefa_sim, comefa_step, nvcc, ops, ref

__all__ = ["bitplane_matmul", "comefa_sim", "comefa_step", "nvcc", "ops",
           "ref"]
