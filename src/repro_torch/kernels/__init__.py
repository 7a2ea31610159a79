"""Hand-written Hopper kernels, their plain PyTorch versions and the
public wrappers (`ops`) and oracles (`ref`) around them, plus the
simulator-backed CoMeFa kernels (`comefa_sim`)."""
from . import (bit_transpose, bitplane_matmul, bitserial_matmul,
               bitserial_reduce, bulk_bitwise, comefa_sim, comefa_step, nvcc,
               ops, ref)

__all__ = ["bit_transpose", "bitplane_matmul", "bitserial_matmul",
           "bitserial_reduce", "bulk_bitwise", "comefa_sim", "comefa_step",
           "nvcc", "ops", "ref"]
