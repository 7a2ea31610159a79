"""Plain oracle for the bit-plane kernel (the `ref.py` contract).

Computes the same function as the kernel on the *unpacked* weight, in
the JAX package's order (dequantise, then one f32 product), so kernel
bugs and packing bugs are caught independently.
"""
from __future__ import annotations

import torch

from ..quant.bitplane import unpack


def bitplane_matmul_ref(x: torch.Tensor, w_packed: torch.Tensor,
                        scale: torch.Tensor, *, bits: int) -> torch.Tensor:
    """y = x @ (unpacked ints * scale), all in f32."""
    q = unpack(w_packed, bits, axis=0)                     # [K, N] int32
    w = q.to(torch.float32) * scale                        # [K, N] * [1, N]
    return x.to(torch.float32) @ w
