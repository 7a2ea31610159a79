"""Plain oracles for the port's kernels (the `ref.py` contract).

Each computes the same function as its kernel, by another route: the
matmuls on the *unpacked* integers in the JAX package's order (dequantise,
then one f32 product), the rest in numpy on raw element-major records, so
kernel bugs and packing bugs are caught independently.  The numpy oracles
take and return numpy arrays, as the JAX package's do.
"""
from __future__ import annotations

import numpy as np
import torch

from ..quant.bitplane import unpack


def bitplane_matmul_ref(x: torch.Tensor, w_packed: torch.Tensor,
                        scale: torch.Tensor, *, bits: int) -> torch.Tensor:
    """y = x @ (unpacked ints * scale), all in f32."""
    q = unpack(w_packed, bits, axis=0)                     # [K, N] int32
    w = q.to(torch.float32) * scale                        # [K, N] * [1, N]
    return x.to(torch.float32) @ w


def bitserial_matmul_ref(x_packed: torch.Tensor, w_packed: torch.Tensor,
                         x_scale: torch.Tensor, w_scale: torch.Tensor, *,
                         a_bits: int, w_bits: int) -> torch.Tensor:
    """y = (qx @ qw) * x_scale * w_scale, the product in f32."""
    qx = unpack(x_packed.movedim(1, 0), a_bits, axis=1)        # [M, K]
    qw = unpack(w_packed, w_bits, axis=0)                      # [K, N]
    y = qx.to(torch.float32) @ qw.to(torch.float32)
    return y * x_scale * w_scale


def search_replace_ref(records: np.ndarray, key: int) -> np.ndarray:
    """Element-level oracle on raw integer records."""
    return np.where(records == key, 0, records)


def raid_xor_ref(stripes: np.ndarray) -> np.ndarray:
    return np.bitwise_xor.reduce(stripes, axis=0)


def bitserial_reduce_ref(values: np.ndarray) -> float:
    return float(values.astype(np.int64).sum())


def bit_transpose_ref(x: np.ndarray, bits: int) -> np.ndarray:
    """Element-major ints -> packed planes, in numpy (uint32)."""
    n = x.shape[0]
    u = x.astype(np.uint32)
    planes = np.zeros((bits, n // 32), dtype=np.uint32)
    for i in range(bits):
        b = ((u >> i) & 1).reshape(-1, 32)
        planes[i] = (b << np.arange(32, dtype=np.uint32)).sum(
            axis=1).astype(np.uint32)
    return planes
