"""Bit-plane packing: CoMeFa's transposed layout as packed 32-bit words.

A w-bit integer tensor becomes w binary *planes*; each plane is packed 32
lanes to a word along the reduction (K) axis: bit i of lane k lives in
word k//32 at position k%32 of plane i, exactly as `repro.quant.bitplane`
lays it out.

Words are held in ``torch.int32`` with the same bit pattern as the JAX
package's ``uint32`` (torch on the CPU has no right shift for uint32), so
``packed.numpy().view(np.uint32)`` equals the JAX array bit for bit.
Every right shift here is followed by ``& 1``, which makes it logical.

Two's-complement convention: plane i of a signed w-bit value carries bit i;
the MSB plane (i = w-1) has weight -2^(w-1), the rest +2^i (`coeffs`).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

LANES = 32   # packing factor: bits per packed word


def coeffs(bits: int, signed: bool = True) -> np.ndarray:
    """Per-plane weights (two's complement when signed)."""
    c = np.float32(2.0) ** np.arange(bits, dtype=np.float32)
    if signed:
        c[-1] = -c[-1]
    return c


def quantize(w: torch.Tensor, bits: int, axis: int = 0
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-channel quantization.

    Returns (q, scale): q int32 in [-2^(b-1), 2^(b-1)-1], w ~= q * scale,
    with `scale` shaped like w reduced over `axis` (per-output-channel).
    `torch.round` rounds half to even, as `jnp.round` does.
    """
    qmax = 2.0 ** (bits - 1) - 1
    absmax = w.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(absmax > 0, absmax / qmax,
                        torch.ones_like(absmax)).to(torch.float32)
    q = torch.clamp(torch.round(w / scale), -qmax - 1, qmax).to(torch.int32)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _as_int32(word: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> int32 with the same 32-bit pattern."""
    return (word - ((word >> 31) << 32)).to(torch.int32)


def pack(q: torch.Tensor, bits: int, axis: int = 0) -> torch.Tensor:
    """Pack a signed int tensor into bit planes along `axis`.

    q: int [..., K, ...] with K = shape[axis] divisible by 32.
    Returns int32 [bits, ..., K//32, ...] - plane-major, packed axis
    reduced 32x.  Bit i of lane k lives in word k//32 at position k%32.
    """
    k = q.shape[axis]
    if k % LANES:
        raise ValueError(f"packed axis {k} must be divisible by {LANES}")
    axis = axis % q.dim()
    weights = torch.ones(LANES, dtype=torch.int64, device=q.device) << \
        torch.arange(LANES, device=q.device)
    wshape = [1] * (q.dim() + 1)
    wshape[axis + 1] = LANES
    weights = weights.reshape(wshape)
    shp = list(q.shape)
    shp[axis:axis + 1] = [k // LANES, LANES]
    planes = []
    for i in range(bits):
        bit = ((q >> i) & 1).to(torch.int64).reshape(shp)
        planes.append(_as_int32((bit * weights).sum(dim=axis + 1)))
    return torch.stack(planes, dim=0)


def unpack(packed: torch.Tensor, bits: int, axis: int = 0,
           signed: bool = True) -> torch.Tensor:
    """Inverse of `pack`: planes -> int32 values (axis is pre-pack axis)."""
    vals = None
    for i in range(bits):
        word = packed[i]                                      # [..., K32, ...]
        k = word.shape[axis] * LANES
        expand = torch.repeat_interleave(word, LANES, dim=axis)
        shshape = [1] * expand.dim()
        shshape[axis] = k
        sh = (torch.arange(k, dtype=torch.int32, device=word.device)
              % LANES).reshape(shshape)
        bit = (expand >> sh) & 1
        weight = -(1 << i) if (signed and i == bits - 1) else (1 << i)
        vals = bit * weight if vals is None else vals + bit * weight
    return vals.to(torch.int32)


def quantize_pack(w: torch.Tensor, bits: int, axis: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-step: float weights -> (packed planes, scale)."""
    q, scale = quantize(w, bits, axis=axis)
    return pack(q, bits, axis=axis), scale
