"""w-bit symmetric quantisation, written for the reference.

Per output channel for weights (the absolute maximum over the input axis
maps to 2^(w-1) - 1), per row for activations.  Rounding is half to
even, and the clip keeps the two's-complement low end -2^(w-1).

A scale is the float32 quotient absmax / (2^(w-1) - 1).  For a weight it
is taken as a float32 division on the weight's device, which is how the
served weights' scales are taken (on a CUDA device a division by a
constant multiplies by its reciprocal, one unit in the last place from
the rounded quotient at times); for an activation row it is the rounded
quotient itself, as a host-side quantiser computes it.
"""
from __future__ import annotations

from typing import Tuple

import torch


def quantize(t: torch.Tensor, bits: int, axis: int,
             rounded_scale: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q, scale) with t ~= q * scale: q integer-valued float32 in
    [-2^(bits-1), 2^(bits-1) - 1], scale float32 reduced over `axis`
    (kept as a size-1 axis); an all-zero slice gets scale 1.  With
    `rounded_scale` the scale is the rounded quotient (taken in float64,
    which rounds to the same float32)."""
    t = t.to(torch.float32)
    qmax = float(2 ** (bits - 1) - 1)
    absmax = t.abs().amax(dim=axis, keepdim=True)
    quotient = (absmax.double() / qmax).float() if rounded_scale \
        else absmax / qmax
    scale = torch.where(absmax > 0, quotient, torch.ones_like(absmax))
    q = torch.clamp(torch.round(t / scale), -qmax - 1, qmax)
    return q, scale


def dequantized_weight(w: torch.Tensor, bits: int) -> torch.Tensor:
    """The weight [K, N] a w-bit projection multiplies by, in float32."""
    q, scale = quantize(w, bits, axis=0)
    return q * scale
