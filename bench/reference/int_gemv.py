"""The exact integer GEMV of a projection with quantised activations.

Each row of x is quantised to `x_bits` (symmetric, per row) and the
weight to `w_bits` (per output column); the product of the two integer
matrices is exact, since every partial sum is an integer of magnitude
below 2^(w_bits + x_bits - 2) * K < 2^53 and so float64 holds it in any
order.  The result is dequantised in float32 as
``float32(acc) * (scale_w * scale_x)``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import quant


def integer_product(q_x: torch.Tensor, q_w: torch.Tensor) -> torch.Tensor:
    """q_x [M, K] @ q_w [K, N] of integer-valued tensors, exactly, as
    int64."""
    k = q_x.shape[-1]
    worst = float(q_x.abs().max()) * float(q_w.abs().max()) * k
    if worst >= 2.0 ** 53:
        raise ValueError(f"|acc| may reach {worst:.3g}: not exact in "
                         "float64")
    return (q_x.to(torch.float64) @ q_w.to(torch.float64)).to(torch.int64)


def w8a8_linear(x: torch.Tensor, w: torch.Tensor, w_bits: int,
                x_bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """y [M, N] float32 of a projection whose activations and weights are
    both quantised, and the integer accumulator [M, N] it came from."""
    q_x, s_x = quant.quantize(x.to(torch.float32), x_bits, axis=1,
                              rounded_scale=True)
    q_w, s_w = quant.quantize(w, w_bits, axis=0)
    acc = integer_product(q_x, q_w)
    y = acc.to(torch.float32) * (s_w * s_x)
    return y, acc
