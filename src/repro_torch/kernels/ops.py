"""Public wrapper around the bit-plane kernel.

Unlike the JAX package's `ops.bitplane_matmul`, which pads M and needs K
and N to be multiples of its 128-wide blocks, this takes any M and N and
any K that is a multiple of 32: the kernel masks the ragged edges itself.
"""
from __future__ import annotations

import torch

from . import bitplane_matmul as _bpm


def bitplane_matmul(x: torch.Tensor, w_packed: torch.Tensor,
                    scale: torch.Tensor, *, bits: int,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """y[M, N] = x[M, K] @ dequant(w_packed, scale), as `out_dtype`.

    x may be any float type and layout; the kernel sees a contiguous f32
    copy.  Where it runs follows `x.device` (see `kernels.bitplane_matmul`).
    """
    y = _bpm.bitplane_matmul(x.to(torch.float32).contiguous(),
                             w_packed.contiguous(), scale.contiguous(),
                             bits=bits)
    return y.to(out_dtype)
