"""Public wrappers around the port's kernels (the JAX `kernels.ops` API).

They keep the JAX wrappers' names and keyword arguments (`bits`, `key`,
`a_bits`, `w_bits`, `signed`) and drop `interpret` and the `block_*`
sizes, whose only job was the Pallas grid.  Where each call runs follows
its operand's device: a CPU tensor takes the kernel's plain PyTorch
version, a CUDA tensor launches the kernel or raises (see each kernel's
module).

Unlike the JAX wrappers, which pad only M and need the other sizes to be
multiples of their blocks, these take any M and N, any K and N that are
multiples of 32 where they are packed, and any word count W: the kernels
mask their ragged edges themselves.  Packed words are int32 holding the
JAX package's uint32 bits.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..quant import bitplane
from . import bit_transpose as _bt
from . import bitplane_matmul as _bpm
from . import bitserial_matmul as _bsm
from . import bitserial_reduce as _bsr
from . import bulk_bitwise as _bb


def bitplane_matmul(x: torch.Tensor, w_packed: torch.Tensor,
                    scale: torch.Tensor, *, bits: int,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """y[M, N] = x[M, K] @ dequant(w_packed, scale), as `out_dtype`.

    An f32 or bf16 x goes to the kernel as it is, which widens it in
    registers, and an f32 or bf16 `out_dtype` is the kernel's own rounding:
    one launch, no cast around it.  Other float types are cast to f32
    first and the f32 result to `out_dtype` after.  Where it runs follows
    `x.device` (see `kernels.bitplane_matmul`).
    """
    if x.dtype not in _bpm.DTYPES:
        x = x.to(torch.float32)
    direct = out_dtype in _bpm.DTYPES
    y = _bpm.bitplane_matmul(x.contiguous(), w_packed.contiguous(),
                             scale.contiguous(), bits=bits,
                             out_dtype=out_dtype if direct else torch.float32)
    return y if direct else y.to(out_dtype)


def bitserial_matmul(x_packed: torch.Tensor, w_packed: torch.Tensor,
                     x_scale: torch.Tensor, w_scale: torch.Tensor, *,
                     a_bits: int, w_bits: int,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """y[M, N] = dequant(x_packed, x_scale) @ dequant(w_packed, w_scale).

    x_packed int32 [M, a_bits, K/32] (`bitplane.pack` along K of the [M, K]
    ints, plane axis moved to 1), w_packed int32 [w_bits, K/32, N], x_scale
    f32 [M, 1] per row, w_scale f32 [1, N] per column.
    """
    y = _bsm.bitserial_matmul(x_packed.contiguous(), w_packed.contiguous(),
                              x_scale.contiguous(), w_scale.contiguous(),
                              a_bits=a_bits, w_bits=w_bits)
    return y.to(out_dtype)


def quantized_matmul(x: torch.Tensor, w: torch.Tensor, *, bits: int,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Quantize w per column to `bits`, pack, run the bit-plane kernel."""
    packed, scale = bitplane.quantize_pack(w, bits, axis=0)
    return bitplane_matmul(x, packed, scale, bits=bits, out_dtype=out_dtype)


def search_replace(packed: torch.Tensor, *, bits: int, key: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero the records equal to `key` in planes int32 [bits, W]; returns
    (planes, match mask int32 [W])."""
    return _bb.search_replace(packed.contiguous(), bits=bits, key=key)


def raid_xor(stripes: torch.Tensor) -> torch.Tensor:
    """The lost stripe: XOR of the survivors and parity, int32 [D, W]."""
    return _bb.raid_xor(stripes.contiguous())


def bitserial_reduce(packed: torch.Tensor, *, bits: int) -> torch.Tensor:
    """Scalar f32 sum of the signed ints packed in int32 [bits, W]."""
    return _bsr.bitserial_reduce(packed.contiguous(), bits=bits)


def bit_transpose(x: torch.Tensor, *, bits: int) -> torch.Tensor:
    """Element-major int32 [N] -> packed planes int32 [bits, N/32]."""
    return _bt.bit_transpose(x.contiguous(), bits=bits)


def bit_untranspose(packed: torch.Tensor, *, bits: int,
                    signed: bool = True) -> torch.Tensor:
    """Packed planes int32 [bits, W] -> element-major int32 [32W]."""
    return _bt.bit_untranspose(packed.contiguous(), bits=bits, signed=signed)
