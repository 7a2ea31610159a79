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
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

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
    `x.device` (see `kernels.bitplane_matmul`).  Placed planes (a
    `DTensor`) run the kernel on each rank's shards (`_placed`).
    """
    if isinstance(w_packed, DTensor):
        return _placed(x, w_packed, scale, bits, out_dtype)
    if x.dtype not in _bpm.DTYPES:
        x = x.to(torch.float32)
    direct = out_dtype in _bpm.DTYPES
    y = _bpm.bitplane_matmul(x.contiguous(), w_packed.contiguous(),
                             scale.contiguous(), bits=bits,
                             out_dtype=out_dtype if direct else torch.float32)
    return y if direct else y.to(out_dtype)


def _is_shard(p, dim: int) -> bool:
    return isinstance(p, Shard) and p.dim == dim


def _placed(x: torch.Tensor, w_packed: DTensor, scale: torch.Tensor,
            bits: int, out_dtype: torch.dtype) -> DTensor:
    """`bitplane_matmul` on placed planes [bits, K/32, N]: each rank runs
    the kernel (its plain version on the CPU) on its own shards, through
    `local_map`.  On a mesh dim where the planes are sharded on N, x is
    replicated and y comes back ``Shard(1)``; where they are sharded on
    K/32, x is sharded on K alike and y is ``Partial()`` (each rank's sum
    over its slice of K); elsewhere x's rows keep their sharding."""
    mesh = w_packed.device_mesh
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    x_in, y_out, s_in = [], [], []
    for p, xp in zip(w_packed.placements, x.placements):
        if _is_shard(p, 1):
            x_in.append(Shard(1))
            y_out.append(Partial())
            s_in.append(Replicate())
        elif _is_shard(p, 2):
            x_in.append(Replicate())
            y_out.append(Shard(1))
            s_in.append(Shard(1))
        else:
            keep = xp if _is_shard(xp, 0) else Replicate()
            x_in.append(keep)
            y_out.append(keep)
            s_in.append(Replicate())

    def local(xl, wl, sl):
        return bitplane_matmul(xl.contiguous(), wl, sl, bits=bits,
                               out_dtype=out_dtype)
    return local_map(local, out_placements=y_out,
                     in_placements=(tuple(x_in), tuple(w_packed.placements),
                                    tuple(s_in)),
                     device_mesh=mesh, redistribute_inputs=True)(
                         x, w_packed, scale)


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
