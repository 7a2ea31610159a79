"""Bit transpose (swizzle) and its inverse, on Hopper.

    bit_transpose:   x int32 [N] -> planes int32 [bits, N/32]
                     (bit i of element 32w+k is bit k of word [i, w])
    bit_untranspose: planes [bits, W] -> int32 [32W], the MSB weighing
                     -2^(bits-1) when ``signed``

This is the port of the Pallas kernels `repro.kernels.bit_transpose`
(`bit_transpose` and `bit_untranspose`), the paper's swizzle module between
element-major integers and the packed bit-planes (Sec. III-H).  The CUDA
kernels are in `csrc/bit_transpose.cu`; its header says what bounds them on
the card and how the design answers that.  Words are int32 holding the JAX
package's uint32 bits.

`bit_transpose` and `bit_untranspose` are the wrappers.  A tensor on the
CPU takes the plain PyTorch version (`bit_transpose_plain` is
`quant.bitplane.pack` along the element axis; `bit_untranspose_plain`
sums the shifted bits); a CUDA tensor launches the kernel on the current
stream or raises.  Unlike the JAX wrappers, which need N to be a multiple
of their 8192-element blocks, these take any N that is a multiple of 32
and 1 <= bits <= 32.  The module-level `launches` counts kernel launches
per kernel name, so a run can show that its path went through them.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..quant.bitplane import LANES, _as_int32, pack
from . import nvcc

SOURCE = Path(__file__).with_name("csrc") / "bit_transpose.cu"

# kernel launches since the last reset (set each to 0)
launches = {"bit_transpose": 0, "bit_untranspose": 0}
_lib = None


def build() -> Path:
    """Compile the kernels into a shared library, once per source hash
    (`nvcc.build`).  Returns the library's path."""
    return nvcc.build(SOURCE)[0]


def _launcher(name: str):
    global _lib
    if _lib is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        _lib = nvcc.load(SOURCE, {
            "bit_transpose_launch": [ptr, ptr, i64, i32, ptr],
            "bit_untranspose_launch": [ptr, ptr, i64, i32, i32, ptr]})
    return getattr(_lib, f"{name}_launch")


def _check_bits(bits: int) -> None:
    if not 1 <= bits <= 32:
        raise ValueError(f"bits must be in 1..32, got {bits}")


def _check_elements(x: torch.Tensor, bits: int) -> None:
    _check_bits(bits)
    if x.dtype != torch.int32 or x.dim() != 1:
        raise ValueError(f"x must be int32 [N], got {x.dtype} "
                         f"{tuple(x.shape)}")
    if x.shape[0] % LANES:
        raise ValueError(f"N={x.shape[0]} must be a multiple of {LANES}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")


def _check_planes(packed: torch.Tensor, bits: int) -> None:
    _check_bits(bits)
    if packed.dtype != torch.int32 or packed.dim() != 2 or \
            packed.shape[0] != bits:
        raise ValueError(f"packed must be int32 [{bits}, W], got "
                         f"{packed.dtype} {tuple(packed.shape)}")
    if not packed.is_contiguous():
        raise ValueError("packed must be contiguous")


def bit_transpose_plain(x: torch.Tensor, *, bits: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: `pack` along the elements."""
    return pack(x, bits, axis=0)


def bit_untranspose_plain(packed: torch.Tensor, *, bits: int,
                          signed: bool = True) -> torch.Tensor:
    """The kernel's function in plain PyTorch: weighted bits in int64,
    wrapped to int32 (only ``bits == 32`` unsigned wraps)."""
    shifts = torch.arange(LANES, dtype=torch.int32, device=packed.device)
    vals = torch.zeros((packed.shape[1], LANES), dtype=torch.int64,
                       device=packed.device)
    for i in range(bits):
        bit = ((packed[i][:, None] >> shifts) & 1).to(torch.int64)
        weight = -(1 << i) if (signed and i == bits - 1) else (1 << i)
        vals += bit * weight
    return _as_int32(vals.reshape(-1) & 0xFFFFFFFF)


def bit_transpose(x: torch.Tensor, *, bits: int) -> torch.Tensor:
    """Element-major int32 [N] -> packed planes int32 [bits, N/32].

    CPU tensors take `bit_transpose_plain`; CUDA tensors launch the kernel
    on the current stream (no synchronisation) and raise if the launch
    fails.
    """
    _check_elements(x, bits)
    if x.device.type == "cpu":
        return bit_transpose_plain(x, bits=bits)
    if x.device.type != "cuda":
        raise ValueError(f"no bit-transpose kernel for device {x.device}")
    n = x.shape[0]
    planes = torch.empty((bits, n // LANES), dtype=torch.int32,
                         device=x.device)
    if n == 0:
        return planes
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _launcher("bit_transpose")(x.data_ptr(), planes.data_ptr(), n,
                                     bits, stream)
    if err:
        raise RuntimeError(f"bit_transpose kernel launch failed: cudaError "
                           f"{err} (N={n}, bits={bits})")
    launches["bit_transpose"] += 1
    return planes


def bit_untranspose(packed: torch.Tensor, *, bits: int,
                    signed: bool = True) -> torch.Tensor:
    """Packed planes int32 [bits, W] -> element-major int32 [32W].

    CPU tensors take `bit_untranspose_plain`; CUDA tensors launch the
    kernel on the current stream (no synchronisation) and raise if the
    launch fails.
    """
    _check_planes(packed, bits)
    if packed.device.type == "cpu":
        return bit_untranspose_plain(packed, bits=bits, signed=signed)
    if packed.device.type != "cuda":
        raise ValueError(f"no bit-untranspose kernel for device "
                         f"{packed.device}")
    w = packed.shape[1]
    out = torch.empty((w * LANES,), dtype=torch.int32, device=packed.device)
    if w == 0:
        return out
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    err = _launcher("bit_untranspose")(packed.data_ptr(), out.data_ptr(), w,
                                       bits, int(signed), stream)
    if err:
        raise RuntimeError(f"bit_untranspose kernel launch failed: "
                           f"cudaError {err} (W={w}, bits={bits}, "
                           f"signed={signed})")
    launches["bit_untranspose"] += 1
    return out
