"""Bit-serial reduction on Hopper: the sum of packed signed integers.

    sum = sum_b c_b * sum_w popcount(planes[b, w])      planes [bits, W]

with c_b = 2^b and -2^(bits-1) for the MSB plane, as one f32 scalar.  This
is the port of the Pallas kernel `repro.kernels.bitserial_reduce` (the
paper's reduction benchmark, Sec. IV-C).  The CUDA kernel is
`csrc/bitserial_reduce.cu`; its header says what bounds it on the card and
how the design answers that.

The sum is exact: the kernel and the plain version both count bits in
integers, sum them as int64 and round to f32 once.  The JAX kernel folds
f32 partials, so the two agree exactly while every partial sum is below
2^24 in magnitude (every size the JAX tests use); beyond that the port is
the correctly rounded int64 sum, within one f32 rounding of the exact
value, and the JAX kernel may differ from it by its own roundings.

`bitserial_reduce` is the wrapper.  A tensor on the CPU takes the plain
PyTorch version (`bitserial_reduce_plain`, a SWAR popcount in int64); a
CUDA tensor launches the kernel on the current stream or raises.  Any W is
accepted and 1 <= bits <= 32.  The module-level `launches` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from . import nvcc

SOURCE = Path(__file__).with_name("csrc") / "bitserial_reduce.cu"

launches = 0          # kernel launches since the last reset (set it to 0)
_lib = None


def build() -> Path:
    """Compile the kernel into a shared library, once per source hash
    (`nvcc.build`).  Returns the library's path."""
    return nvcc.build(SOURCE)[0]


def _launcher():
    global _lib
    if _lib is None:
        _lib = nvcc.load(SOURCE, {"bitserial_reduce_launch": [
            ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                    ctypes.c_void_p]})
    return _lib.bitserial_reduce_launch


def _check(packed: torch.Tensor, bits: int) -> None:
    if not 1 <= bits <= 32:
        raise ValueError(f"bits must be in 1..32, got {bits}")
    if packed.dtype != torch.int32 or packed.dim() != 2 or \
            packed.shape[0] != bits:
        raise ValueError(f"packed must be int32 [{bits}, W], got "
                         f"{packed.dtype} {tuple(packed.shape)}")
    if not packed.is_contiguous():
        raise ValueError("packed must be contiguous")


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (int32 holding uint32 bits), as int64."""
    v = words.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def bitserial_reduce_plain(packed: torch.Tensor, *, bits: int
                           ) -> torch.Tensor:
    """The kernel's function in plain PyTorch: int64 counts, one rounding."""
    coeffs = torch.tensor([-(1 << b) if b == bits - 1 else 1 << b
                           for b in range(bits)], dtype=torch.int64,
                          device=packed.device)
    counts = popcount(packed).sum(dim=1)                  # int64 [bits]
    return (counts * coeffs).sum().to(torch.float32)


def bitserial_reduce(packed: torch.Tensor, *, bits: int) -> torch.Tensor:
    """Scalar f32 sum of the signed integers packed in int32 [bits, W].

    CPU tensors take `bitserial_reduce_plain`; CUDA tensors launch the
    kernel on the current stream (no synchronisation) and raise if the
    launch fails.
    """
    global launches
    _check(packed, bits)
    if packed.device.type == "cpu":
        return bitserial_reduce_plain(packed, bits=bits)
    if packed.device.type != "cuda":
        raise ValueError(f"no bit-serial reduce kernel for device "
                         f"{packed.device}")
    w = packed.shape[1]
    if w == 0:
        return torch.zeros((), dtype=torch.float32, device=packed.device)
    out = torch.empty((), dtype=torch.float32, device=packed.device)
    acc = torch.empty((1,), dtype=torch.int64, device=packed.device)
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    err = _launcher()(packed.data_ptr(), acc.data_ptr(), out.data_ptr(), w,
                      bits, stream)
    if err:
        raise RuntimeError(f"bitserial_reduce kernel launch failed: "
                           f"cudaError {err} (W={w}, bits={bits})")
    launches += 1
    return out
