"""Bit-plane matmul: fp activations x w-bit packed weights, on Hopper.

    y[M, N] = (x[M, K] @ sum_i c_i * plane_i) * scale[1, N]

This is the port of the Pallas kernel `repro.kernels.bitplane_matmul`
(CoMeFa's OOOR GEMV with the weights held bit-transposed).  The CUDA
kernel is `csrc/bitplane_matmul.cu`; its header says what bounds it on
the card and how its design answers that.

`bitplane_matmul` is the wrapper.  A tensor on the CPU takes the plain
PyTorch version (`bitplane_matmul_plain`, the same arithmetic: integer
weights, f32 sums, scale last); a CUDA tensor launches the kernel or
raises.  The module-level `launches` counts kernel launches, so a run can
show that its path went through the kernel.

The kernel is compiled by `nvcc` for ``sm_90a`` at first use, from the
source in this package (`nvcc.build`), and called through its plain C
function with `ctypes`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..quant.bitplane import LANES, unpack
from . import nvcc

SOURCE = Path(__file__).with_name("csrc") / "bitplane_matmul.cu"

launches = 0          # kernel launches since the last reset (set it to 0)
_lib = None


def build() -> Path:
    """Compile the kernel into a shared library, once per source hash
    (`nvcc.build`).  Returns the library's path."""
    return nvcc.build(SOURCE)[0]


def _launcher():
    global _lib
    if _lib is None:
        _lib = nvcc.load(SOURCE, {"bitplane_matmul_launch":
                                  [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                                  + [ctypes.c_void_p]})
    return _lib.bitplane_matmul_launch


def _check(x: torch.Tensor, planes: torch.Tensor, scale: torch.Tensor,
           bits: int) -> None:
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"x must be f32 [M, K], got {x.dtype} "
                         f"{tuple(x.shape)}")
    m, k = x.shape
    if k % LANES:
        raise ValueError(f"K={k} must be a multiple of {LANES}")
    if planes.dtype != torch.int32 or planes.dim() != 3 or \
            tuple(planes.shape[:2]) != (bits, k // LANES):
        raise ValueError(f"planes must be int32 [{bits}, {k // LANES}, N], "
                         f"got {planes.dtype} {tuple(planes.shape)}")
    n = planes.shape[2]
    if scale.dtype != torch.float32 or tuple(scale.shape) != (1, n):
        raise ValueError(f"scale must be f32 [1, {n}], got {scale.dtype} "
                         f"{tuple(scale.shape)}")
    if not (x.device == planes.device == scale.device):
        raise ValueError(f"tensors on different devices: x {x.device}, "
                         f"planes {planes.device}, scale {scale.device}")
    if not (x.is_contiguous() and planes.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError("x, planes and scale must be contiguous")


def bitplane_matmul_plain(x: torch.Tensor, planes: torch.Tensor,
                          scale: torch.Tensor, *, bits: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: (x @ Q) * scale in f32."""
    q = unpack(planes, bits, axis=0)                       # [K, N] int32
    return (x.to(torch.float32) @ q.to(torch.float32)) * scale


def bitplane_matmul(x: torch.Tensor, planes: torch.Tensor,
                    scale: torch.Tensor, *, bits: int) -> torch.Tensor:
    """y[M, N] f32 = x[M, K] f32 @ dequant(planes [bits, K/32, N], scale).

    CPU tensors take `bitplane_matmul_plain`; CUDA tensors launch the
    kernel on the current stream (no synchronisation) and raise if the
    launch fails.
    """
    global launches
    _check(x, planes, scale, bits)
    if x.device.type == "cpu":
        return bitplane_matmul_plain(x, planes, scale, bits=bits)
    if x.device.type != "cuda":
        raise ValueError(f"no bit-plane kernel for device {x.device}")
    m, k = x.shape
    n = planes.shape[2]
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0:
        return y
    launch = _launcher()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = launch(x.data_ptr(), planes.data_ptr(), scale.data_ptr(),
                 y.data_ptr(), m, k, n, bits, stream)
    if err:
        raise RuntimeError(f"bitplane_matmul kernel launch failed: "
                           f"cudaError {err} (M={m}, K={k}, N={n}, "
                           f"bits={bits})")
    launches += 1
    return y
