"""Bit-plane matmul: fp activations x w-bit packed weights, on Hopper.

    y[M, N] = (x[M, K] @ sum_i c_i * plane_i) * scale[1, N]

This is the port of the Pallas kernel `repro.kernels.bitplane_matmul`
(CoMeFa's OOOR GEMV with the weights held bit-transposed).  The CUDA
kernel is `csrc/bitplane_matmul.cu`; its header says what bounds it on
the card and how its design answers that.  x is f32 or bf16 and y f32 or
bf16 (``out_dtype``), as the TPU kernel takes x in its own dtype and has
an ``out_dtype``: the kernel widens x in registers and rounds y once, so a
bf16 x gives the same bits as casting it to f32 first, and a bf16 y the
same as casting the f32 result.

`bitplane_matmul` is the wrapper.  A tensor on the CPU takes the plain
PyTorch version (`bitplane_matmul_plain`, the same arithmetic: integer
weights, f32 sums, scale last, then the cast to ``out_dtype``); a CUDA
tensor launches the kernel or raises.  The module-level `launches` counts
kernel launches, so a run can show that its path went through the kernel
(through `launch_count`, so that replays of a recorded step count too).

K is split across at most 8 CTAs (`geometry`), and the splits' partial
sums meet in a fixed order in a thread block cluster, so a result never
changes between runs.

The kernel is compiled by `nvcc` for ``sm_90a`` at first use, from the
source in this package (`nvcc.build`), and called through its plain C
function with `ctypes`.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ..quant.bitplane import LANES, unpack
from . import launch_count, nvcc

SOURCE = Path(__file__).with_name("csrc") / "bitplane_matmul.cu"

# the kernel's tiling (csrc/bitplane_matmul.cu): a CTA owns COLS columns
# and a slice of K; M <= SIMT_MAX_M runs on the CUDA cores in one row
# tile, larger M on the tensor cores in tiles of MMA_ROWS rows; K is split
# so that about CTAS_PER_SM CTAs land on each SM, over at most MAX_CLUSTER
# CTAs (one thread block cluster)
COLS, SIMT_MAX_M, MMA_ROWS, CTAS_PER_SM, MAX_CLUSTER = 32, 8, 32, 2, 8
MAX_BITS = 8
DTYPES = (torch.float32, torch.bfloat16)

launches = 0          # kernel launches since the last reset (set it to 0)
_lib = None


def _count(n: int) -> None:
    global launches
    launches += n


launch_count.register("bitplane_matmul", _count)


def build() -> Path:
    """Compile the kernel into a shared library, once per source hash
    (`nvcc.build`).  Returns the library's path."""
    return nvcc.build(SOURCE)[0]


def _launcher():
    global _lib
    if _lib is None:
        _lib = nvcc.load(SOURCE, {"bitplane_matmul_launch":
                                  [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                                  + [ctypes.c_void_p]})
    return _lib.bitplane_matmul_launch


def geometry(m: int, k: int, n: int, sms: int) -> dict:
    """The kernel's launch on a card of `sms` SMs: the path (``"simt"``
    for M <= 8, else ``"mma"``), column and row tiles, and the K split:
    ``splits`` CTAs (at most MAX_CLUSTER) share K with ``per`` words each,
    so that about CTAS_PER_SM CTAs land on each SM where the cluster
    allows, and none is left without a word."""
    words = k // LANES
    path = "simt" if m <= SIMT_MAX_M else "mma"
    n_tiles = -(-n // COLS)
    m_tiles = 1 if path == "simt" else -(-m // MMA_ROWS)
    want = -(-CTAS_PER_SM * sms // (n_tiles * m_tiles))
    per = -(-words // max(1, min(want, MAX_CLUSTER, words)))
    splits = -(-words // per)
    return {"path": path, "n_tiles": n_tiles, "m_tiles": m_tiles,
            "splits": splits, "per": per,
            "ctas": n_tiles * m_tiles * splits}


@functools.lru_cache(maxsize=None)
def _sms(index) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(x: torch.Tensor, planes: torch.Tensor, scale: torch.Tensor,
           bits: int, out_dtype: torch.dtype = torch.float32) -> None:
    if x.dim() != 2 or x.dtype not in DTYPES:
        raise ValueError(f"x must be f32 or bf16 [M, K], got {x.dtype} "
                         f"{tuple(x.shape)}")
    if out_dtype not in DTYPES:
        raise ValueError(f"out_dtype must be f32 or bf16, got {out_dtype}")
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
                          scale: torch.Tensor, *, bits: int,
                          out_dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """The kernel's function in plain PyTorch: (x @ Q) * scale in f32,
    then cast to `out_dtype`."""
    q = unpack(planes, bits, axis=0)                       # [K, N] int32
    y = (x.to(torch.float32) @ q.to(torch.float32)) * scale
    return y.to(out_dtype)


@torch.library.custom_op("repro_torch::bitplane_matmul", mutates_args=())
def shape_only(x: torch.Tensor, planes: torch.Tensor, scale: torch.Tensor,
               bits: int, out_dtype: torch.dtype) -> torch.Tensor:
    """The kernel's call on meta tensors, as one op with the kernel's
    inputs and output, so that the launch tools' analysis
    (`launch.dryrun`) counts its bytes and work where a card would run
    the kernel.  Only its shape function (below) ever runs."""
    raise RuntimeError("repro_torch::bitplane_matmul takes meta tensors "
                       "only; bitplane_matmul launches the kernel")


@shape_only.register_fake
def _(x, planes, scale, bits, out_dtype):
    return x.new_empty((x.shape[0], planes.shape[2]), dtype=out_dtype)


def bitplane_matmul(x: torch.Tensor, planes: torch.Tensor,
                    scale: torch.Tensor, *, bits: int,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """y[M, N] = x[M, K] @ dequant(planes [bits, K/32, N], scale), as
    `out_dtype`; x and y f32 or bf16.

    CPU tensors take `bitplane_matmul_plain`; CUDA tensors launch the
    kernel on the current stream (no synchronisation) and raise if the
    launch fails; meta tensors (shapes only, no data) give the output's
    shape through `shape_only`, and launch nothing.
    """
    _check(x, planes, scale, bits, out_dtype)
    if x.device.type == "meta":
        return shape_only(x, planes, scale, bits, out_dtype)
    if x.device.type == "cpu":
        return bitplane_matmul_plain(x, planes, scale, bits=bits,
                                     out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no bit-plane kernel for device {x.device}")
    if not 1 <= bits <= MAX_BITS:
        raise ValueError(f"the kernel takes 1-{MAX_BITS} bits, got {bits}")
    m, k = x.shape
    n = planes.shape[2]
    y = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0:
        return y
    if x.data_ptr() % 16:           # the kernel stages x 16 bytes a copy
        x = x.clone()
    geo = geometry(m, k, n, _sms(x.device.index))
    launch = _launcher()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = launch(x.data_ptr(), planes.data_ptr(), scale.data_ptr(),
                 y.data_ptr(), m, k, n, bits, int(x.dtype == torch.bfloat16),
                 int(out_dtype == torch.bfloat16), geo["per"], geo["splits"],
                 stream)
    if err:
        raise RuntimeError(f"bitplane_matmul kernel launch failed: "
                           f"cudaError {err} (M={m}, K={k}, N={n}, "
                           f"bits={bits}, {geo})")
    launch_count.launched("bitplane_matmul")
    return y
