"""Fully bit-serial matmul on Hopper: both operands packed, popcount sums.

    y[m, n] = sx[m] * sw[n] * sum_{j<a, i<w} ca_j * cw_i *
              sum_k popcount(xp[m, j, k] & wp[i, k, n])

with c_b = 2^b and -2^(bits-1) for the MSB plane.  This is the port of the
Pallas kernel `repro.kernels.bitserial_matmul`, CoMeFa's
two-operands-in-RAM multiply (paper Sec. III-E).  The CUDA kernel is
`csrc/bitserial_matmul.cu`: binary tensor-core MMAs (``mma.sync``
m16n8k256 ``.b1`` with ``.and.popc``) on the planes stacked into the
MMA's rows and columns, K split across a thread block cluster, one launch
a call with no scratch.  Its header says what bounds the function on the
card (its bytes) and how the design answers that.

The double sum is an exact integer in both the kernel and the plain
version; it is rounded to f32 once and scaled as the JAX kernel scales it,
``(float(acc) * sx) * sw``, so the two agree bit for bit.  The kernel keeps
the sum in 32-bit integers, exact while the true sum fits in int32: the
wrapper rejects K * 2^(a+w-2) >= 2^31, the largest |x_int . w_int| a
K-long product of a-bit and w-bit signed values can reach.  The JAX kernel
sums in f32, so it agrees exactly while every partial sum is below 2^24.

`bitserial_matmul` is the wrapper.  A tensor on the CPU takes the plain
PyTorch version (`bitserial_matmul_plain`: unpack both operands, an exact
f64 product, the same rounding and scaling); a CUDA tensor launches the
kernel on the current stream or raises.  Any M and N and any K a multiple
of 32 are accepted, with 1 <= a, w <= 8 (the JAX wrapper needs N % 128 ==
0 and K % 512 == 0 once K >= 512).  The module-level `launches` counts
kernel launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..quant.bitplane import LANES, unpack
from . import nvcc

SOURCE = Path(__file__).with_name("csrc") / "bitserial_matmul.cu"
MAX_BITS = 8
# the kernel's tiling (csrc/bitserial_matmul.cu): a CTA owns ROW_TILES m16
# and COL_TILES n8 MMA tiles; a k256 step is STEP_WORDS words of K; K is
# split over a cluster of at most MAX_CLUSTER CTAs, aiming at
# CTAS_PER_SM CTAs on each SM
ROW_TILES, COL_TILES, STEP_WORDS = 2, 8, 8
MAX_CLUSTER, CTAS_PER_SM = 8, 4

launches = 0          # kernel launches since the last reset (set it to 0)
_lib = None


def build() -> Path:
    """Compile the kernel into a shared library, once per source hash
    (`nvcc.build`).  Returns the library's path."""
    return nvcc.build(SOURCE)[0]


def _launcher():
    global _lib
    if _lib is None:
        _lib = nvcc.load(SOURCE, {"bitserial_matmul_launch":
                                  [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                                  + [ctypes.c_void_p]})
    return _lib.bitserial_matmul_launch


def geometry(m: int, k: int, n: int, a_bits: int, w_bits: int,
             sms: int) -> dict:
    """The kernel's launch on a card of `sms` SMs: column and row tiles
    (each n8 tile holds 8 // w_bits whole output columns, each m16 tile
    16 // a_bits whole rows), the k256 steps of K, and ``splits``, the
    cluster's CTAs that share K with ``per`` steps each, so that about
    CTAS_PER_SM CTAs land on each SM and none is left without a step."""
    m_tiles = -(-m // (ROW_TILES * (16 // a_bits)))
    n_tiles = -(-n // (COL_TILES * (8 // w_bits)))
    steps = -(-k // (32 * STEP_WORDS))
    want = -(-CTAS_PER_SM * sms // (m_tiles * n_tiles))
    splits = max(1, min(want, MAX_CLUSTER, steps))
    per = -(-steps // splits)
    splits = -(-steps // per)
    return {"m_tiles": m_tiles, "n_tiles": n_tiles, "steps": steps,
            "splits": splits, "per": per,
            "ctas": m_tiles * n_tiles * splits}


_SMS: dict = {}


def _sms(device: torch.device) -> int:
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device]


def _check(x_packed: torch.Tensor, w_packed: torch.Tensor,
           x_scale: torch.Tensor, w_scale: torch.Tensor, a_bits: int,
           w_bits: int) -> None:
    for name, b in (("a_bits", a_bits), ("w_bits", w_bits)):
        if not 1 <= b <= MAX_BITS:
            raise ValueError(f"{name} must be in 1..{MAX_BITS}, got {b}")
    if x_packed.dtype != torch.int32 or x_packed.dim() != 3 or \
            x_packed.shape[1] != a_bits:
        raise ValueError(f"x_packed must be int32 [M, {a_bits}, K/32], got "
                         f"{x_packed.dtype} {tuple(x_packed.shape)}")
    m, _, k32 = x_packed.shape
    if w_packed.dtype != torch.int32 or w_packed.dim() != 3 or \
            tuple(w_packed.shape[:2]) != (w_bits, k32):
        raise ValueError(f"w_packed must be int32 [{w_bits}, {k32}, N], got "
                         f"{w_packed.dtype} {tuple(w_packed.shape)}")
    n = w_packed.shape[2]
    if x_scale.dtype != torch.float32 or tuple(x_scale.shape) != (m, 1):
        raise ValueError(f"x_scale must be f32 [{m}, 1], got "
                         f"{x_scale.dtype} {tuple(x_scale.shape)}")
    if w_scale.dtype != torch.float32 or tuple(w_scale.shape) != (1, n):
        raise ValueError(f"w_scale must be f32 [1, {n}], got "
                         f"{w_scale.dtype} {tuple(w_scale.shape)}")
    k = k32 * LANES
    if k << (a_bits + w_bits - 2) >= 1 << 31:
        raise ValueError(f"K={k} at {a_bits}x{w_bits} bits can overflow the "
                         f"kernel's int32 sum (K * 2^(a+w-2) >= 2^31)")
    ts = (x_packed, w_packed, x_scale, w_scale)
    if any(t.device != x_packed.device for t in ts):
        raise ValueError("tensors on different devices: " + ", ".join(
            str(t.device) for t in ts))
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("x_packed, w_packed, x_scale and w_scale must be "
                         "contiguous")


def bitserial_matmul_plain(x_packed: torch.Tensor, w_packed: torch.Tensor,
                           x_scale: torch.Tensor, w_scale: torch.Tensor, *,
                           a_bits: int, w_bits: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the integer product (exact
    in f64), rounded to f32 once, then ``* x_scale * w_scale``."""
    qx = unpack(x_packed.movedim(1, 0), a_bits, axis=1)        # [M, K]
    qw = unpack(w_packed, w_bits, axis=0)                      # [K, N]
    acc = qx.to(torch.float64) @ qw.to(torch.float64)
    return acc.to(torch.float32) * x_scale * w_scale


def bitserial_matmul(x_packed: torch.Tensor, w_packed: torch.Tensor,
                     x_scale: torch.Tensor, w_scale: torch.Tensor, *,
                     a_bits: int, w_bits: int) -> torch.Tensor:
    """y[M, N] f32 from x_packed int32 [M, a_bits, K/32], w_packed int32
    [w_bits, K/32, N], x_scale f32 [M, 1] and w_scale f32 [1, N].

    CPU tensors take `bitserial_matmul_plain`; CUDA tensors launch the
    kernel on the current stream (no synchronisation) and raise if the
    launch fails.
    """
    global launches
    _check(x_packed, w_packed, x_scale, w_scale, a_bits, w_bits)
    if x_packed.device.type == "cpu":
        return bitserial_matmul_plain(x_packed, w_packed, x_scale, w_scale,
                                      a_bits=a_bits, w_bits=w_bits)
    if x_packed.device.type != "cuda":
        raise ValueError(f"no bit-serial matmul kernel for device "
                         f"{x_packed.device}")
    m, _, k32 = x_packed.shape
    n = w_packed.shape[2]
    if m == 0 or n == 0 or k32 == 0:
        return torch.zeros((m, n), dtype=torch.float32,
                           device=x_packed.device)
    y = torch.empty((m, n), dtype=torch.float32, device=x_packed.device)
    geo = geometry(m, k32 * LANES, n, a_bits, w_bits, _sms(x_packed.device))
    stream = torch.cuda.current_stream(x_packed.device).cuda_stream
    err = _launcher()(x_packed.data_ptr(), w_packed.data_ptr(),
                      x_scale.data_ptr(), w_scale.data_ptr(), y.data_ptr(),
                      m, k32 * LANES, n, a_bits, w_bits, geo["splits"],
                      stream)
    if err:
        raise RuntimeError(f"bitserial_matmul kernel launch failed: "
                           f"cudaError {err} (M={m}, K={k32 * LANES}, N={n}, "
                           f"a_bits={a_bits}, w_bits={w_bits})")
    launches += 1
    return y
