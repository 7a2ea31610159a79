"""Bulk bitwise kernels on Hopper: database search-replace and RAID rebuild.

    search_replace: planes [bits, W] (records bit-transposed, 32 a word)
                    -> (planes with every record equal to `key` zeroed,
                        match mask [W]: bit k of word w set iff record
                        32w+k == key)
    raid_xor:       stripes [D, W] -> their XOR, [W]

This is the port of the Pallas kernels `repro.kernels.bulk_bitwise`
(`search_replace` and `raid_xor`), the paper's on-chip-bandwidth
benchmarks (Sec. IV-C).  The CUDA kernels are in `csrc/bulk_bitwise.cu`;
its header says what bounds them on the card and how the design answers
that.  Words, the mask included, are int32 holding the JAX package's
uint32 bits.  The key is a launch argument: one build serves every key.

`search_replace` and `raid_xor` are the wrappers.  A tensor on the CPU
takes the plain PyTorch version (the same word-parallel XOR/OR fold); a
CUDA tensor launches the kernel on the current stream or raises.  Any W is
accepted (the JAX wrappers need W <= 512 or W % 512 == 0).  The
module-level `launches` counts kernel launches per kernel name.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import torch

from . import nvcc

SOURCE = Path(__file__).with_name("csrc") / "bulk_bitwise.cu"

# kernel launches since the last reset (set each to 0)
launches = {"search_replace": 0, "raid_xor": 0}
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
            "search_replace_launch": [ptr, ptr, ptr, i64, i32, ctypes.c_uint,
                                      ptr],
            "raid_xor_launch": [ptr, ptr, i64, i32, ptr]})
    return getattr(_lib, f"{name}_launch")


def _check_words(t: torch.Tensor, name: str, rows: str) -> None:
    if t.dtype != torch.int32 or t.dim() != 2:
        raise ValueError(f"{name} must be int32 [{rows}, W], got {t.dtype} "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_search(packed: torch.Tensor, bits: int) -> None:
    if not 1 <= bits <= 32:
        raise ValueError(f"bits must be in 1..32, got {bits}")
    _check_words(packed, "packed", str(bits))
    if packed.shape[0] != bits:
        raise ValueError(f"packed has {packed.shape[0]} planes, bits={bits}")


def _key_words(key: int, bits: int, device) -> torch.Tensor:
    """int32 [bits, 1]: all ones where bit i of `key` is set, else 0."""
    return torch.tensor([[-((key >> i) & 1)] for i in range(bits)],
                        dtype=torch.int32, device=device)


def search_replace_plain(packed: torch.Tensor, *, bits: int, key: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch."""
    diff = functools.reduce(torch.bitwise_or,
                            packed ^ _key_words(key, bits, packed.device))
    return packed & diff, ~diff


def raid_xor_plain(stripes: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: a fold of D - 1 XORs."""
    return functools.reduce(torch.bitwise_xor, stripes[1:],
                            stripes[0].clone())


def search_replace(packed: torch.Tensor, *, bits: int, key: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero the records equal to `key`; also return the match mask.

    packed int32 [bits, W] -> (int32 [bits, W], int32 [W]).  Only the low
    `bits` bits of `key` are read.  CPU tensors take
    `search_replace_plain`; CUDA tensors launch the kernel on the current
    stream (no synchronisation) and raise if the launch fails.
    """
    _check_search(packed, bits)
    if packed.device.type == "cpu":
        return search_replace_plain(packed, bits=bits, key=key)
    if packed.device.type != "cuda":
        raise ValueError(f"no search-replace kernel for device "
                         f"{packed.device}")
    w = packed.shape[1]
    out = torch.empty_like(packed)
    mask = torch.empty((w,), dtype=torch.int32, device=packed.device)
    if w == 0:
        return out, mask
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    err = _launcher("search_replace")(packed.data_ptr(), out.data_ptr(),
                                      mask.data_ptr(), w, bits,
                                      key & 0xFFFFFFFF, stream)
    if err:
        raise RuntimeError(f"search_replace kernel launch failed: cudaError "
                           f"{err} (W={w}, bits={bits})")
    launches["search_replace"] += 1
    return out, mask


def raid_xor(stripes: torch.Tensor) -> torch.Tensor:
    """XOR of the D stripes: int32 [D, W] -> int32 [W].

    CPU tensors take `raid_xor_plain`; CUDA tensors launch the kernel on
    the current stream (no synchronisation) and raise if the launch fails.
    """
    _check_words(stripes, "stripes", "D")
    d, w = stripes.shape
    if d == 0:
        raise ValueError("raid_xor needs at least one stripe")
    if stripes.device.type == "cpu":
        return raid_xor_plain(stripes)
    if stripes.device.type != "cuda":
        raise ValueError(f"no RAID XOR kernel for device {stripes.device}")
    out = torch.empty((w,), dtype=torch.int32, device=stripes.device)
    if w == 0:
        return out
    stream = torch.cuda.current_stream(stripes.device).cuda_stream
    err = _launcher("raid_xor")(stripes.data_ptr(), out.data_ptr(), w, d,
                                stream)
    if err:
        raise RuntimeError(f"raid_xor kernel launch failed: cudaError {err} "
                           f"(D={d}, W={w})")
    launches["raid_xor"] += 1
    return out
