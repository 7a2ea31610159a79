"""CoMeFa simulator step: T encoded instructions on packed state, on Hopper.

This is the port of the Pallas kernel `repro.kernels.comefa_step`
(`run_packed`), which runs the bit-packed engine's datapath
(`core.comefa.engine_packed.datapath`) for a whole instruction stream in
one call.  The CUDA kernel is `csrc/comefa_step.cu`; its header says what
bounds it on the card (the dependent chain of T instructions, not bytes)
and how its design answers that.

`run_packed` is the wrapper, behind the grid's ``"cuda"`` engine.  A
tensor on the CPU takes the plain PyTorch version (`run_packed_plain`,
the word-parallel torch scan of the ``"packed"`` engine); a CUDA tensor
launches the kernel or raises.  Both update ``mem``, ``carry`` and
``mask`` in place and return them.  The module-level `launches` counts
kernel launches, so a run can show that its path went through the
kernel.

The kernel is compiled by `nvcc` for ``sm_90a`` at first use, from the
source in this package (`nvcc.build`), and called through its plain C
function with `ctypes`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..core.comefa import isa
from ..core.comefa.engine_packed import (N_WORDS, _run_packed,
                                         _run_slotwise_packed)
from . import nvcc

SOURCE = Path(__file__).with_name("csrc") / "comefa_step.cu"

launches = 0          # kernel launches since the last reset (set it to 0)
_lib = None


def build() -> Path:
    """Compile the kernel into a shared library, once per source hash
    (`nvcc.build`).  Returns the library's path."""
    return nvcc.build(SOURCE)[0]


def _launcher():
    global _lib
    if _lib is None:
        _lib = nvcc.load(SOURCE, {"comefa_step_launch":
                                  [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                                  + [ctypes.c_void_p]})
    return _lib.comefa_step_launch


def _check(mem: torch.Tensor, carry: torch.Tensor, mask: torch.Tensor,
           prog: torch.Tensor, per_slot: bool) -> None:
    if mem.dim() != 4 or mem.shape[2:] != (isa.N_ROWS, N_WORDS):
        raise ValueError(f"mem must be [S, nb, {isa.N_ROWS}, {N_WORDS}], "
                         f"got {tuple(mem.shape)}")
    s, nb = mem.shape[:2]
    for name, t in (("carry", carry), ("mask", mask)):
        if tuple(t.shape) != (s, nb, N_WORDS):
            raise ValueError(f"{name} must be [{s}, {nb}, {N_WORDS}], got "
                             f"{tuple(t.shape)}")
    lead = (s,) if per_slot else ()
    if prog.dim() != len(lead) + 2 or tuple(prog.shape[:-2]) != lead or \
            prog.shape[-1] != isa.N_ENGINE_FIELDS:
        want = "[S, T, F]" if per_slot else "[T, F]"
        raise ValueError(f"prog must be {want} with F = "
                         f"{isa.N_ENGINE_FIELDS}, got {tuple(prog.shape)}")
    for name, t in (("mem", mem), ("carry", carry), ("mask", mask),
                    ("prog", prog)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != mem.device:
            raise ValueError(f"tensors on different devices: mem "
                             f"{mem.device}, {name} {t.device}")


def run_packed_plain(mem: torch.Tensor, carry: torch.Tensor,
                     mask: torch.Tensor, prog: torch.Tensor, *,
                     chain: bool, per_slot: bool):
    """The kernel's function in plain PyTorch: the packed engine's scan."""
    _check(mem, carry, mask, prog, per_slot)
    run = _run_slotwise_packed if per_slot else _run_packed
    return run(mem, carry, mask, prog, chain)


def run_packed(mem: torch.Tensor, carry: torch.Tensor, mask: torch.Tensor,
               prog: torch.Tensor, *, chain: bool, per_slot: bool):
    """Execute a packed program matrix on every slot, in place.

    mem ``[S, nb, 128, 5]`` int32, carry/mask ``[S, nb, 5]`` int32; prog
    int32 ``[T, F]`` (shared) or ``[S, T, F]`` (``per_slot=True``).
    Returns ``(mem, carry, mask)``.  CPU tensors take `run_packed_plain`;
    CUDA tensors launch the kernel on the current stream (no
    synchronisation) and raise if the launch fails.
    """
    global launches
    _check(mem, carry, mask, prog, per_slot)
    if mem.device.type == "cpu":
        return run_packed_plain(mem, carry, mask, prog, chain=chain,
                                per_slot=per_slot)
    if mem.device.type != "cuda":
        raise ValueError(f"no CoMeFa step kernel for device {mem.device}")
    s, nb = mem.shape[:2]
    t = prog.shape[-2]
    if t == 0:
        return mem, carry, mask
    if prog.data_ptr() % 16:
        raise ValueError("prog must be 16-byte aligned")
    launch = _launcher()
    stream = torch.cuda.current_stream(mem.device).cuda_stream
    err = launch(mem.data_ptr(), carry.data_ptr(), mask.data_ptr(),
                 prog.data_ptr(), s, nb, t, int(chain), int(per_slot),
                 stream)
    if err:
        raise RuntimeError(f"comefa_step kernel launch failed: cudaError "
                           f"{err} (S={s}, nb={nb}, T={t}, chain={chain}, "
                           f"per_slot={per_slot})")
    launches += 1
    return mem, carry, mask
