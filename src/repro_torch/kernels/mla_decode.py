"""Absorbed multi-head latent attention decode on Hopper: one query token
a slot over that slot's latent cache.

    s_h(t) = scale * q[b, h] . [ckv[b, t], kpe[b, t]]     t = 0..pos[b]
    out[b, h] = sum_t softmax_t(s_h)(t) ckv[b, t]

q [B, H, L + R] (the absorbed query: q_nope W_uk^T, then q_pe), ckv
[B, T, L], kpe [B, T, R], pos [B] int64; out [B, H, L] in q's dtype,
with f32 scores and softmax.  `models.mla.decode_step` calls it; the
CUDA kernel is `csrc/mla_decode.cu`, whose header says what bounds it
and how it is laid out.  It replaces no TPU kernel: the JAX package has
no latent attention.

`mla_decode` is the wrapper.  A CPU tensor takes `mla_decode_plain`; a
CUDA tensor launches the kernel on the current stream (two kernels,
each named ``mla_decode_*``) or raises: the kernel takes bf16 at the
published widths H = 16, L = 512, R = 64 and any B and T.  Each slot's
rows are shared out among `splits` blocks, set from B, T and the card's
SMs alone, so a step captured in a CUDA graph keeps its grid.

Each call counts once in the counter ``attention.mla_decodes`` (`DECODES`;
``path="kernel"`` on the card, ``"plain"`` on the CPU), and a launch also
in the module-level `launches`; both through `launch_count`, so that the
replays of a recorded step count and its recording does not.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ..obs import metrics as obs_metrics
from . import launch_count, nvcc

SOURCE = Path(__file__).with_name("csrc") / "mla_decode.cu"

HEADS, LATENT, ROPE = 16, 512, 64      # the widths the kernel is built for
CHUNK = 32                             # cache rows a chunk (the .cu)

launches = 0          # wrapper calls that launched the kernel (set it to 0)
DECODES = obs_metrics.counter("attention.mla_decodes")
_lib = None


def _count(n: int) -> None:
    global launches
    launches += n
    DECODES.inc(n, path="kernel")


launch_count.register("mla_decode", _count)


def build() -> Path:
    """Compile the kernel into a shared library, once per source hash
    (`nvcc.build`).  Returns the library's path."""
    return nvcc.build(SOURCE)[0]


def _launcher():
    global _lib
    if _lib is None:
        _lib = nvcc.load(SOURCE, {"mla_decode_launch": [ctypes.c_void_p] * 7
                                  + [ctypes.c_int] * 3
                                  + [ctypes.c_float, ctypes.c_void_p]})
    return _lib.mla_decode_launch


def splits(b: int, t: int, sms: int) -> int:
    """Blocks a slot's cache of T rows is shared out among: as many as
    fill `sms` SMs with two blocks each over the B slots, at least one,
    and no more than the cache's chunks."""
    return max(1, min(-(-t // CHUNK), 2 * sms // b))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(q, ckv, kpe, pos) -> None:
    if q.dim() != 3 or ckv.dim() != 3 or kpe.dim() != 3:
        raise ValueError(f"q, ckv, kpe must be [B, H, L + R], [B, T, L], "
                         f"[B, T, R]; got {tuple(q.shape)}, "
                         f"{tuple(ckv.shape)}, {tuple(kpe.shape)}")
    b, _, width = q.shape
    if ckv.shape[0] != b or kpe.shape[:2] != ckv.shape[:2] or \
            width != ckv.shape[2] + kpe.shape[2]:
        raise ValueError(f"shapes do not agree: q {tuple(q.shape)}, ckv "
                         f"{tuple(ckv.shape)}, kpe {tuple(kpe.shape)}")
    if tuple(pos.shape) != (b,):
        raise ValueError(f"pos must be [{b}], got {tuple(pos.shape)}")
    if not (q.device == ckv.device == kpe.device == pos.device):
        raise ValueError("q, ckv, kpe and pos on different devices")


def mla_decode_plain(q: torch.Tensor, ckv: torch.Tensor, kpe: torch.Tensor,
                     pos: torch.Tensor, scale: float) -> torch.Tensor:
    """The kernel's function in plain PyTorch, in f32, cast to q's dtype."""
    keys = torch.cat([ckv, kpe], dim=-1).to(torch.float32)   # [B, T, L+R]
    s = torch.einsum("bhk,btk->bht", q.to(torch.float32), keys) * scale
    live = torch.arange(ckv.shape[1], device=q.device)[None, :] <= \
        pos[:, None]
    s = s.masked_fill(~live[:, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bht,btl->bhl", p, ckv.to(torch.float32)).to(
        q.dtype)


def mla_decode(q: torch.Tensor, ckv: torch.Tensor, kpe: torch.Tensor,
               pos: torch.Tensor, scale: float) -> torch.Tensor:
    """out [B, H, L] (see the module's docstring).  CPU tensors take
    `mla_decode_plain`; CUDA tensors launch the kernel on the current
    stream (no synchronisation), with its scratch allocated here, and
    raise where it cannot take them or the launch fails."""
    _check(q, ckv, kpe, pos)
    if q.device.type == "cpu":
        DECODES.inc(path="plain")
        return mla_decode_plain(q, ckv, kpe, pos, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no MLA decode kernel for device {q.device}")
    b, h, _ = q.shape
    t, latent, rope = ckv.shape[1], ckv.shape[2], kpe.shape[2]
    if (h, latent, rope) != (HEADS, LATENT, ROPE):
        raise ValueError(f"the kernel takes H={HEADS}, L={LATENT}, "
                         f"R={ROPE}; got H={h}, L={latent}, R={rope}")
    if not q.dtype == ckv.dtype == kpe.dtype == torch.bfloat16:
        raise ValueError(f"the kernel takes bf16 q, ckv and kpe; got "
                         f"{q.dtype}, {ckv.dtype}, {kpe.dtype}")
    q, ckv, kpe = q.contiguous(), ckv.contiguous(), kpe.contiguous()
    pos = pos.to(torch.int64).contiguous()
    if ckv.data_ptr() % 16 or kpe.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError("the kernel reads q, ckv and kpe 16 bytes a load: "
                         "their storage must be aligned so")
    out = torch.empty((b, h, latent), dtype=q.dtype, device=q.device)
    if b == 0:
        return out
    n = splits(b, t, _sms(q.device.index))
    part_o = torch.empty((b, n, h, latent), dtype=torch.float32,
                         device=q.device)
    part_ml = torch.empty((b, n, h, 2), dtype=torch.float32,
                          device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _launcher()(q.data_ptr(), ckv.data_ptr(), kpe.data_ptr(),
                      pos.data_ptr(), part_o.data_ptr(), part_ml.data_ptr(),
                      out.data_ptr(), b, t, n, float(scale), stream)
    if err:
        raise RuntimeError(f"mla_decode kernel launch failed: cudaError "
                           f"{err} (B={b}, T={t})")
    launch_count.launched("mla_decode")
    return out
