"""AdamW with an optionally int8-quantized second moment (8-bit Adam).

The port of `repro.train.optimizer`.  The optimizer state is one dict per
trainable param, keyed by the param's state-dict name: ``m`` in bf16
(sign matters, magnitudes are tame) and ``v`` in f32, or, with
``int8_second_moment``, ``v_q`` int8 in the param's shape with ``v_s``
f32, one log2 offset per block of `BLOCK` along the last axis.

Every scalar of the update (the learning rate, the bias corrections, the
clip factor) is an f32 tensor on the params' device, computed as the JAX
function computes it (``b1 ** t`` with ``t`` an f32 tensor, not a Python
float64), so a step never waits on the host.  `apply_updates` updates
params and state in place, one leaf at a time, so the f32 temporaries are
one leaf's.

Weight decay follows the rank of the leaf as the port stores it
(``p.ndim >= 2``): a per-layer norm gain is 1-D here and is not decayed.
That is the JAX package's ``scan_layers=False`` layout; its stacked
layout stores the same gain as [L, d] and decays it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
from torch.nn import functional as F

from ..parallel.sharding import like, reshape

BLOCK = 256

Tree = Dict[str, torch.Tensor]
State = Dict[str, Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    int8_second_moment: bool = False


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at int32 `step`, an f32 tensor: linear warmup
    from 0 (so it is 0 at step 0, also with ``warmup_steps=0``), then a
    cosine to a tenth of ``lr`` at ``total_steps``."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


# -- int8 block quantization for v -------------------------------------------
# LOG-domain: level = round((log2(v) - log2(max) + SPAN) * 255 / SPAN) - 128,
# clamping tiny values *up* to max * 2^-SPAN (which can only shrink the
# Adam update - the safe direction).  XLA flushes f32 subnormals to zero
# on the CPU and the TPU, and the JAX code's 1e-38 floor is itself
# subnormal: a subnormal or zero v takes log2(0) = -inf (level -128), and
# a decoded value below the smallest normal f32 is 0.  `_ftz` does the
# same here on every device.

V_SPAN_OCTAVES = 40.0
_TINY = torch.finfo(torch.float32).tiny


def _ftz(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x < _TINY, torch.zeros_like(x), x)


def _q8_encode(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 v (>= 0) -> (int8 levels in v's shape, f32 log2 offsets
    [..., ceil(last / BLOCK)])."""
    last = v.shape[-1]
    nb = -(-last // BLOCK)
    blocks = reshape(F.pad(v, (0, nb * BLOCK - last)), *v.shape[:-1], nb,
                     BLOCK)
    vmax = torch.clamp(blocks.amax(dim=-1), min=1e-30)
    lo = torch.log2(vmax) - V_SPAN_OCTAVES
    rel = torch.log2(_ftz(blocks)) - lo[..., None]
    q = torch.clamp(torch.round(rel * (255.0 / V_SPAN_OCTAVES)) - 128,
                    -128, 127)
    q = reshape(q, *v.shape[:-1], nb * BLOCK)[..., :last].to(torch.int8)
    return q, lo.to(torch.float32)


def _q8_decode(q: torch.Tensor, lo: torch.Tensor, shape) -> torch.Tensor:
    last = shape[-1]
    nb = lo.shape[-1]
    blocks = reshape(F.pad(q, (0, nb * BLOCK - last)), *shape[:-1], nb,
                     BLOCK).to(torch.float32)
    logv = (blocks + 128.0) * (V_SPAN_OCTAVES / 255.0) + lo[..., None]
    # exact zeros (fresh state) decode to the span floor ~ vmax*2^-40 ~ 0
    v = _ftz(torch.exp2(logv))
    return reshape(v, *shape[:-1], nb * BLOCK)[..., :last]


def init_state(params: Tree, cfg: AdamWConfig) -> State:
    """Zero moments for each param of `params` (name -> tensor), on its
    device."""
    out = {}
    for name, p in params.items():
        m = torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device)
        v = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        if cfg.int8_second_moment:
            q, s = _q8_encode(v)
            out[name] = {"m": m, "v_q": q, "v_s": s}
        else:
            out[name] = {"m": m, "v": v}
    return out


def state_specs(param_specs: Dict[str, tuple], cfg: AdamWConfig
                ) -> Dict[str, Dict[str, tuple]]:
    """Optimizer-state logical axes mirror the param axes (name -> axes,
    `models.lm.specs`); the int8 q has the param's shape and spec, and
    the scales share all but the last axis (the blocked last dim usually
    stops dividing, and prunes to replicated)."""
    if cfg.int8_second_moment:
        return {k: {"m": s, "v_q": s, "v_s": s}
                for k, s in param_specs.items()}
    return {k: {"m": s, "v": s} for k, s in param_specs.items()}


def global_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree.values()))


@torch.no_grad()
def apply_updates(params: Tree, grads: Tree, opt_state: State,
                  step: torch.Tensor, cfg: AdamWConfig
                  ) -> Tuple[Tree, State]:
    """One AdamW step at int32 `step` (0-d tensor), in place: writes each
    param and its state and returns them (placed ones shard by shard,
    `sharding.like`)."""
    lr = schedule(cfg, step)
    gn = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-9), max=1.0)
    t = step.to(torch.float32) + 1.0
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t
    for name, p in params.items():
        s = opt_state[name]
        g = grads[name].to(torch.float32) * clip
        m = cfg.b1 * s["m"].to(torch.float32) + (1 - cfg.b1) * g
        v = _q8_decode(s["v_q"], s["v_s"], p.shape) if "v_q" in s \
            else s["v"]
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        update = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if p.ndim >= 2:
            update = update + cfg.weight_decay * p.to(torch.float32)
        p.copy_(like((p.to(torch.float32) - lr * update).to(p.dtype), p))
        s["m"].copy_(like(m.to(torch.bfloat16), s["m"]))
        if "v_q" in s:
            q, sc = _q8_encode(v)
            s["v_q"].copy_(like(q, s["v_q"]))
            s["v_s"].copy_(like(sc, s["v_s"]))
        else:
            s["v"].copy_(like(v, s["v"]))
    return params, opt_state
