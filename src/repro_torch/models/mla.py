"""Multi-head latent attention (MLA, DeepSeek-V2 [arXiv:2405.04434]): the
``mla`` mixer of an `MLAConfig`.

With x the normed layer input, H heads, and the widths of the config:

* query ``q = x W_q``, [H, nope + rope] a token, split into ``q_nope``
  and ``q_pe`` (no query LoRA);
* latent ``[c, k_pe] = x W_kva``, ``c = RMSNorm(c)`` (``kv_lora_rank``
  wide), ``k_pe`` (``qk_rope_dim``) one RoPE key shared by all heads;
  RoPE on ``q_pe`` and ``k_pe``, on split halves as the port's other
  models, at YaRN's frequencies (`yarn_inv_freq`);
* per head h ``[k_nope_h, v_h] = c W_kvb,h``;
* scores ``(q_nope_h . k_nope_h(t) + q_pe_h . k_pe(t)) * scale``, where
  `softmax_scale` is (nope + rope)^-1/2 times YaRN's m^2;
* ``y = concat_h(sum_t softmax(s_h)(t) v_h(t)) W_o``.

`apply` (the full sequence) runs that form, with k and v expanded per
head.  `decode_step` runs the absorbed form over a latent cache
``{"ckv": [B, T, kv_lora_rank], "kpe": [B, T, qk_rope_dim]}`` (batch on
axis 0): ``q_nope_h . k_nope_h(t) = (q_nope_h W_uk,h^T) . c(t)`` and
``sum_t p_h(t) v_h(t) = (sum_t p_h(t) c(t)) W_uv,h``, so a step reads
each cached row once for all heads (`kernels.mla_decode`) and never
expands the cache.  ``W_kvb`` is held as one dense [kv_lora_rank, H *
(nope + v)] matrix in the activation dtype (never packed: absorbed
decode multiplies by its per-head blocks, not x @ W); W_q, W_kva and W_o
are packed where the config packs.

Each decode counts once in ``attention.mla_decodes`` (``path="kernel"``
on the card, ``"plain"`` on the CPU), which the kernel's wrapper keeps
(`kernels.mla_decode.DECODES`).
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import torch
from torch import nn

from ..kernels import mla_decode as mla_kernel
from ..parallel import sharding as shd
from . import attention as attn
from . import common as cm
from .common import MLAConfig

class MLA(nn.Module):
    """Params of one ``mla`` layer: ``wq``, ``wkva``, ``kvn`` (the
    latent's RMSNorm), ``wkvb`` (dense) and ``wo``."""

    def __init__(self, cfg: MLAConfig, generator: torch.Generator, dev):
        super().__init__()
        qz = cfg.quant_bits is not None
        d, h = cfg.d_model, cfg.n_heads
        self.wq = cm._init_dense(generator, d, h * (cfg.qk_nope_dim +
                                                    cfg.qk_rope_dim),
                                 cfg, qz, dev)
        self.wkva = cm._init_dense(generator, d, cfg.kv_lora_rank +
                                   cfg.qk_rope_dim, cfg, qz, dev)
        self.kvn = cm.RMSNorm(cfg.kv_lora_rank, dev)
        self.wkvb = cm._init_dense(generator, cfg.kv_lora_rank, h * (
            cfg.qk_nope_dim + cfg.v_head_dim), cfg, False, dev)
        self.wo = cm._init_dense(generator, h * cfg.v_head_dim, d, cfg, qz,
                                 dev)


def specs(cfg: MLAConfig) -> dict:
    """Logical axes of `MLA`'s leaves (the latent's axis has no rule)."""
    qz = cfg.quant_bits is not None
    return {"wq": cm._dense_specs("embed", "heads", cfg, qz),
            "wkva": cm._dense_specs("embed", None, cfg, qz),
            "kvn": {"g": (None,)},
            "wkvb": cm._dense_specs(None, "heads", cfg, False),
            "wo": cm._dense_specs("heads", "embed", cfg, qz)}


# ---------------------------------------------------------------------------
# YaRN RoPE (the source's DeepseekV2YarnRotaryEmbedding)
# ---------------------------------------------------------------------------

def yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def softmax_scale(cfg: MLAConfig) -> float:
    """(nope + rope)^-1/2, times m^2 with m = `yarn_mscale` of the factor
    and ``yarn_mscale_all_dim`` where that is set."""
    s = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    if cfg.yarn_mscale_all_dim:
        s *= yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim) ** 2
    return s


def _correction_dim(rotations: float, dim: int, base: float,
                    length: int) -> float:
    return (dim * math.log(length / (rotations * 2 * math.pi))) / (
        2 * math.log(base))


@functools.lru_cache(maxsize=None)
def _yarn_table(dim: int, base: float, factor: float, length: int,
                beta_fast: float, beta_slow: float,
                dev: torch.device) -> torch.Tensor:
    freq = 1.0 / base ** (torch.arange(0, dim, 2, dtype=torch.float32)
                          / dim)
    if factor <= 1:
        return freq.to(dev)
    low = max(math.floor(_correction_dim(beta_fast, dim, base, length)), 0)
    high = min(math.ceil(_correction_dim(beta_slow, dim, base, length)),
               dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low)
                       / (high - low), 0, 1)
    mask = 1.0 - ramp
    return (freq / factor * (1 - mask) + freq * mask).to(dev)


def yarn_inv_freq(cfg: MLAConfig, dev="cpu") -> torch.Tensor:
    """[qk_rope_dim / 2] f32: ``freq / factor * (1 - mask) + freq *
    mask``, the mask 1 minus the linear ramp between the correction dims
    of ``yarn_beta_fast`` and ``yarn_beta_slow``.  Made on the host once
    for each device (a decode step's warm-up makes it before a capture),
    never a leaf of the state dict."""
    return _yarn_table(cfg.qk_rope_dim, float(cfg.rope_theta),
                       float(cfg.yarn_factor), int(cfg.yarn_original_len),
                       float(cfg.yarn_beta_fast), float(cfg.yarn_beta_slow),
                       torch.device(dev))


def rope(x: torch.Tensor, positions: torch.Tensor,
         cfg: MLAConfig) -> torch.Tensor:
    """YaRN RoPE on split halves: x [..., S, H, D], positions [..., S];
    cos and sin scaled by m(mscale) / m(mscale_all_dim) (1 for the
    published values)."""
    inv = yarn_inv_freq(cfg, x.device)
    mult = yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale) / yarn_mscale(
        cfg.yarn_factor, cfg.yarn_mscale_all_dim)
    ang = (positions[..., None].to(torch.float32) * inv)[..., None, :]
    cos, sin = torch.cos(ang) * mult, torch.sin(ang) * mult
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

def _project(params: MLA, x: torch.Tensor, cfg: MLAConfig, positions):
    """x [B, S, D] -> (q_nope [B, S, H, nope], q_pe [B, S, H, rope],
    the normed latent c [B, S, kv_lora_rank], k_pe [B, S, rope]), RoPE
    applied."""
    b, s, _ = x.shape
    nope, rd = cfg.qk_nope_dim, cfg.qk_rope_dim
    q = cm.linear(params.wq, x).reshape(b, s, cfg.n_heads, nope + rd)
    q_nope, q_pe = q.split([nope, rd], dim=-1)
    kva = cm.linear(params.wkva, x)
    c, k_pe = kva.split([cfg.kv_lora_rank, rd], dim=-1)
    c = cm.rmsnorm(params.kvn, c, cfg.norm_eps)
    q_pe = rope(q_pe, positions, cfg)
    k_pe = rope(k_pe[..., None, :], positions, cfg)[..., 0, :]
    return q_nope, q_pe, c, k_pe


def _wkvb(params: MLA, cfg: MLAConfig, dtype) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
    """(W_uk [L, H, nope], W_uv [L, H, v]): views of ``wkvb``'s blocks."""
    w = params.wkvb.w.to(dtype).view(cfg.kv_lora_rank, cfg.n_heads,
                                     cfg.qk_nope_dim + cfg.v_head_dim)
    return w[..., :cfg.qk_nope_dim], w[..., cfg.qk_nope_dim:]


def apply(params: MLA, x: torch.Tensor, cfg: MLAConfig) -> torch.Tensor:
    """Causal MLA over a whole sequence x [B, S, D], k and v expanded per
    head; logits and softmax in f32, as `attention._sdpa` takes them."""
    b, s, _ = x.shape
    h, nope, rd = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    positions = torch.arange(s, device=x.device)[None, :]
    q_nope, q_pe, c, k_pe = _project(params, x, cfg, positions)
    kv = cm.linear(params.wkvb, c).reshape(b, s, h, nope + cfg.v_head_dim)
    k_nope, v = kv.split([nope, cfg.v_head_dim], dim=-1)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe[:, :, None, :].expand(b, s, h, rd)], dim=-1)
    logits = torch.einsum("bshd,bthd->bhst", q.to(torch.float32),
                          k.to(torch.float32)) * softmax_scale(cfg)
    mask = attn.causal_mask(s, x.device)
    logits = logits.masked_fill(~mask, -1e30)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhst,bthd->bshd", w, v)
    return cm.linear(params.wo, out.reshape(b, s, h * cfg.v_head_dim))


def init_cache(cfg: MLAConfig, batch: int, max_len: int, dev,
               dtype=None) -> Dict[str, torch.Tensor]:
    """The latent cache of one layer: ``ckv`` [B, T, kv_lora_rank] (the
    normed latents) and ``kpe`` [B, T, qk_rope_dim] (the RoPE keys)."""
    dtype = dtype or cfg.adtype
    return {"ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                               dtype=dtype, device=dev),
            "kpe": torch.zeros((batch, max_len, cfg.qk_rope_dim),
                               dtype=dtype, device=dev)}


def cache_specs() -> Dict[str, tuple]:
    """The latent cache's logical axes: batch only (the decode reads each
    slot's rows whole, so its T axis is not sharded)."""
    ax = ("batch", None, None)
    return {"ckv": ax, "kpe": ax}


def decode_step(params: MLA, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                index, cfg: MLAConfig
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token absorbed decode: x [B, 1, D] at positions `index` (a
    scalar or [B]); row b writes its latent and RoPE key at its position
    and attends over its rows up to it.  The cache is updated in place
    and returned."""
    b = x.shape[0]
    idx = attn.positions(index, b, x.device)
    q_nope, q_pe, c, k_pe = _project(params, x, cfg, idx[:, None])
    rows = torch.arange(b, device=x.device)
    shd.set_rows(cache["ckv"], rows, idx, c[:, 0])
    shd.set_rows(cache["kpe"], rows, idx, k_pe[:, 0])
    w_uk, w_uv = _wkvb(params, cfg, x.dtype)
    q_abs = torch.einsum("bhn,lhn->bhl", q_nope[:, 0], w_uk)
    q = torch.cat([q_abs, q_pe[:, 0]], dim=-1)          # [B, H, L + rope]
    o = mla_kernel.mla_decode(q, cache["ckv"], cache["kpe"], idx,
                              softmax_scale(cfg))    # [B, H, L]
    out = torch.einsum("bhl,lhv->bhv", o, w_uv)
    return cm.linear(params.wo, out.reshape(b, 1, -1)), cache
