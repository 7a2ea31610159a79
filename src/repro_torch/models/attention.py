"""Attention: GQA with RoPE and softcap, full-sequence (dense) and
single-token decode against a KV cache.  The port of
`repro.models.attention` for the ``global`` mixer."""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch import nn

from . import common as cm
from .common import Config

DENSE_MAX_SEQ = 1024       # below this, plain dense attention is used


class Attention(nn.Module):
    """Params of one attention layer (the JAX `attention.init`)."""

    def __init__(self, cfg: Config, generator: torch.Generator, dev):
        super().__init__()
        qz = cfg.quant_bits is not None
        d, hq, hkv = cfg.d_model, cfg.n_heads * cfg.hd, cfg.kv_heads * cfg.hd
        self.wq = cm._init_dense(generator, d, hq, cfg, qz, dev)
        self.wk = cm._init_dense(generator, d, hkv, cfg, qz, dev)
        self.wv = cm._init_dense(generator, d, hkv, cfg, qz, dev)
        self.wo = cm._init_dense(generator, hq, d, cfg, qz, dev)


def _split_heads(x, n, hd):
    return x.reshape(*x.shape[:-1], n, hd)


def _qkv(params: Attention, x, cfg: Config, positions):
    q = _split_heads(cm.linear(params.wq, x), cfg.n_heads, cfg.hd)
    k = _split_heads(cm.linear(params.wk, x), cfg.kv_heads, cfg.hd)
    v = _split_heads(cm.linear(params.wv, x), cfg.kv_heads, cfg.hd)
    q = cm.rope(q, positions, cfg.rope_theta)
    k = cm.rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, mask, cfg: Config):
    """q: [B,S,Hq,D]; k,v: [B,T,Hkv,D]; mask: [B,1,T] or [S,T] bool.

    Query head h reads KV head h // (Hq // Hkv), through the same
    [b, s, kv, groups, d] reshape as the JAX code.  Logits are taken in
    f32 (the operands are cast up, which equals the JAX f32-accumulated
    product of bf16 operands), masked to -1e30, softmaxed in f32 and cast
    to v's dtype before the second product.
    """
    groups = cfg.n_heads // k.shape[2]
    b, s, hq, d = q.shape
    qg = q.reshape(b, s, k.shape[2], groups, d)
    logits = torch.einsum("bskgd,btkd->bkgst", qg.to(torch.float32),
                          k.to(torch.float32))
    logits = logits / math.sqrt(d)
    logits = cm.softcap(logits, cfg.attn_softcap)
    if mask is not None:
        if mask.dim() == 2:
            mask = mask[None, None, None]
        else:
            mask = mask[:, None, :, :][:, :, None]     # [B,1,1,S,T]
        logits = logits.masked_fill(~mask, -1e30)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(b, s, hq, d)


def causal_mask(s: int, dev) -> torch.Tensor:
    i = torch.arange(s, device=dev)[:, None]
    j = torch.arange(s, device=dev)[None, :]
    return j <= i


def apply(params: Attention, x: torch.Tensor, cfg: Config) -> torch.Tensor:
    """Full-sequence causal (``global``) attention, dense branch."""
    b, s, _ = x.shape
    if s > DENSE_MAX_SEQ:
        raise NotImplementedError(
            f"sequence {s} > {DENSE_MAX_SEQ} needs the chunked attention, "
            "which is not ported yet")
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _qkv(params, x, cfg, positions)
    out = _sdpa(q, k, v, causal_mask(s, x.device), cfg)
    return cm.linear(params.wo, out.reshape(b, s, -1))


# ---------------------------------------------------------------------------
# decode with KV cache
# ---------------------------------------------------------------------------

def init_cache(cfg: Config, batch: int, max_len: int, dev,
               dtype=None) -> Dict[str, torch.Tensor]:
    """KV cache for one global attention layer, layout [B, T, H_kv, D]."""
    dtype = dtype or cfg.adtype
    shape = (batch, max_len, cfg.kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def positions(index, batch: int, dev) -> torch.Tensor:
    """A scalar or [B] `index` as a [B] long tensor on `dev`; a Python int
    is filled in on the device, with no copy from the host."""
    if isinstance(index, torch.Tensor):
        return index.to(device=dev, dtype=torch.long).expand(batch)
    return torch.full((batch,), int(index), dtype=torch.long, device=dev)


def decode_step(params: Attention, x: torch.Tensor,
                cache: Dict[str, torch.Tensor], index, cfg: Config
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode: x [B, 1, D], cache k/v [B, T, Hkv, D].

    `index` is the absolute position of the new token - a scalar (whole
    batch in lockstep) or a [B] vector (continuous batching: each row at
    its own position).  Row i writes its own cache slot and attends over
    the slots up to its own index.  Unlike the JAX function, the cache is
    updated in place (and returned), which saves a copy per step.
    """
    b = x.shape[0]
    t = cache["k"].shape[1]
    idx = positions(index, b, x.device)
    q, k_new, v_new = _qkv(params, x, cfg, idx[:, None])
    rows = torch.arange(b, device=x.device)
    k, v = cache["k"], cache["v"]
    k[rows, idx] = k_new[:, 0].to(k.dtype)
    v[rows, idx] = v_new[:, 0].to(v.dtype)
    valid = torch.arange(t, device=x.device)[None, None, :] <= \
        idx[:, None, None]
    out = _sdpa(q, k, v, valid, cfg)
    out = cm.linear(params.wo, out.reshape(b, 1, -1))
    return out, cache
