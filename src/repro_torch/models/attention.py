"""Attention: GQA/MQA with RoPE, sliding window, qk-norm and softcap,
full-sequence (dense below `DENSE_MAX_SEQ`, query-chunked above it) and
single-token decode against a KV cache, and cross-attention over an
encoder's output.  The port of `repro.models.attention` for the
``global``, ``local`` and ``bidir`` mixers and the ``cross_global``
layer's cross-attention."""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..parallel import sharding as shd
from ..parallel.sharding import constrain
from ..parallel.sharding import reshape as shd_reshape
from . import common as cm
from .common import Config

DENSE_MAX_SEQ = 1024       # above this, `_attn_chunked` bounds the memory


class Attention(nn.Module):
    """Params of one attention layer (the JAX `attention.init`): the four
    projections, and with ``cfg.qk_norm`` the ``qn``/``kn`` RMSNorms over
    head_dim."""

    def __init__(self, cfg: Config, generator: torch.Generator, dev):
        super().__init__()
        qz = cfg.quant_bits is not None
        d, hq, hkv = cfg.d_model, cfg.n_heads * cfg.hd, cfg.kv_heads * cfg.hd
        self.wq = cm._init_dense(generator, d, hq, cfg, qz, dev)
        self.wk = cm._init_dense(generator, d, hkv, cfg, qz, dev)
        self.wv = cm._init_dense(generator, d, hkv, cfg, qz, dev)
        self.wo = cm._init_dense(generator, hq, d, cfg, qz, dev)
        if cfg.qk_norm:
            self.qn = cm.RMSNorm(cfg.hd, dev)
            self.kn = cm.RMSNorm(cfg.hd, dev)


def specs(cfg: Config) -> dict:
    """Logical axes of `Attention`'s leaves (the JAX `attention.specs`)."""
    qz = cfg.quant_bits is not None
    s = {
        "wq": cm._dense_specs("embed", "heads", cfg, qz),
        "wk": cm._dense_specs("embed", "kv_heads", cfg, qz),
        "wv": cm._dense_specs("embed", "kv_heads", cfg, qz),
        "wo": cm._dense_specs("heads", "embed", cfg, qz),
    }
    if cfg.qk_norm:
        s["qn"] = {"g": (None,)}
        s["kn"] = {"g": (None,)}
    return s


def _split_heads(x, n, hd):
    return shd_reshape(x, *x.shape[:-1], n, hd)


def _qkv(params: Attention, x, cfg: Config, positions):
    q = _split_heads(cm.linear(params.wq, x), cfg.n_heads, cfg.hd)
    k = _split_heads(cm.linear(params.wk, x), cfg.kv_heads, cfg.hd)
    v = _split_heads(cm.linear(params.wv, x), cfg.kv_heads, cfg.hd)
    if cfg.qk_norm:
        q = cm.rmsnorm(params.qn, q, cfg.norm_eps)
        k = cm.rmsnorm(params.kn, k, cfg.norm_eps)
    q = cm.rope(q, positions, cfg.rope_theta)
    k = cm.rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, mask, cfg: Config):
    """q: [B,S,Hq,D]; k,v: [B,T,Hkv,D]; mask: [B,1,T] or [S,T] bool.

    Query head h reads KV head h // (Hq // Hkv), through the same
    [b, s, kv, groups, d] reshape as the JAX code.  Logits are taken in
    f32 (the operands are cast up, which equals the JAX f32-accumulated
    product of bf16 operands), masked to -1e30, softmaxed in f32 and cast
    to v's dtype before the second product.  Placed operands (`DTensor`s)
    run it on each rank's shards (`_sdpa_placed`), but for a KV cache
    sharded along T (the ``cache_seq`` rule, flash-decoding style), whose
    products and softmax run as `DTensor` ops so that the cache is never
    gathered.
    """
    if isinstance(q, DTensor) and not (
            isinstance(k, DTensor) and Shard(1) in k.placements):
        return _sdpa_placed(q, k, v, mask, cfg)
    groups = q.shape[2] // k.shape[2]
    b, s, hq, d = q.shape
    qg = shd_reshape(q, b, s, k.shape[2], groups, d)
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
    return shd_reshape(out, b, s, hq, d)


def _sdpa_placed(q: DTensor, k, v, mask, cfg: Config) -> DTensor:
    """`_sdpa` on each rank's shards through `local_map`: every pair of
    query and key rows and every head group lies on one rank.  On each
    mesh dim the batch stays sharded where q's is, the heads where q's
    and the KV heads are and the ranks divide the KV heads (so each
    rank's query heads read its own KV heads); the sequence and cache
    axes, and anything else, are gathered first."""
    mesh = q.device_mesh
    k = k if isinstance(k, DTensor) else DTensor.from_local(
        k, mesh, [Replicate()] * mesh.ndim, run_check=False)
    qp, kp, mp = [], [], []
    for size, pq, pk in zip(mesh.shape, q.placements, k.placements):
        if pq == Shard(0) and pk == Shard(0):
            qp.append(Shard(0))
            kp.append(Shard(0))
            mp.append(Shard(0) if mask is not None and mask.dim() == 3
                      else Replicate())
        elif pq == Shard(2) and pk in (Shard(2), Replicate()) and \
                k.shape[2] % size == 0:
            qp.append(Shard(2))
            kp.append(Shard(2))
            mp.append(Replicate())
        else:
            qp += [Replicate()]
            kp += [Replicate()]
            mp += [Replicate()]
    if mask is not None and not isinstance(mask, DTensor):
        mask = DTensor.from_local(mask, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)
    return local_map(
        lambda ql, kl, vl, ml: _sdpa(ql, kl, vl, ml, cfg),
        out_placements=list(qp),
        in_placements=(tuple(qp), tuple(kp), tuple(kp),
                       None if mask is None else tuple(mp)),
        device_mesh=mesh, redistribute_inputs=True)(q, k, v, mask)


def causal_mask(s: int, dev, window: int = 0,
                prefix_len: int = 0) -> torch.Tensor:
    i = torch.arange(s, device=dev)[:, None]
    j = torch.arange(s, device=dev)[None, :]
    m = j <= i
    if window:
        m = m & (j > i - window)
    if prefix_len:
        m = m | (j < prefix_len)                      # bidirectional prefix
    return m


def _attn_chunked(q, k, v, cfg: Config, *, kind: str, prefix_len: int = 0):
    """Query-chunked attention, the JAX function's chunks one after the
    other: ``global`` (and ``bidir``) queries in chunks of 512 rows, each
    against every key it may read; ``local`` queries in window-sized
    chunks, each against its own and the previous window of keys (banded,
    so the work stays linear in the sequence).  Lengths that do not split
    into at least two chunks take the dense path, as in the JAX code."""
    b, s, hq, d = q.shape
    t = k.shape[1]
    dev = q.device
    if kind == "local":
        w = min(cfg.window, s)
        cq = w
        nq = s // cq
        if nq * cq != s or nq < 2:
            mask = causal_mask(s, dev, window=cfg.window,
                               prefix_len=prefix_len)
            return _sdpa(q, k, v, mask, cfg)
        # pad keys with one window in front: chunk i reads [iW, iW+2W)
        kp = torch.nn.functional.pad(k, (0, 0, 0, 0, w, 0))
        vp = torch.nn.functional.pad(v, (0, 0, 0, 0, w, 0))

        def chunk(i, qi):
            ks = kp[:, i * cq:i * cq + 2 * w]
            vs = vp[:, i * cq:i * cq + 2 * w]
            qpos = i * cq + torch.arange(cq, device=dev)
            kpos = i * cq - w + torch.arange(2 * w, device=dev)
            m = ((kpos[None, :] <= qpos[:, None])
                 & (kpos[None, :] > qpos[:, None] - cfg.window)
                 & (kpos[None, :] >= 0))
            return _sdpa(qi, ks, vs, m, cfg)
    else:
        cq = min(512, s)
        nq = s // cq
        if nq * cq != s or nq < 2:
            m = None if kind == "bidir" else causal_mask(
                s, dev, prefix_len=prefix_len)
            return _sdpa(q, k, v, m, cfg)

        def chunk(i, qi):
            qpos = i * cq + torch.arange(cq, device=dev)
            kpos = torch.arange(t, device=dev)
            if kind == "bidir":
                m = torch.ones((cq, t), dtype=torch.bool, device=dev)
            else:
                m = kpos[None, :] <= qpos[:, None]
                if prefix_len:
                    m = m | (kpos[None, :] < prefix_len)
            return _sdpa(qi, k, v, m, cfg)

    return torch.cat([chunk(i, q[:, i * cq:(i + 1) * cq])
                      for i in range(nq)], dim=1)


def apply(params: Attention, x: torch.Tensor, cfg: Config, *,
          kind: str = "global", prefix_len: int = 0) -> torch.Tensor:
    """Full-sequence attention (prefill) of mixer `kind`: ``global``,
    ``local`` (causal within ``cfg.window``) or ``bidir``."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _qkv(params, x, cfg, positions)
    q = constrain(q, ("batch", "seq", "heads", None))
    if s > DENSE_MAX_SEQ:
        out = _attn_chunked(q, k, v, cfg, kind=kind, prefix_len=prefix_len)
    else:
        if kind == "bidir":
            mask = None
        elif kind == "local":
            mask = causal_mask(s, x.device, window=cfg.window,
                               prefix_len=prefix_len)
        else:
            mask = causal_mask(s, x.device, prefix_len=prefix_len)
        out = _sdpa(q, k, v, mask, cfg)
    out = constrain(out, ("batch", "seq", "heads", None))
    return cm.linear(params.wo, shd_reshape(out, b, s, -1))


def apply_cross(params: Attention, x: torch.Tensor, ctx: torch.Tensor,
                cfg: Config) -> torch.Tensor:
    """Cross-attention: decoder queries x [B, S, D] over the encoder's
    output ctx [B, T, D], every key visible, no RoPE and no qk-norm (as in
    the JAX function).  K and V are projected from ctx at every call,
    also in decode: there is no cross KV cache."""
    b, s, _ = x.shape
    q = _split_heads(cm.linear(params.wq, x), cfg.n_heads, cfg.hd)
    k = _split_heads(cm.linear(params.wk, ctx), cfg.kv_heads, cfg.hd)
    v = _split_heads(cm.linear(params.wv, ctx), cfg.kv_heads, cfg.hd)
    out = _sdpa(q, k, v, None, cfg)
    return cm.linear(params.wo, shd_reshape(out, b, s, -1))


# ---------------------------------------------------------------------------
# decode with KV cache
# ---------------------------------------------------------------------------

def init_cache(cfg: Config, batch: int, max_len: int, dev,
               kind: str = "global", dtype=None) -> Dict[str, torch.Tensor]:
    """KV cache for one attention layer, layout [B, T, H_kv, D]: a local
    layer keeps a ring of min(window, max_len) rows, a global one
    max_len."""
    dtype = dtype or cfg.adtype
    t = min(cfg.window, max_len) if kind == "local" else max_len
    shape = (batch, t, cfg.kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def cache_specs(kind: str) -> Dict[str, tuple]:
    """A cache's logical axes: its T axis is the ``cache_seq`` rule's
    (sharded over ``model`` by default, flash-decoding style)."""
    ax = ("batch", "cache_seq", "kv_heads", None)
    return {"k": ax, "v": ax}


def positions(index, batch: int, dev) -> torch.Tensor:
    """A scalar or [B] `index` as a [B] long tensor on `dev`; a Python int
    is filled in on the device, with no copy from the host."""
    if isinstance(index, torch.Tensor):
        return index.to(device=dev, dtype=torch.long).expand(batch)
    return torch.full((batch,), int(index), dtype=torch.long, device=dev)


def decode_step(params: Attention, x: torch.Tensor,
                cache: Dict[str, torch.Tensor], index, cfg: Config, *,
                kind: str = "global"
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode: x [B, 1, D], cache k/v [B, T, Hkv, D].

    `index` is the absolute position of the new token - a scalar (whole
    batch in lockstep) or a [B] vector (continuous batching: each row at
    its own position).  Row i writes its own cache slot (``index % T`` in
    a local layer's ring) and attends over the slots up to its own index,
    so every slot of a ring is valid once it has wrapped.  Unlike the JAX
    function, the cache is updated in place (and returned), which saves
    a copy per step (a placed cache shard by shard: `sharding.set_rows`).
    """
    b = x.shape[0]
    t = cache["k"].shape[1]
    idx = positions(index, b, x.device)
    q, k_new, v_new = _qkv(params, x, cfg, idx[:, None])
    slot = idx % t if kind == "local" else idx
    rows = torch.arange(b, device=x.device)
    k = shd.set_rows(cache["k"], rows, slot, k_new[:, 0])
    v = shd.set_rows(cache["v"], rows, slot, v_new[:, 0])
    valid = torch.arange(t, device=x.device)[None, None, :] <= \
        idx[:, None, None]
    out = _sdpa(q, k, v, valid, cfg)
    out = cm.linear(params.wo, shd_reshape(out, b, 1, -1))
    return out, cache
