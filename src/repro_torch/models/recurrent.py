"""Recurrent mixers: xLSTM's mLSTM/sLSTM and Griffin's RG-LRU.

The port of `repro.models.recurrent`.

mLSTM (xLSTM, arXiv:2405.04517): matrix memory with exponential gating,
in the numerically stable chunkwise-parallel form over a full sequence
(log-space cumulative forget gates, an attention-like product inside each
chunk of `CHUNK` tokens, a recurrent state across chunks) and the
token-recurrent form for decode.

sLSTM: scalar memory with exponential gating and a true hidden-state
recurrence (R h_{t-1}), a loop over time.

RG-LRU (Griffin / RecurrentGemma, arXiv:2402.19427): the gated diagonal
linear recurrence h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),
a_t = exp(-c * softplus(L) * r_t), behind a short causal temporal conv.
The JAX package runs it as `jax.lax.associative_scan`; here it is a
log2(S)-step scan (Hillis-Steele) in f32 torch ops.

Every packed projection goes through `common.linear` (the bit-plane
kernel on the card); the small dense matrices the JAX code multiplies
with a plain ``@`` (RG-LRU's ``wr``/``wi``, the mLSTM gates ``wf``/``wi``,
sLSTM's ``r``) stay plain products.  Decode states are dicts of tensors
with the batch on axis 0, updated in place like the attention caches.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..parallel import sharding as shd
from ..parallel.sharding import constrain
from ..parallel.sharding import pointwise
from ..parallel.sharding import reshape as rs
from . import common as cm
from .common import Config

CHUNK = 256

State = Dict[str, torch.Tensor]


def _dense(generator, shape, scale, dtype, dev) -> nn.Parameter:
    return cm._frozen((cm._normal(generator, shape, dev) * scale).to(dtype))


def _gate(generator, d, h, bias, dev) -> nn.ParameterDict:
    """An mLSTM gate's ``{"w" [d, h], "b" [h]}``, both f32."""
    return nn.ParameterDict({
        "w": _dense(generator, (d, h), 0.02, torch.float32, dev),
        "b": cm._frozen(torch.full((h,), bias, dtype=torch.float32,
                                   device=dev))})


def _update(state: State, new: State) -> State:
    """Write `new` into `state`, in place (placed states shard by shard,
    `sharding.like`)."""
    for name, t in new.items():
        state[name].copy_(shd.like(t, state[name]))
    return state


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

class MLSTM(nn.Module):
    """mLSTM params (the JAX `mlstm_init`)."""

    def __init__(self, cfg: Config, generator: torch.Generator, dev):
        super().__init__()
        qz = cfg.quant_bits is not None
        d, h, hd = cfg.d_model, cfg.n_heads, cfg.hd
        self.wq = cm._init_dense(generator, d, h * hd, cfg, qz, dev)
        self.wk = cm._init_dense(generator, d, h * hd, cfg, qz, dev)
        self.wv = cm._init_dense(generator, d, h * hd, cfg, qz, dev)
        self.wo = cm._init_dense(generator, h * hd, d, cfg, qz, dev)
        self.wf = _gate(generator, d, h, 3.0, dev)
        self.wi = _gate(generator, d, h, 0.0, dev)
        self.gn = cm.RMSNorm(hd, dev)


def mlstm_specs(cfg: Config) -> dict:
    """Logical axes of `MLSTM`'s leaves (the JAX `mlstm_specs`)."""
    qz = cfg.quant_bits is not None
    return {
        "wq": cm._dense_specs("embed", "heads", cfg, qz),
        "wk": cm._dense_specs("embed", "heads", cfg, qz),
        "wv": cm._dense_specs("embed", "heads", cfg, qz),
        "wo": cm._dense_specs("heads", "embed", cfg, qz),
        "wf": {"w": ("embed", None), "b": (None,)},
        "wi": {"w": ("embed", None), "b": (None,)},
        "gn": {"g": (None,)},
    }


def _mlstm_gates(params: MLSTM, x):
    xf = x.to(torch.float32)
    f = pointwise(F.logsigmoid, xf @ params.wf["w"] + params.wf["b"])  # log f
    i = xf @ params.wi["w"] + params.wi["b"]
    return f, i


def mlstm_apply(params: MLSTM, x: torch.Tensor, cfg: Config) -> torch.Tensor:
    """Chunkwise-parallel mLSTM over the full sequence. x: [B, S, D].

    A running log-max rescales the matrix memory and the normalizer, and
    the normalizer rides along as an extra value channel (v' = [v, 1]).
    The sequence splits into ``max(1, S // CHUNK)`` equal chunks; a
    length that does not (S = 513, say) raises in the reshape, as in the
    JAX code.
    """
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.hd
    nq = max(1, s // CHUNK)
    c = s // nq
    q = rs(cm.linear(params.wq, x), b, s, h, hd) / math.sqrt(hd)
    k = rs(cm.linear(params.wk, x), b, s, h, hd)
    v = rs(cm.linear(params.wv, x), b, s, h, hd)
    f, i = _mlstm_gates(params, x)                        # [B, S, H]

    f32 = torch.float32
    qc = rs(q, b, nq, c, h, hd).to(f32)
    kc = rs(k, b, nq, c, h, hd).to(f32)
    vc = rs(v, b, nq, c, h, hd).to(f32)
    vc = torch.cat([vc, torch.ones_like(vc[..., :1])], -1)   # [.., hd+1]
    fc = rs(f, b, nq, c, h)
    ic = rs(i, b, nq, c, h)
    fcum = torch.cumsum(fc, dim=2)                        # within-chunk logs

    # intra-chunk: w[t,u] = exp(fcum[t]-fcum[u]+i[u] - m_intra[t]) (q_t.k_u)
    lqk = torch.einsum("bnchd,bnuhd->bnhcu", qc, kc)
    gate = (fcum[:, :, :, None, :] - fcum[:, :, None, :, :]
            + ic[:, :, None, :, :])                       # [b,n,t,u,h]
    causal = torch.ones((c, c), dtype=torch.bool, device=x.device).tril()
    gate = gate.masked_fill(~causal[None, None, :, :, None], -1e30)
    m_intra = torch.clamp(gate.amax(dim=3), min=-1e30)    # [b,n,t,h]
    wts = torch.exp(gate - m_intra[:, :, :, None, :])
    intra = torch.einsum("bnhcu,bncuh,bnuhe->bnche", lqk, wts, vc)

    # inter-chunk state scan with a running max: g_u = fsum - fcum_u + i_u
    fsum = fcum[:, :, -1, :]                              # [b,n,h]
    g = fsum[:, :, None, :] - fcum + ic                   # [b,n,c,h]
    m_chunk = g.amax(dim=2)                               # [b,n,h]
    kv_chunk = torch.einsum("bnchd,bnch,bnche->bnhde", kc,
                            torch.exp(g - m_chunk[:, :, None, :]), vc)

    S_ = torch.zeros((b, h, hd, hd + 1), dtype=f32, device=x.device)
    m = torch.full((b, h), -1e30, dtype=f32, device=x.device)
    prev_S, prev_m = [], []
    for n in range(nq):                                   # emit previous
        prev_S.append(S_)
        prev_m.append(m)
        fs, mc = fsum[:, n], m_chunk[:, n]
        m_new = torch.maximum(m + fs, mc)
        S_ = (S_ * torch.exp(m + fs - m_new)[:, :, None, None]
              + kv_chunk[:, n] * torch.exp(mc - m_new)[:, :, None, None])
        m = m_new
    prev_S = torch.stack(prev_S, dim=1)                   # [b,n,h,hd,hd+1]
    prev_m = torch.stack(prev_m, dim=1)                   # [b,n,h]

    # combine intra and inter under a shared stabilizer m_tot
    m_inter = fcum + prev_m[:, :, None, :]                # [b,n,t,h]
    m_tot = torch.maximum(m_intra, m_inter)
    inter = torch.einsum("bnchd,bnhde->bnche", qc, prev_S)
    num_den = (intra * torch.exp(m_intra - m_tot)[..., None]
               + inter * torch.exp(m_inter - m_tot)[..., None])
    num, den = num_den[..., :hd], num_den[..., hd]
    denom = torch.maximum(den.abs(), torch.exp(-m_tot))[..., None]
    out = rs(num / denom, b, s, h, hd)
    out = cm.rmsnorm(params.gn, out.to(x.dtype), cfg.norm_eps)
    out = constrain(out, ("batch", "seq", "heads", None))
    return cm.linear(params.wo, rs(out, b, s, -1))


def mlstm_state_init(cfg: Config, batch: int, dev) -> State:
    h, hd = cfg.n_heads, cfg.hd
    return {"S": torch.zeros((batch, h, hd, hd + 1), dtype=torch.float32,
                             device=dev),
            "m": torch.full((batch, h), -1e30, dtype=torch.float32,
                            device=dev)}


def mlstm_state_specs() -> Dict[str, tuple]:
    return {"S": ("batch", "heads", None, None),
            "m": ("batch", "heads")}


def mlstm_decode(params: MLSTM, x: torch.Tensor, state: State, cfg: Config):
    """Token-recurrent mLSTM step (the paper's stabilized recurrence).
    x: [B, 1, D]; `state` is updated in place and returned."""
    b = x.shape[0]
    h, hd = cfg.n_heads, cfg.hd
    f32 = torch.float32
    q = (rs(cm.linear(params.wq, x), b, h, hd) / math.sqrt(hd)).to(f32)
    k = rs(cm.linear(params.wk, x), b, h, hd).to(f32)
    v = rs(cm.linear(params.wv, x), b, h, hd).to(f32)
    v = torch.cat([v, torch.ones_like(v[..., :1])], -1)
    f, i = _mlstm_gates(params, x)                        # [B, 1, H]
    logf, ig = f[:, 0], i[:, 0]
    m_old = state["m"]
    m_new = torch.maximum(m_old + logf, ig)
    S = (state["S"] * torch.exp(m_old + logf - m_new)[:, :, None, None]
         + torch.exp(ig - m_new)[:, :, None, None]
         * torch.einsum("bhd,bhe->bhde", k, v))
    nd = torch.einsum("bhd,bhde->bhe", q, S)
    num, den = nd[..., :hd], nd[..., hd]
    out = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    out = cm.rmsnorm(params.gn, out[:, None].to(x.dtype), cfg.norm_eps)
    y = cm.linear(params.wo, rs(out, b, 1, -1))
    return y, _update(state, {"S": S, "m": m_new})


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

class SLSTM(nn.Module):
    """sLSTM params (the JAX `slstm_init`)."""

    def __init__(self, cfg: Config, generator: torch.Generator, dev):
        super().__init__()
        qz = cfg.quant_bits is not None
        d, h, hd = cfg.d_model, cfg.n_heads, cfg.hd
        # z, i, f, o pre-activations
        self.wx = cm._init_dense(generator, d, 4 * h * hd, cfg, qz, dev)
        self.r = _dense(generator, (h, hd, 4 * hd), 1 / math.sqrt(hd),
                        torch.float32, dev)
        self.b = cm._frozen(torch.zeros(4 * h * hd, dtype=torch.float32,
                                        device=dev))
        self.wo = cm._init_dense(generator, h * hd, d, cfg, qz, dev)
        self.gn = cm.RMSNorm(hd, dev)


def slstm_specs(cfg: Config) -> dict:
    """Logical axes of `SLSTM`'s leaves (the JAX `slstm_specs`)."""
    qz = cfg.quant_bits is not None
    return {
        "wx": cm._dense_specs("embed", "heads", cfg, qz),
        "r": ("heads", None, None),
        "b": ("heads",),
        "wo": cm._dense_specs("heads", "embed", cfg, qz),
        "gn": {"g": (None,)},
    }


def slstm_apply(params: SLSTM, x: torch.Tensor, cfg: Config,
                state: Optional[State] = None, return_state: bool = False):
    """Sequential sLSTM over x [B, S, D].  With `return_state` the final
    state comes back too, written into `state` when one was given."""
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.hd
    pre = rs(cm.linear(params.wx, x).to(torch.float32) + params.b,
             b, s, h, 4, hd)
    carry = state if state is not None else \
        slstm_state_init(cfg, b, x.device)
    c, n, hid, m = carry["c"], carry["n"], carry["h"], carry["m"]
    hs = []
    for t in range(s):
        rec = rs(torch.einsum("bhd,hdk->bhk", hid, params.r), b, h, 4, hd)
        z, i, f, o = (pre[:, t] + rec).unbind(2)
        zt = torch.tanh(z)
        ot = torch.sigmoid(o)
        logf = pointwise(F.logsigmoid, f)
        m_new = torch.maximum(logf + m, i)                # stabilizer
        ig = torch.exp(i - m_new)
        fg = torch.exp(logf + m - m_new)
        c = fg * c + ig * zt
        n = fg * n + ig
        hid = ot * c / torch.clamp(n, min=1.0)
        m = m_new
        hs.append(hid)
    hs = torch.stack(hs, dim=1)                           # [B, S, H, hd]
    hs = cm.rmsnorm(params.gn, hs.to(x.dtype), cfg.norm_eps)
    y = cm.linear(params.wo, rs(hs, b, s, -1))
    if not return_state:
        return y
    new = {"c": c, "n": n, "h": hid, "m": m}
    return y, (_update(state, new) if state is not None else new)


def slstm_state_init(cfg: Config, batch: int, dev) -> State:
    """c, n and h start at zero and m at -10, each its own tensor (the
    states are updated in place)."""
    h, hd = cfg.n_heads, cfg.hd

    def zeros():
        return torch.zeros((batch, h, hd), dtype=torch.float32, device=dev)
    return {"c": zeros(), "n": zeros(), "h": zeros(), "m": zeros() - 10.0}


def slstm_state_specs() -> Dict[str, tuple]:
    ax = ("batch", "heads", None)
    return {"c": ax, "n": ax, "h": ax, "m": ax}


# ---------------------------------------------------------------------------
# RG-LRU (Griffin / RecurrentGemma)
# ---------------------------------------------------------------------------

_LRU_C = 8.0


class RGLRU(nn.Module):
    """RG-LRU params (the JAX `rglru_init`)."""

    def __init__(self, cfg: Config, generator: torch.Generator, dev):
        super().__init__()
        d = cfg.d_model
        w = cfg.lru_width or d
        qz = cfg.quant_bits is not None
        self.wx = cm._init_dense(generator, d, w, cfg, qz, dev)
        self.conv = _dense(generator, (cfg.conv_width, w), 0.02,
                           torch.float32, dev)
        self.wr = nn.ParameterDict(
            {"w": _dense(generator, (w, w), 1 / math.sqrt(w), cfg.adtype,
                         dev)})
        self.wi = nn.ParameterDict(
            {"w": _dense(generator, (w, w), 1 / math.sqrt(w), cfg.adtype,
                         dev)})
        # Lambda init so that a^(1/c) lies in (0.9, 0.999)
        u = torch.rand((w,), generator=generator, device=dev,
                       dtype=torch.float32) * (0.999 - 0.9) + 0.9
        self.lam = cm._frozen(torch.log(torch.exp(-torch.log(u) * 8.0) - 1.0))
        self.wo = cm._init_dense(generator, w, d, cfg, qz, dev)


def rglru_specs(cfg: Config) -> dict:
    """Logical axes of `RGLRU`'s leaves (the JAX `rglru_specs`)."""
    qz = cfg.quant_bits is not None
    return {
        "wx": cm._dense_specs("embed", "state", cfg, qz),
        "conv": ("conv", "state"),
        "wr": {"w": ("state", None)},
        "wi": {"w": ("state", None)},
        "lam": ("state",),
        "wo": cm._dense_specs("state", "embed", cfg, qz),
    }


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t along axis 1, with h_{-1} folded into
    b_0: inclusive Hillis-Steele scan of the pairs (a, b) under
    (a1, b1) . (a2, b2) = (a1 a2, b1 a2 + b2), in log2(S) steps."""
    s = a.shape[1]
    d = 1
    while d < s:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b


def _rglru_core(params: RGLRU, u: torch.Tensor, h0: torch.Tensor):
    """u: [B, S, W] pre-gates; h0: [B, W] initial state.
    Returns the states [B, S, W] and the last one [B, W], in f32."""
    r = torch.sigmoid(u @ params.wr["w"].to(u.dtype))
    i = torch.sigmoid(u @ params.wi["w"].to(u.dtype))
    log_a = -_LRU_C * F.softplus(params.lam) * r.to(torch.float32)
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6)) \
        * (i * u).to(torch.float32)
    a_seq = torch.cat([torch.ones_like(a[:, :1]), a], dim=1)
    b_seq = torch.cat([h0[:, None].to(torch.float32), gated], dim=1)
    hs = _linear_scan(a_seq, b_seq)
    return hs[:, 1:], hs[:, -1]


def _conv_taps(window: torch.Tensor, conv: torch.Tensor, s: int):
    """The causal temporal conv over `window` [B, s + cw - 1, W]: the sum
    over taps j of window[:, j:j+s] * conv[j], in the JAX code's order."""
    out = 0
    for j in range(conv.shape[0]):
        out = out + window[:, j:j + s] * conv[j].to(window.dtype)
    return out


def rglru_apply(params: RGLRU, x: torch.Tensor, cfg: Config,
                state: Optional[State] = None, return_state: bool = False):
    """Full-sequence RG-LRU block: conv1d -> gated LRU -> out projection."""
    b, s, d = x.shape
    u = constrain(cm.linear(params.wx, x), ("batch", "seq", "state"))
    cw = params.conv.shape[0]
    pads = F.pad(u, (0, 0, cw - 1, 0))
    conv = _conv_taps(pads, params.conv, s)
    h0 = state["h"] if state is not None else \
        torch.zeros((b, u.shape[-1]), dtype=torch.float32, device=x.device)
    hs, h_last = _rglru_core(params, conv, h0)
    y = cm.linear(params.wo, hs.to(x.dtype))
    if return_state:
        return y, {"h": h_last, "conv_tail": pads[:, s:]}
    return y


def rglru_state_init(cfg: Config, batch: int, dev) -> State:
    w = cfg.lru_width or cfg.d_model
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=dev),
            "conv_tail": torch.zeros((batch, cfg.conv_width - 1, w),
                                     dtype=cfg.adtype, device=dev)}


def rglru_state_specs() -> Dict[str, tuple]:
    return {"h": ("batch", "state"), "conv_tail": ("batch", None, "state")}


def rglru_decode(params: RGLRU, x: torch.Tensor, state: State, cfg: Config):
    """One-token RG-LRU step. x: [B, 1, D]; `state` is updated in place
    and returned."""
    u = cm.linear(params.wx, x)                           # [B, 1, W]
    window = torch.cat([state["conv_tail"].to(u.dtype), u], dim=1)
    conv = _conv_taps(window, params.conv, 1)             # [B, 1, W]
    hs, h_last = _rglru_core(params, conv, state["h"])
    y = cm.linear(params.wo, hs.to(x.dtype))
    return y, _update(state, {"h": h_last, "conv_tail": window[:, 1:]})
