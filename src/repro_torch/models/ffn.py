"""Feed-forward layers: the gated MLP and the capacity-based top-k MoE
(GShard), the port of `repro.models.ffn`; for an `MLAConfig` also the
dense layers' own width and the shared experts' (``cfg.dense_width``,
``cfg.shared_width``), and gates left unnormalised.

The MoE routes as the JAX package does, step for step: f32 router
logits, softmax, top-k with the gates renormalised; tokens in groups of
``cfg.moe_group`` (one group of all tokens where that does not divide
them); each expert takes at most ``capacity`` (token, choice) pairs of a
group, choice 0 of every token queued ahead of any token's choice 1, and
the rest are dropped.  Dispatch and combine are the JAX one-hot einsums,
and the expert products run over every expert's slots, empty or not, as
the JAX einsums read them.  Expert weights are plain tensors in the
activation dtype, never packed (the JAX package does not pack them).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..parallel.sharding import constrain
from ..parallel.sharding import reshape as rs
from . import common as cm
from .common import Config


class MLP(nn.Module):
    """Gated MLP params (the JAX `ffn.mlp_init`)."""

    def __init__(self, cfg: Config, generator: torch.Generator, dev,
                 d_ff: Optional[int] = None):
        super().__init__()
        d_ff = d_ff or cfg.d_ff
        qz = cfg.quant_bits is not None
        self.wi = cm._init_dense(generator, cfg.d_model, d_ff, cfg, qz, dev)
        self.wg = cm._init_dense(generator, cfg.d_model, d_ff, cfg, qz, dev)
        self.wo = cm._init_dense(generator, d_ff, cfg.d_model, cfg, qz, dev)


def mlp_specs(cfg: Config) -> dict:
    """Logical axes of `MLP`'s leaves (the JAX `ffn.mlp_specs`)."""
    qz = cfg.quant_bits is not None
    return {
        "wi": cm._dense_specs("embed", "mlp", cfg, qz),
        "wg": cm._dense_specs("embed", "mlp", cfg, qz),
        "wo": cm._dense_specs("mlp", "embed", cfg, qz),
    }


def mlp_apply(params: MLP, x: torch.Tensor, cfg: Config) -> torch.Tensor:
    act = cm.activation(cfg.act)
    h = act(cm.linear(params.wg, x)) * cm.linear(params.wi, x)
    h = constrain(h, ("batch", "seq", "mlp"))
    return cm.linear(params.wo, h)


def _experts(generator: torch.Generator, e: int, rows: int, cols: int,
             std: float, dtype, dev) -> nn.Parameter:
    """[e, rows, cols] normal * std in `dtype`, drawn one expert at a time
    so that the f32 temporary is one expert's, not the whole tensor's (an
    Arctic layer's [128, 7168, 4864] would be 17.9 GB in f32)."""
    out = torch.empty((e, rows, cols), dtype=dtype, device=dev)
    for i in range(e):
        out[i] = (cm._normal(generator, (rows, cols), dev) * std).to(dtype)
    return cm._frozen(out)


class MoE(nn.Module):
    """MoE params (the JAX `ffn.moe_init`): ``router.w`` f32 [d, e]; ``wi``
    and ``wg`` [e, d, f], ``wo`` [e, f, d] in the activation dtype."""

    def __init__(self, cfg: Config, generator: torch.Generator, dev):
        super().__init__()
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        self.router = nn.ParameterDict({"w": cm._frozen(
            cm._normal(generator, (d, e), dev) * 0.02)})
        self.wi = _experts(generator, e, d, f, 1.0 / math.sqrt(d),
                           cfg.adtype, dev)
        self.wg = _experts(generator, e, d, f, 1.0 / math.sqrt(d),
                           cfg.adtype, dev)
        self.wo = _experts(generator, e, f, d, 1.0 / math.sqrt(f),
                           cfg.adtype, dev)


def moe_specs(cfg: Config) -> dict:
    """Logical axes of `MoE`'s leaves (the JAX `ffn.moe_specs`)."""
    return {
        "router": {"w": ("embed", None)},
        "wi": ("expert", "embed", "expert_mlp"),
        "wg": ("expert", "embed", "expert_mlp"),
        "wo": ("expert", "expert_mlp", "embed"),
    }


def route(router_w: torch.Tensor, xg: torch.Tensor, cfg: Config,
          capacity: int):
    """The routing of token groups xg [n, g, d]: returns (probs [n, g, e],
    gates [n, g, k] renormalised where ``cfg.renormalise_gates``, else
    the router's probabilities, and zeroed where dropped, expert indices
    [n, g, k], queue positions [n, g, k] int32, keep mask [n, g, k])."""
    n, g, _ = xg.shape
    e, k = cfg.n_experts, cfg.top_k
    logits = xg.to(torch.float32) @ router_w
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1)
    if cfg.renormalise_gates:
        gate_vals = gate_vals / torch.clamp(
            gate_vals.sum(-1, keepdim=True), min=1e-9)
    onehot = nn.functional.one_hot(expert_idx, e).to(torch.float32)
    # priority: choice 0 of all tokens first, then choice 1 (GShard)
    flat = rs(onehot.transpose(1, 2), n, k * g, e)
    pos_flat = torch.cumsum(flat, dim=1) - flat
    pos = rs(pos_flat, n, k, g, e).transpose(1, 2)
    pos = torch.sum(pos * onehot, dim=-1).to(torch.int32)
    keep = pos < capacity
    return probs, gate_vals * keep, expert_idx, pos, keep


def moe_apply(params: MoE, x: torch.Tensor, cfg: Config
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output [B, S, D], the Switch load-balancing aux loss)."""
    b, s, d = x.shape
    e = cfg.n_experts
    tokens = rs(x, -1, d)
    t = tokens.shape[0]
    g = cfg.moe_group if t % cfg.moe_group == 0 else t   # fallback: 1 group
    n = t // g
    xg = constrain(rs(tokens, n, g, d), ("batch", None, "embed"))
    capacity = int(g * cfg.top_k * cfg.capacity_factor / e) + 1
    probs, gates, expert_idx, pos, keep = route(params.router["w"], xg, cfg,
                                                capacity)

    # dispatch/combine [n, g, e, c] in the activation dtype, as in JAX
    onehot = nn.functional.one_hot(expert_idx, e).to(x.dtype)
    pos_oh = (pos[..., None] == torch.arange(capacity, device=x.device)
              ).to(x.dtype) * keep[..., None]
    disp = torch.einsum("ngke,ngkc->ngec", onehot, pos_oh)
    comb = torch.einsum("ngke,ngkc,ngk->ngec", onehot, pos_oh,
                        gates.to(x.dtype))

    # expert products over every expert's slots: [e, n*c, d] batches
    xe = torch.einsum("ngec,ngd->necd", disp, xg)
    xe = constrain(xe, ("moe_tokens", "expert", None, None))
    xe = rs(xe.transpose(0, 1), e, n * capacity, d)
    act = cm.activation(cfg.act)
    h = act(torch.matmul(xe, params.wg.to(x.dtype))) * \
        torch.matmul(xe, params.wi.to(x.dtype))
    h = constrain(rs(h, e, n, capacity, -1).transpose(0, 1),
                  ("moe_tokens", "expert", None, "expert_mlp"))
    h = rs(h.transpose(0, 1), e, n * capacity, -1)
    ye = torch.matmul(h, params.wo.to(x.dtype))          # [e, n*c, d]
    ye = rs(ye, e, n, capacity, d).transpose(0, 1)     # [n, e, c, d]
    # placed: the expert sums (Partial over "model") are reduced here, as
    # `DTensor`'s einsum cannot flatten an unevenly sharded capacity dim
    ye = constrain(ye, ("moe_tokens", "expert", None, None))
    y = torch.einsum("ngec,necd->ngd", comb, ye)
    out = rs(y, b, s, d)

    # load-balancing aux loss (Switch): mean(frac_tokens * frac_router_prob)
    frac_tokens = nn.functional.one_hot(expert_idx[:, :, 0], e).to(
        torch.float32).mean(dim=1)                       # [n, e]
    frac_probs = probs.mean(dim=1)                       # [n, e]
    aux = e * torch.mean(torch.sum(frac_tokens * frac_probs, dim=-1))
    return out, aux.to(torch.float32)
