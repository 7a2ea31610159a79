"""LM assembly: decoder layers -> a stack -> the full model.

The port of `repro.models.lm` for the decoder family whose layers are all
(``global`` attention, ``mlp``).  The JAX package stacks homogeneous
layer groups under `lax.scan`; here the stack is a plain `nn.ModuleList`
in layer order (groups first, then remainder layers, as the JAX stack
applies them), and `scan_layers`/`remat` have no meaning.

Decode threads one KV cache dict per layer through the stack; the caches
are updated in place.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
from torch import nn

from . import attention as attn
from . import common as cm
from . import ffn as ffn_mod
from .common import Config

SUPPORTED_KINDS = ("global", "mlp")

State = List[Dict[str, torch.Tensor]]


def _check_supported(cfg: Config) -> None:
    kinds = {tuple(k) for k in cfg.layer_kinds()}
    if cfg.family != "decoder" or cfg.frontend != "none" or \
            kinds != {SUPPORTED_KINDS} or not cfg.tie_embeddings or \
            cfg.qk_norm:
        raise NotImplementedError(
            f"{cfg.name}: the port runs decoders with tied embeddings and "
            f"no qk_norm whose layers are all {SUPPORTED_KINDS}; got "
            f"family={cfg.family}, frontend={cfg.frontend}, "
            f"layers={sorted(kinds)}, tie_embeddings={cfg.tie_embeddings}, "
            f"qk_norm={cfg.qk_norm}")


# ---------------------------------------------------------------------------
# single layer
# ---------------------------------------------------------------------------

class Layer(nn.Module):
    """One (global attention, mlp) layer (the JAX `layer_init`)."""

    def __init__(self, cfg: Config, generator: torch.Generator, dev):
        super().__init__()
        self.n1 = cm.RMSNorm(cfg.d_model, dev)
        self.mix = attn.Attention(cfg, generator, dev)
        self.n2 = cm.RMSNorm(cfg.d_model, dev)
        self.ffn = ffn_mod.MLP(cfg, generator, dev)


def _ffn_block(p: Layer, x, cfg: Config):
    h = cm.rmsnorm(p.n2, x, cfg.norm_eps)
    return x + ffn_mod.mlp_apply(p.ffn, h, cfg)


def layer_apply(p: Layer, x, cfg: Config):
    h = cm.rmsnorm(p.n1, x, cfg.norm_eps)
    x = x + attn.apply(p.mix, h, cfg)
    return _ffn_block(p, x, cfg)


def layer_decode(p: Layer, x, state, index, cfg: Config):
    h = cm.rmsnorm(p.n1, x, cfg.norm_eps)
    y, state = attn.decode_step(p.mix, h, state, index, cfg)
    return _ffn_block(p, x + y, cfg), state


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

class LM(nn.Module):
    """Embedding, layer stack and final norm (the JAX `lm.init` params);
    `forward` and `decode_step` below run it."""

    def __init__(self, cfg: Config, generator: torch.Generator, dev):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.embed = cm.embed_init(generator, cfg, dev)
        self.stack = nn.ModuleList(
            [Layer(cfg, generator, dev) for _ in range(cfg.n_layers)])
        self.nf = cm.RMSNorm(cfg.d_model, dev)

    @property
    def device(self) -> torch.device:
        return self.embed["e"].device


def init(generator: torch.Generator, cfg: Config, device="cuda") -> LM:
    """Random params from `generator`, which must live on `device`."""
    dev = cm.device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, params on {dev}")
    return LM(cfg, generator, dev)


def _embed_tokens(params: LM, tokens, cfg: Config):
    e = params.embed["e"]
    # sqrt(d_model) is rounded to the embedding dtype first, as in the JAX
    # code: in bf16, sqrt(960) becomes 31.0
    s = float(torch.tensor(math.sqrt(cfg.d_model),
                           dtype=torch.float32).to(e.dtype))
    return (e[tokens] * s).to(cfg.adtype)


def _logits(params: LM, x, cfg: Config):
    xf = cm.rmsnorm(params.nf, x, cfg.norm_eps)
    logits = xf.to(torch.float32) @ params.embed["e"].to(torch.float32).T
    return cm.softcap(logits, cfg.final_softcap)


def forward(params: LM, tokens, *, last_only: bool = False):
    """Logits [B, S, V] (or [B, 1, V] with `last_only`) for tokens [B, S].

    The JAX function also returns the MoE aux loss, which is zero for
    every family this port runs, so it is left out.
    """
    cfg = params.cfg
    x = _embed_tokens(params, tokens, cfg)
    for layer in params.stack:
        x = layer_apply(layer, x, cfg)
    if last_only:
        x = x[:, -1:]
    return _logits(params, x, cfg)


def decode_state_init(cfg: Config, batch: int, max_len: int,
                      device="cuda") -> State:
    dev = cm.device(device)
    return [attn.init_cache(cfg, batch, max_len, dev)
            for _ in range(cfg.n_layers)]


def decode_step(params: LM, token, states: State, index):
    """One decode step: token [B, 1] -> (logits [B, 1, V], states).

    `index` is a scalar or a [B] vector of positions; `states` is
    updated in place and returned.
    """
    cfg = params.cfg
    x = _embed_tokens(params, token, cfg)
    index = attn.positions(index, x.shape[0], x.device)
    for layer, state in zip(params.stack, states):
        x, _ = layer_decode(layer, x, state, index, cfg)
    return _logits(params, x, cfg), states
