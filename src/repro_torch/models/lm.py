"""LM assembly: decoder layers -> a stack -> the full model.

The port of `repro.models.lm` for decoder-only families: a layer is a
(mixer, ffn) pair, the mixer ``global`` or ``local`` attention,
``mlstm``, ``slstm`` or ``rglru`` and the ffn ``mlp`` or ``none``.  The
JAX package stacks homogeneous layer groups under `lax.scan`; here the
stack is a plain `nn.ModuleList` in layer order, layer j of kind
``pattern[j % len(pattern)]`` (groups first, then the remainder layers,
as the JAX stack applies them), and `scan_layers`/`remat` have no
meaning.

Decode threads one state dict per layer through the stack (a KV cache
for attention, the recurrent state otherwise); the states are updated in
place.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
from torch import nn

from . import attention as attn
from . import common as cm
from . import ffn as ffn_mod
from . import recurrent as rec
from .common import Config

MIXERS = ("global", "local", "mlstm", "slstm", "rglru")
FFNS = ("mlp", "none")
_ATTENTION = ("global", "local")

State = List[Dict[str, torch.Tensor]]


def _check_supported(cfg: Config) -> None:
    """Refuse what the port does not run yet: MoE FFNs, cross and
    bidirectional attention, encoder-decoders, frontends and prefix-LMs."""
    kinds = sorted({tuple(k) for k in cfg.layer_kinds()})
    bad = [k for k in kinds if k[0] not in MIXERS or k[1] not in FFNS]
    if cfg.family != "decoder" or cfg.frontend != "none" or \
            cfg.prefix_lm or bad:
        raise NotImplementedError(
            f"{cfg.name}: the port runs decoder-only models whose layers "
            f"mix with one of {MIXERS} and have an ffn of {FFNS}; got "
            f"family={cfg.family}, frontend={cfg.frontend}, "
            f"prefix_lm={cfg.prefix_lm}, layers={kinds}")


# ---------------------------------------------------------------------------
# single layer
# ---------------------------------------------------------------------------

_MIXER_PARAMS = {"global": attn.Attention, "local": attn.Attention,
                 "mlstm": rec.MLSTM, "slstm": rec.SLSTM, "rglru": rec.RGLRU}


class Layer(nn.Module):
    """One (mixer, ffn) layer (the JAX `layer_init`); a layer whose ffn is
    ``none`` has no ``n2`` and no ``ffn``."""

    def __init__(self, cfg: Config, generator: torch.Generator, dev,
                 kinds: Tuple[str, str]):
        super().__init__()
        self.kinds = tuple(kinds)
        mixer, f = self.kinds
        self.n1 = cm.RMSNorm(cfg.d_model, dev)
        self.mix = _MIXER_PARAMS[mixer](cfg, generator, dev)
        if f == "mlp":
            self.n2 = cm.RMSNorm(cfg.d_model, dev)
            self.ffn = ffn_mod.MLP(cfg, generator, dev)


def _ffn_block(p: Layer, x, cfg: Config):
    if p.kinds[1] == "none":
        return x
    h = cm.rmsnorm(p.n2, x, cfg.norm_eps)
    return x + ffn_mod.mlp_apply(p.ffn, h, cfg)


def layer_apply(p: Layer, x, cfg: Config):
    mixer = p.kinds[0]
    h = cm.rmsnorm(p.n1, x, cfg.norm_eps)
    if mixer in _ATTENTION:
        y = attn.apply(p.mix, h, cfg, kind=mixer)
    elif mixer == "mlstm":
        y = rec.mlstm_apply(p.mix, h, cfg)
    elif mixer == "slstm":
        y = rec.slstm_apply(p.mix, h, cfg)
    else:
        y = rec.rglru_apply(p.mix, h, cfg)
    return _ffn_block(p, x + y, cfg)


def layer_state_init(cfg: Config, batch: int, max_len: int, kinds,
                     dev) -> Dict[str, torch.Tensor]:
    mixer = kinds[0]
    if mixer in _ATTENTION:
        return attn.init_cache(cfg, batch, max_len, dev, kind=mixer)
    if mixer == "mlstm":
        return rec.mlstm_state_init(cfg, batch, dev)
    if mixer == "slstm":
        return rec.slstm_state_init(cfg, batch, dev)
    return rec.rglru_state_init(cfg, batch, dev)


def layer_decode(p: Layer, x, state, index, cfg: Config):
    mixer = p.kinds[0]
    h = cm.rmsnorm(p.n1, x, cfg.norm_eps)
    if mixer in _ATTENTION:
        y, state = attn.decode_step(p.mix, h, state, index, cfg, kind=mixer)
    elif mixer == "mlstm":
        y, state = rec.mlstm_decode(p.mix, h, state, cfg)
    elif mixer == "slstm":
        y, state = rec.slstm_apply(p.mix, h, cfg, state=state,
                                   return_state=True)
    else:
        y, state = rec.rglru_decode(p.mix, h, state, cfg)
    return _ffn_block(p, x + y, cfg), state


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

class LM(nn.Module):
    """Embedding, layer stack, final norm and, where the embeddings are not
    tied, the output ``head`` (the JAX `lm.init` params); `forward` and
    `decode_step` below run it."""

    def __init__(self, cfg: Config, generator: torch.Generator, dev):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.embed = cm.embed_init(generator, cfg, dev)
        self.stack = nn.ModuleList(
            [Layer(cfg, generator, dev, kinds) for kinds in cfg.layer_kinds()])
        self.nf = cm.RMSNorm(cfg.d_model, dev)
        if not cfg.tie_embeddings:
            # never packed (as in the JAX package): a plain product
            self.head = cm._init_dense(generator, cfg.d_model, cfg.vocab,
                                       cfg, False, dev)

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


def packed_projections(params: LM) -> int:
    """The model's packed projections: the bit-plane kernel launches of
    one forward or decode call, each projection running once."""
    return sum(1 for m in params.modules()
               if isinstance(m, cm.PackedLinear) and m.packed is not None)


def _logits(params: LM, x, cfg: Config):
    xf = cm.rmsnorm(params.nf, x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = xf.to(torch.float32) @ \
            params.embed["e"].to(torch.float32).T
    else:
        logits = cm.linear(params.head, xf).to(torch.float32)
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
    return [layer_state_init(cfg, batch, max_len, kinds, dev)
            for kinds in cfg.layer_kinds()]


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
