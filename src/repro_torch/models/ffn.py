"""Feed-forward layers: the gated MLP (the port of `repro.models.ffn`'s
dense branch; the MoE joins with the families that use it)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

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


def mlp_apply(params: MLP, x: torch.Tensor, cfg: Config) -> torch.Tensor:
    act = cm.activation(cfg.act)
    h = act(cm.linear(params.wg, x)) * cm.linear(params.wi, x)
    return cm.linear(params.wo, h)
