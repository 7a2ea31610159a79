"""Train step: microbatched gradient accumulation + AdamW update.

The port of `repro.train.step`.  The train state is a dict: ``params``
the `lm.LM` (its params with gradients on), ``opt`` the optimizer state
(`optimizer.init_state`, keyed by the params' state-dict names) and
``step`` an int32 0-d tensor, all on the model's device.  `train_step`
updates it in place and returns it with the step's metrics, as device
tensors: nothing in a step waits on the host.

Microbatching bounds the activation and logit footprint: the global batch
splits into `microbatches` contiguous slices whose gradients, each
divided by the count, accumulate in ``accum_dtype`` before one optimizer
update - the numerics of the unsplit step (a mean of means over equal
slices).  As in the JAX function, a microbatched step reports the total
loss as ``nll`` and 0 as ``aux``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch

from ..models import lm
from ..models.common import Config
from . import optimizer as opt

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The JAX package's `TrainConfig`, field for field; ``unroll_accum``
    is kept for parity and ignored (the port's accumulation is a Python
    loop either way)."""
    adamw: opt.AdamWConfig = opt.AdamWConfig()
    microbatches: int = 1
    aux_weight: float = 0.01
    accum_dtype: str = "float32"      # bf16 halves the grad-accum buffer
    unroll_accum: bool = False


def state_for(model: lm.LM, tcfg: TrainConfig) -> Dict[str, Any]:
    """A fresh train state around `model`, whose params get gradients
    (`lm.trainable`: a model with packed projections raises)."""
    params = lm.trainable(model)
    return {"params": model, "opt": opt.init_state(params, tcfg.adamw),
            "step": torch.zeros((), dtype=torch.int32, device=model.device)}


def init_state(generator: torch.Generator, cfg: Config, tcfg: TrainConfig,
               device="cuda") -> Dict[str, Any]:
    """Random params from `generator` (on `device`) and zero moments."""
    return state_for(lm.init(generator, cfg, device), tcfg)


def _split_micro(batch: Batch, n: int) -> List[Batch]:
    b = batch["tokens"].shape[0]
    if b % n:
        raise ValueError(f"batch {b} does not split into {n} microbatches")
    return [{k: x[i * (b // n):(i + 1) * (b // n)] for k, x in batch.items()}
            for i in range(n)]


def loss_and_grads(model: lm.LM, batch: Batch, tcfg: TrainConfig
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                              Dict[str, torch.Tensor]]:
    """(loss, {"nll", "aux"}, grads by param name) of `lm.loss_fn` on one
    (micro)batch on the model's device; a param the loss does not reach
    gets a zero gradient, as in JAX."""
    params = dict(model.named_parameters())
    loss, metrics = lm.loss_fn(model, batch, aux_weight=tcfg.aux_weight)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(params.items(), grads)}
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def train_step(state: Dict[str, Any], batch: Batch, cfg: Config,
               tcfg: TrainConfig) -> Tuple[Dict[str, Any],
                                           Dict[str, torch.Tensor]]:
    """One optimizer step on `batch` (tensors or arrays, moved to the
    model's device): returns the state, updated in place, and the metrics
    ``loss``, ``grad_norm``, ``nll`` and ``aux``."""
    model = state["params"]
    if model.cfg != cfg:
        raise ValueError(f"state holds {model.cfg.name}, step asked for "
                         f"{cfg.name}")
    dev = model.device
    batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    nmb = tcfg.microbatches
    if nmb == 1:
        loss, metrics, grads = loss_and_grads(model, batch, tcfg)
    else:
        adt = getattr(torch, tcfg.accum_dtype)
        grads = {n: torch.zeros(p.shape, dtype=adt, device=dev)
                 for n, p in model.named_parameters()}
        loss = 0.0
        for mb in _split_micro(batch, nmb):
            lv, _, g = loss_and_grads(model, mb, tcfg)
            for n, acc in grads.items():
                acc += (g[n] / nmb).to(adt)
            del g
            loss = loss + lv / nmb
        metrics = {"nll": loss,
                   "aux": torch.zeros((), dtype=torch.float32, device=dev)}
    opt.apply_updates(dict(model.named_parameters()), grads, state["opt"],
                      state["step"], tcfg.adamw)
    state["step"] += 1
    return state, {"loss": loss, "grad_norm": opt.global_norm(grads),
                   **metrics}
