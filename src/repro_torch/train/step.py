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

`make_jitted_train_step` is the compiled step over a mesh: the state
placed by `state_specs` and the batch by `batch_specs`, and on one card
the eager step on plain tensors.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from ..models import lm
from ..models.common import Config
from ..parallel import sharding as shd
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


def state_specs(cfg: Config, tcfg: TrainConfig) -> Dict[str, Any]:
    """Logical axes of the train state: ``params`` by state-dict name
    (`lm.specs`), ``opt`` mirroring them, ``step`` a scalar."""
    pspecs = lm.specs(cfg)
    return {"params": pspecs, "opt": opt.state_specs(pspecs, tcfg.adamw),
            "step": ()}


def batch_specs() -> Dict[str, tuple]:
    return {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}


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
        grads = {n: torch.zeros_like(p, dtype=adt)
                 for n, p in model.named_parameters()}
        loss = 0.0
        for mb in _split_micro(batch, nmb):
            lv, _, g = loss_and_grads(model, mb, tcfg)
            for n, acc in grads.items():
                acc += shd.like((g[n] / nmb).to(adt), acc)
            del g
            loss = loss + lv / nmb
        metrics = {"nll": loss,
                   "aux": torch.zeros((), dtype=torch.float32, device=dev)}
    opt.apply_updates(dict(model.named_parameters()), grads, state["opt"],
                      state["step"], tcfg.adamw)
    state["step"] += 1
    return state, {"loss": loss, "grad_norm": opt.global_norm(grads),
                   **metrics}


def place_state(mesh, sspecs, state: Dict[str, Any]) -> None:
    """Place the train state on `mesh` by its specs, in place: the
    model's params as `DTensor` params (their gradients stay on), the
    moments and the step alike; a no-op once placed."""
    model = state["params"]
    if isinstance(model.embed["e"], DTensor):
        return
    shd.place_module(model, mesh, shd.shardings_pruned(
        mesh, sspecs["params"], model.state_dict()))
    where = shd.shardings_pruned(mesh, sspecs["opt"], state["opt"])
    for name, moments in state["opt"].items():
        for k in moments:
            moments[k] = shd.place(moments[k], mesh, where[name][k])
    state["step"] = shd.place(state["step"], mesh,
                              shd.placements(mesh, sspecs["step"]))


def make_jitted_train_step(mesh, cfg: Config, tcfg: TrainConfig,
                           rules: Optional[dict] = None):
    """`train_step` over `mesh` (a `torch.distributed` `DeviceMesh`):
    ``fn(state, batch) -> (state, metrics)``, the state updated in place
    (the counterpart of ``donate_argnums``).

    On a mesh of many ranks the state is placed by `state_specs` through
    `shardings_pruned` under `rules` (once, in place) and the batch by
    `batch_specs`, and the step runs on `DTensor`s, with plain tensors
    made inside the model taken as replicated; the metrics are
    `DTensor`s too.  On one rank nothing is placed and the step is the
    eager `train_step` (on a card, not captured).
    """
    shd.set_mesh_axes(mesh.mesh_dim_names)
    shd.set_active_rules(rules)
    if mesh.size() == 1:
        return functools.partial(train_step, cfg=cfg, tcfg=tcfg)
    sspecs = shd.tree_specs(state_specs(cfg, tcfg), rules)
    bspecs = batch_specs()

    def fn(state: Dict[str, Any], batch: Batch):
        with implicit_replication():
            place_state(mesh, sspecs, state)
            dev = state["params"].device
            batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
            # a frontend's embeddings [batch, frames, d] ride along by batch
            where = shd.shardings_pruned(mesh, shd.tree_specs(
                {k: bspecs.get(k, ("batch", None, None)) for k in batch},
                rules), batch)
            batch = {k: shd.place(v, mesh, where[k])
                     for k, v in batch.items()}
            return train_step(state, batch, cfg, tcfg)
    return fn
