"""Carry the JAX package's params across to the port.

The input is the JAX param tree with every leaf a numpy array (for
example ``jax.tree.map(np.asarray, params)``); nothing here imports JAX.
Both of the JAX stack layouts are read: ``stack.groups.l<i>.*`` with a
leading layer axis (``scan_layers=True``) and ``stack.group_list[g]``
(``scan_layers=False``), each followed by the ``stack.rem`` layers.
Packed ``uint32`` planes become ``int32`` with the same bits.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .models import common as cm
from .models import lm


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _flat(tree: Dict, prefix: str) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}.{k}"))
        else:
            out[f"{prefix}.{k}"] = v
    return out


def _layers(stack: Dict) -> List[Dict[str, np.ndarray]]:
    """The JAX stack's layers, flattened, in the order they apply."""
    layers = []
    groups = stack.get("groups")
    if groups:
        flat = [_flat(groups[f"l{i}"], "") for i in range(len(groups))]
        n_groups = len(next(iter(flat[0].values())))
        for g in range(n_groups):
            layers += [{k: v[g] for k, v in f.items()} for f in flat]
    for group in stack.get("group_list", []):
        layers += [_flat(group[f"l{i}"], "") for i in range(len(group))]
    layers += [_flat(layer, "") for layer in stack.get("rem", [])]
    return layers


def state_dict(params: Dict) -> Dict[str, torch.Tensor]:
    """JAX param tree (numpy leaves) -> the port's `lm.LM` state dict."""
    flat = {**_flat(params["embed"], "embed"), **_flat(params["nf"], "nf")}
    for j, layer in enumerate(_layers(params["stack"])):
        flat.update({f"stack.{j}{k}": v for k, v in layer.items()})
    return {k: _tensor(v) for k, v in flat.items()}


def load(params: Dict, cfg: cm.Config, device="cuda") -> lm.LM:
    """An `lm.LM` for `cfg` holding the JAX params, on `device`."""
    dev = cm.device(device)
    model = lm.LM(cfg, torch.Generator(), torch.device("meta"))
    sd = state_dict(params)
    want = model.state_dict()
    for k, t in sd.items():
        if k in want and t.dtype != want[k].dtype:
            raise ValueError(f"{k}: {t.dtype} in the params, "
                             f"{want[k].dtype} for {cfg.name}")
    model.load_state_dict(sd, strict=True, assign=True)
    return model.to(dev)
