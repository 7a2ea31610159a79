"""Assigned input shapes x architectures: the 40-cell dry-run matrix.

The port of `repro.launch.shapes`.  Each cell provides stand-ins for
every input of the step being analysed, as tensors on the ``meta``
device (shapes and dtypes, no storage), where the JAX package gives
`ShapeDtypeStruct`s - no device allocation ever happens here.

  train_4k     seq 4096   global_batch 256   -> train_step
  prefill_32k  seq 32768  global_batch 32    -> prefill forward
  decode_32k   seq 32768  global_batch 128   -> serve_step (1 new token)
  long_500k    seq 524288 global_batch 1     -> serve_step (1 new token)

long_500k runs only for sub-quadratic archs (SSM / hybrid / sliding-window
local attention); pure full-attention archs skip it.  Encoder-only archs
would skip decode shapes; all ten assigned archs here are
decoder-bearing, so only the long_500k rule filters cells.

The decode states are the port's, one dict a layer
(`lm.decode_state_init` on the meta device), where the JAX package
stacks a pattern period's layers; leaf for leaf they have JAX's shapes
and dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from .. import configs
from ..models import lm
from ..models.common import Config

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeCase:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeCase("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCase("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCase("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCase("long_500k", 524288, 1, "decode"),
}

# archs with bounded-memory token mixing (recurrent state or sliding
# window); pure full-attention archs skip long_500k
SUB_QUADRATIC = {"xlstm-1.3b", "mixtral-8x7b", "gemma2-27b", "gemma3-27b",
                 "recurrentgemma-2b"}


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells honoring the long_500k rule."""
    out = []
    for arch in configs.ARCHS:
        for sname in SHAPES:
            skip = sname == "long_500k" and arch not in SUB_QUADRATIC
            if include_skipped or not skip:
                out.append((arch, sname, skip))
    return out


def _tokens(b: int, s: int) -> torch.Tensor:
    return torch.empty((b, s), dtype=torch.int32, device=META)


def input_specs(arch: str, shape: str, quant_bits: Optional[int] = None,
                cfg: Optional[Config] = None,
                seq_len: Optional[int] = None) -> Dict[str, Any]:
    """Meta tensors for every input of the analysed step.

    Returns {"cfg", "kind", "batch": {...}} where batch matches the step's
    signature: train -> {tokens, labels [+ enc_inputs/prefix_embeddings]};
    prefill -> same minus labels; decode -> {token, states, index [+ ctx]}.
    `cfg` replaces the registry's config of `arch` (a cut-down depth),
    `seq_len` the case's length (a cut length).
    """
    cfg = cfg or configs.get(arch, quant_bits=quant_bits)
    case = SHAPES[shape]
    b, s = case.global_batch, seq_len or case.seq_len
    out: Dict[str, Any] = {"cfg": cfg, "kind": case.kind}
    emb = (b, cfg.frontend_len, cfg.d_model)

    if case.kind in ("train", "prefill"):
        batch: Dict[str, Any] = {"tokens": _tokens(b, s)}
        if case.kind == "train":
            batch["labels"] = _tokens(b, s)
        if cfg.family == "encdec":
            batch["enc_inputs"] = torch.empty(emb, dtype=cfg.adtype,
                                              device=META)
        elif cfg.frontend == "vision_stub":
            batch["prefix_embeddings"] = torch.empty(emb, dtype=cfg.adtype,
                                                     device=META)
    else:
        batch = {"token": _tokens(b, 1),
                 "states": lm.decode_state_init(cfg, b, s, META),
                 "index": torch.empty((), dtype=torch.int32, device=META)}
        if cfg.family == "encdec":
            batch["ctx"] = torch.empty(emb, dtype=cfg.adtype, device=META)
    out["batch"] = batch
    return out


def param_structs(cfg: Config) -> lm.LM:
    """The model with its params on the meta device: shapes and dtypes,
    without allocating."""
    return lm.LM(cfg, torch.Generator(), META)
