"""The weights of a run, made on the device from its seed, and the port's
model built on them.

The benchmark makes the float weights and hands the same tensors to both
sides: the port packs its projections from them in its own set-up
(`repro_torch.quant.bitplane.quantize_pack`), and the reference quantises
them again for itself.  Random numbers come from one `torch.Generator`
on the device, one call for each dtype, in the dtype the leaf is served
in (bf16 for embeddings, heads and experts; float32 for the projections
the port packs and for routers); norm gains are ones, as the port's init
has them (its RMSNorm scales by 1 + g, so by 2).  Standard deviations are
the port's init: 0.02 for the embedding and the router, 1/sqrt(fan-in)
for every other matrix.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import torch

PACKED = ".packed"


@dataclasses.dataclass
class Weights:
    float_weights: Dict[str, torch.Tensor]   # name -> tensor, as made
    projections: List[Tuple[str, int, int]]  # packed: (name, K, N)
    model: object                            # the port's lm.LM


def _std(name: str, shape) -> float:
    if name == "embed.e" or name.endswith("router.w"):
        return 0.02
    return 1.0 / math.sqrt(shape[-2])


def _draw(gen: torch.Generator, leaves, dtype, dev) -> Dict[str,
                                                            torch.Tensor]:
    total = sum(math.prod(shape) for _, shape in leaves)
    if not total:
        return {}
    buf = torch.randn(total, dtype=dtype, device=dev, generator=gen)
    out, off = {}, 0
    for name, shape in leaves:
        n = math.prod(shape)
        out[name] = buf[off:off + n].view(shape).mul_(_std(name, shape))
        off += n
    return out


def build(cfg, seed: int, dev: torch.device) -> Weights:
    """Float weights from `seed` and the port's `lm.LM` for `cfg` on
    them (an `repro_torch.models.common.Config`)."""
    from repro_torch.models import lm
    from repro_torch.quant import bitplane

    meta = lm.LM(cfg, torch.Generator(), torch.device("meta"))
    layout = {k: (tuple(v.shape), v.dtype)
              for k, v in meta.state_dict().items()}
    del meta
    f32, bf16, ones, projections = [], [], [], []
    for name, (shape, dtype) in layout.items():
        if name.endswith(PACKED):
            base = name[:-len(PACKED)]
            k, n = shape[1] * bitplane.LANES, shape[2]
            f32.append((base + ".w", (k, n)))
            projections.append((base, k, n))
        elif name.endswith(".scale"):
            continue
        elif name.endswith(".g"):
            ones.append((name, shape))
        elif dtype == torch.float32:
            f32.append((name, shape))
        elif dtype == cfg.adtype:
            bf16.append((name, shape))
        else:
            raise ValueError(f"{name}: no rule for a {dtype} leaf")
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    fw = {**_draw(gen, f32, torch.float32, dev),
          **_draw(gen, bf16, cfg.adtype, dev)}
    for name, shape in ones:
        fw[name] = torch.ones(shape, dtype=torch.float32, device=dev)
    sd = {}
    for name in layout:
        if name.endswith(PACKED):
            base = name[:-len(PACKED)]
            sd[name], sd[base + ".scale"] = bitplane.quantize_pack(
                fw[base + ".w"], cfg.quant_bits, axis=0)
        elif not name.endswith(".scale"):
            sd[name] = fw[name]
    model = lm.LM(cfg, torch.Generator(), torch.device("meta"))
    model.load_state_dict(sd, strict=True, assign=True)
    return Weights(fw, projections, model)
