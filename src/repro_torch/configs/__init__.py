"""Architecture registry of the port: the configs whose families it runs.

``get("smollm-360m", quant_bits=8)`` returns the CoMeFa bit-plane
quantized variant (weight-only, packed planes).  The JAX package's other
configs join as their families are ported.
"""
import dataclasses

from . import smollm_360m

_MODULES = (smollm_360m,)
REGISTRY = {m.CONFIG.name: m.CONFIG for m in _MODULES}
ARCHS = tuple(REGISTRY)


def get(name, quant_bits=None, **overrides):
    cfg = REGISTRY[name]
    if quant_bits is not None:
        overrides["quant_bits"] = quant_bits
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg
