"""Architecture registry of the port: the configs whose families it runs.

``get("smollm-360m", quant_bits=8)`` returns the CoMeFa bit-plane
quantized variant (weight-only, packed planes).  The JAX package's other
configs (MoE, encoder-decoder, prefix-LM) join as their families are
ported.
"""
import dataclasses

from . import (gemma2_27b, gemma3_27b, recurrentgemma_2b, smollm_360m,
               starcoder2_7b, xlstm_1_3b)

_MODULES = (xlstm_1_3b, smollm_360m, gemma2_27b, gemma3_27b, starcoder2_7b,
            recurrentgemma_2b)
REGISTRY = {m.CONFIG.name: m.CONFIG for m in _MODULES}
ARCHS = tuple(REGISTRY)


def get(name, quant_bits=None, **overrides):
    cfg = REGISTRY[name]
    if quant_bits is not None:
        overrides["quant_bits"] = quant_bits
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg
