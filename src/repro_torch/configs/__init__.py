"""Architecture registry of the port: the JAX package's ten configs
(`REGISTRY`, `ARCHS`), and the architectures only the port runs
(`PORT_ONLY`: deepseek-v2-lite, whose latent attention the JAX package
does not have).  `get` and `NAMES` take both.

``get("mixtral-8x7b")`` returns the exact published config;
``get("mixtral-8x7b", quant_bits=8)`` returns the CoMeFa bit-plane
quantized variant (weight-only, packed planes).
"""
import dataclasses

from . import (arctic_480b, deepseek_v2_lite, gemma2_27b, gemma3_27b,
               mixtral_8x7b, paligemma_3b, recurrentgemma_2b, smollm_360m,
               starcoder2_7b, whisper_small, xlstm_1_3b)

_MODULES = (xlstm_1_3b, mixtral_8x7b, arctic_480b, smollm_360m, gemma2_27b,
            gemma3_27b, starcoder2_7b, recurrentgemma_2b, whisper_small,
            paligemma_3b)
REGISTRY = {m.CONFIG.name: m.CONFIG for m in _MODULES}
ARCHS = tuple(REGISTRY)
PORT_ONLY = {deepseek_v2_lite.CONFIG.name: deepseek_v2_lite.CONFIG}
NAMES = ARCHS + tuple(PORT_ONLY)


def get(name, quant_bits=None, **overrides):
    cfg = REGISTRY[name] if name in REGISTRY else PORT_ONLY[name]
    if quant_bits is not None:
        overrides["quant_bits"] = quant_bits
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg
