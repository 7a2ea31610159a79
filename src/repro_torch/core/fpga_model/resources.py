"""Baseline FPGA + CoMeFa variants: architecture constants (paper Sec. IV).

Everything stated in the paper is encoded verbatim (Table I, Sec. IV-D,
Table IV).  Quantities the paper obtained from VTR/COFFE runs we cannot
re-execute (per-precision soft-logic MAC throughput, achieved baseline
frequencies per benchmark) are *calibration constants*, grouped at the
bottom with the microarchitectural assumption that justifies each; tests
assert that the resulting model reproduces the paper's published ratios.
"""
from __future__ import annotations

import dataclasses

# ---------------------------------------------------------------------------
# Table I: Intel Arria 10 GX900-like baseline FPGA
# ---------------------------------------------------------------------------

LOGIC_BLOCKS = 33_962          # LABs (10 ALMs each)
DSP_SLICES = 2_423
BRAMS = 1_518                  # 20 Kb M20K-like blocks
DRAM_BW_BITS_PER_CLK = 2_048   # 4-port full-width soft HMC controller
CHANNEL_WIDTH = 300
LB_AREA_FRAC = 0.66
DSP_AREA_FRAC = 0.18
BRAM_AREA_FRAC = 0.15

# frequencies (Sec. IV-B / IV-D)
F_BRAM = 735e6                 # baseline BRAM, all port modes
F_DSP_FIXED = 630e6
F_DSP_FLOAT = 550e6
F_COMEFA_D = 588e6             # 1.25x cycle of the BRAM
F_COMEFA_A = 294e6             # 2.5x cycle (sense-amp cycling)
F_CCB = 469e6                  # 1.6x cycle (re-implemented CCB, Sec. IV-D)

# DRAM bandwidth in bits/s terms: the HMC controller delivers 2048 bits per
# *fabric clock*; we anchor it to the BRAM clock domain as the paper's
# designs do for streaming benchmarks.
DRAM_CLK = 266.7e6             # HMC controller user clock (IP core UG)
DRAM_BW_BITS_PER_S = DRAM_BW_BITS_PER_CLK * DRAM_CLK


@dataclasses.dataclass(frozen=True)
class RamVariant:
    """One compute-RAM design point (Table IV row set)."""
    name: str
    freq: float
    lanes: int                       # parallel 1-bit PEs per block
    block_area_overhead: float       # vs baseline BRAM tile
    chip_area_overhead: float        # vs whole FPGA
    logic_cycle_factor: float = 1.0  # cycles per bulk logic op (CCB: 2)
    supports_float: bool = False
    supports_chaining: bool = False
    supports_ooor: bool = False
    block_area_um2: float = 0.0      # added area per block (Sec. IV-D)


BASELINE_BRAM = RamVariant("bram", F_BRAM, 0, 0.0, 0.0)
COMEFA_D = RamVariant("comefa-d", F_COMEFA_D, 160, 0.254, 0.038,
                      logic_cycle_factor=1.0, supports_float=True,
                      supports_chaining=True, supports_ooor=True,
                      block_area_um2=1546.78)
COMEFA_A = RamVariant("comefa-a", F_COMEFA_A, 160, 0.081, 0.012,
                      logic_cycle_factor=1.0, supports_float=True,
                      supports_chaining=True, supports_ooor=True,
                      block_area_um2=493.5)
CCB = RamVariant("ccb", F_CCB, 128, 0.168, 0.025,
                 logic_cycle_factor=2.0, supports_float=False,
                 supports_chaining=False, supports_ooor=False,
                 block_area_um2=872.64)
VARIANTS = {v.name: v for v in (COMEFA_D, COMEFA_A, CCB)}


# ---------------------------------------------------------------------------
# Calibration constants (justified assumptions; see module docstring)
# ---------------------------------------------------------------------------
# Peak MAC throughput of the *baseline* compute fabric per precision, split
# into DSP-path and LB-path terms (MACs/s).  Assumptions:
#  * int4/int8: one MAC per 18x19 multiplier -> 2 MACs/DSP @ 630 MHz for
#    int4; int8 with 27-bit accumulation chains limit to the 27x27 mode
#    for half the slices in practice -> 1.26 MACs/DSP effective.
#  * int16 (36b acc): 27x27 mode, 1 MAC/DSP, accumulator-chain limited.
#  * hfp8: no hard support - DSP mantissa multiplier + LB align/normalize,
#    routing-limited to ~280 MHz per MAC.
#  * fp16: converted to the hard fp32 path with soft conversion logic,
#    effective ~235 MHz per DSP MAC.
#  * LB-path MACs use the ALM estimates from Landy & Stitt-style serial
#    multipliers; they are a small additive term at these precisions.
DSP_MACS_PER_SLICE = {"int4": 2.0, "int8": 1.07, "int16": 1.0,
                      "hfp8": 1.0, "fp16": 1.0}
DSP_MAC_FREQ = {"int4": F_DSP_FIXED, "int8": F_DSP_FIXED,
                "int16": 548e6, "hfp8": 280e6, "fp16": 235e6}
LB_MACS_TOTAL = {"int4": 900, "int8": 620, "int16": 240,
                 "hfp8": 120, "fp16": 80}   # simultaneously-fitting MACs
LB_MAC_FREQ = {"int4": 300e6, "int8": 260e6, "int16": 230e6,
               "hfp8": 210e6, "fp16": 200e6}
