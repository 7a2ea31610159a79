"""Peak MAC throughput model (paper Fig. 8).

CoMeFa throughput is derived from first principles: every block computes
`lanes` MACs every `mac_cycles(precision)` cycles (formulas of Sec. III,
validated bit-exactly by the simulator tests).  The baseline LB/DSP fabric
throughput uses the calibrated constants in `resources.py`.
"""
from __future__ import annotations

from typing import Dict

from ..comefa import timing
from . import resources as R

PRECS = {p.name: p for p in timing.PRECISIONS}


def comefa_mac_throughput(variant: R.RamVariant, precision: str,
                          n_blocks: int = R.BRAMS) -> float:
    """MACs/s of n_blocks compute RAMs at a given precision."""
    p = PRECS[precision]
    if p.is_float and not variant.supports_float:
        return 0.0
    cyc = p.mac() * variant.logic_cycle_factor
    return n_blocks * variant.lanes * variant.freq / cyc


def dsp_mac_throughput(precision: str) -> float:
    return (R.DSP_SLICES * R.DSP_MACS_PER_SLICE[precision]
            * R.DSP_MAC_FREQ[precision])


def lb_mac_throughput(precision: str) -> float:
    return R.LB_MACS_TOTAL[precision] * R.LB_MAC_FREQ[precision]


def fpga_mac_throughput(precision: str, ram_variant: str | None = None
                        ) -> Dict[str, float]:
    """Whole-FPGA peak MAC/s, per compute resource (one Fig. 8 bar group)."""
    out = {"lb": lb_mac_throughput(precision),
           "dsp": dsp_mac_throughput(precision),
           "ram": 0.0}
    if ram_variant is not None:
        out["ram"] = comefa_mac_throughput(R.VARIANTS[ram_variant], precision)
    out["total"] = out["lb"] + out["dsp"] + out["ram"]
    return out


def throughput_gain(precision: str, ram_variant: str) -> float:
    """FPGA throughput multiplier from adding compute RAMs (Fig. 8 text)."""
    base = fpga_mac_throughput(precision)["total"]
    aug = fpga_mac_throughput(precision, ram_variant)["total"]
    return aug / base


# the gains the paper reports in Sec. V-A (for tests / benchmark output)
PAPER_GAINS_D = {"int4": 2.0, "int8": 1.7, "int16": 1.3,
                 "hfp8": 1.7, "fp16": 1.3}
PAPER_GAINS_A = {"int4": 1.5, "int8": 1.36, "int16": 1.16,
                 "hfp8": 1.36, "fp16": 1.15}
