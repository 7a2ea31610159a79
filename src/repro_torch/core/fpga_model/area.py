"""Area model: Table III breakdown + Table IV CoMeFa-vs-CCB comparison.

Block-level overheads come from COFFE in the paper; we encode the published
numbers and verify their internal consistency (block overhead x block count
vs. chip-level overhead against the 15% BRAM area share of Table I).
"""
from __future__ import annotations

from typing import Dict

from . import resources as R

# Table III: percentage area breakdown of the RAM tile
TABLE_III: Dict[str, Dict[str, float]] = {
    "bram":     {"crossbars": 5.6, "decoders": 7.8, "drivers_sa": 6.9,
                 "cell_array": 53.4, "routing": 26.0, "pes": 0.0},
    "comefa-d": {"crossbars": 4.5, "decoders": 6.3, "drivers_sa": 14.0,
                 "cell_array": 43.0, "routing": 20.9, "pes": 11.1},
    "comefa-a": {"crossbars": 5.2, "decoders": 7.3, "drivers_sa": 6.4,
                 "cell_array": 49.6, "routing": 24.1, "pes": 7.1},
}

# block-level area overheads (Sec. IV-D)
BLOCK_OVERHEAD_UM2 = {"comefa-d": 1546.78, "comefa-a": 493.5, "ccb": 872.64}
BLOCK_OVERHEAD_FRAC = {"comefa-d": 0.254, "comefa-a": 0.081, "ccb": 0.168}
CHIP_OVERHEAD_FRAC = {"comefa-d": 0.038, "comefa-a": 0.012, "ccb": 0.025}


def baseline_bram_tile_um2(variant: str = "comefa-d") -> float:
    """Baseline BRAM tile area implied by overhead_um2 / overhead_frac."""
    return BLOCK_OVERHEAD_UM2[variant] / BLOCK_OVERHEAD_FRAC[variant]


def chip_area_um2() -> float:
    """Die area implied by 1518 BRAM tiles being 15% of the chip."""
    return R.BRAMS * baseline_bram_tile_um2() / R.BRAM_AREA_FRAC


def chip_overhead(variant: str) -> float:
    """Chip-level overhead from first principles (cross-check of Sec IV-D)."""
    return R.BRAMS * BLOCK_OVERHEAD_UM2[variant] / chip_area_um2()


# Table IV qualitative comparison (encoded for the benchmark report)
TABLE_IV = {
    "activate_two_wordlines":  {"ccb": True, "comefa-d": False, "comefa-a": False},
    "extra_voltage_source":    {"ccb": True, "comefa-d": False, "comefa-a": False},
    "extra_row_decoder":       {"ccb": True, "comefa-d": False, "comefa-a": False},
    "sense_amp_changes":       {"ccb": True, "comefa-d": False, "comefa-a": False},
    "extra_sense_amps":        {"ccb": True, "comefa-d": True, "comefa-a": False},
    "sense_amp_cycling":       {"ccb": False, "comefa-d": False, "comefa-a": True},
    "dual_port_compute":       {"ccb": False, "comefa-d": True, "comefa-a": True},
    "generic_pe":              {"ccb": False, "comefa-d": True, "comefa-a": True},
    "inter_ram_shift":         {"ccb": False, "comefa-d": True, "comefa-a": True},
    "float_support":           {"ccb": False, "comefa-d": True, "comefa-a": True},
    "parallelism":             {"ccb": 128, "comefa-d": 160, "comefa-a": 160},
    "clock_overhead_pct":      {"ccb": 60, "comefa-d": 25, "comefa-a": 125},
    "practicality":            {"ccb": "low", "comefa-d": "medium",
                                "comefa-a": "high"},
}
