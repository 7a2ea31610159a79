"""The port's analytical FPGA model (`repro_torch.core.fpga_model`) held
to the JAX package's, number for number.

The model is host arithmetic (numpy and the `comefa.timing` closed forms,
plus real `GemvPlan` schedules for the achieved rates), copied into the
port so that it imports nothing of `repro`.  Every number must be exactly
equal (``==`` on floats): the Fig 9 speedups in both pricing modes, the
co-mapping sweeps, the serving roofline, the grid sweep, energy savings,
area overheads, throughput gains, and the published tables and constants.
"""
import dataclasses

import pytest

from repro.core.fpga_model import area as jax_area
from repro.core.fpga_model import energy as jax_energy
from repro.core.fpga_model import perf as jax_perf
from repro.core.fpga_model import resources as jax_resources
from repro.core.fpga_model import throughput as jax_throughput
from repro_torch.core.fpga_model import (area, energy, perf, resources,
                                         throughput)

VARIANTS = ("comefa-d", "comefa-a", "ccb")
PAIRS = [(area, jax_area), (energy, jax_energy), (perf, jax_perf),
         (resources, jax_resources), (throughput, jax_throughput)]


@pytest.mark.parametrize("mod,ref", PAIRS, ids=lambda m: m.__name__)
def test_module_constants_equal(mod, ref):
    """Every public number, table and dataclass constant of the module."""
    def plain(v):
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            return (type(v).__name__, dataclasses.asdict(v))
        if isinstance(v, dict):
            return {k: plain(x) for k, x in v.items()}
        if callable(v):
            return v.__name__
        return v

    def consts(m):
        return {k: plain(v) for k, v in vars(m).items()
                if not k.startswith("_") and (
                    isinstance(v, (int, float, str, dict, tuple))
                    or dataclasses.is_dataclass(v)
                    and not isinstance(v, type))}
    mine, want = consts(mod), consts(ref)
    assert set(mine) == set(want)
    for k in want:
        assert mine[k] == want[k], k


@pytest.mark.parametrize("achieved", [False, True])
def test_run_all_equal(achieved):
    got = perf.run_all(achieved=achieved)
    assert got == jax_perf.run_all(achieved=achieved)
    assert set(got) >= set(perf.PAPER_SPEEDUPS) | {"gemv_grid8"}


@pytest.mark.parametrize("bench", sorted(jax_perf.BENCHES))
@pytest.mark.parametrize("variant", VARIANTS)
def test_bench_results_equal(bench, variant):
    for achieved in (False, True):
        got = perf.BENCHES[bench](variant, achieved=achieved)
        want = jax_perf.BENCHES[bench](variant, achieved=achieved)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.speedup == want.speedup
    assert perf.comapping_sweep(variant, bench) == \
        jax_perf.comapping_sweep(variant, bench)


@pytest.mark.parametrize("variant", VARIANTS)
def test_sweeps_equal(variant):
    for g in (1, 2, 8, 64):
        for achieved in (False, True):
            assert perf.gemv_grid(variant, g=g, achieved=achieved).speedup \
                == jax_perf.gemv_grid(variant, g=g,
                                      achieved=achieved).speedup
    for bits in range(4, 21, 4):                 # Fig 12
        assert perf.reduction(variant, bits=bits).speedup == \
            jax_perf.reduction(variant, bits=bits).speedup
    assert perf.eltwise(variant, dram_limited=False).speedup == \
        jax_perf.eltwise(variant, dram_limited=False).speedup


@pytest.mark.parametrize("kw", [
    {}, {"recode": "naf"}, {"w_bits": 4, "x_bits": 8, "d_model": 960,
                            "d_ff": 2560, "n_layers": 32}])
def test_serve_roofline_equal(kw):
    assert perf.serve_roofline(**kw) == jax_perf.serve_roofline(**kw)


def test_energy_and_area_equal():
    assert energy.all_savings() == jax_energy.all_savings()
    for variant in VARIANTS:
        assert area.chip_overhead(variant) == jax_area.chip_overhead(variant)
        assert area.baseline_bram_tile_um2(variant) == \
            jax_area.baseline_bram_tile_um2(variant)
    assert area.chip_area_um2() == jax_area.chip_area_um2()


@pytest.mark.parametrize("prec", sorted(jax_throughput.PRECS))
def test_throughput_gains_equal(prec):
    for variant in VARIANTS:
        assert throughput.throughput_gain(prec, variant) == \
            jax_throughput.throughput_gain(prec, variant)
        assert throughput.comefa_mac_throughput(
            resources.VARIANTS[variant], prec) == \
            jax_throughput.comefa_mac_throughput(
                jax_resources.VARIANTS[variant], prec)
    assert throughput.fpga_mac_throughput(prec) == \
        jax_throughput.fpga_mac_throughput(prec)
