"""Analytical benchmark performance model (paper Figs. 9, 11, 12).

Each of the six paper benchmarks (Table II) is modelled structurally:

  * which resource bounds the baseline (DSP compute / DRAM bandwidth /
    on-chip BRAM port bandwidth),
  * the CoMeFa-side cycle counts from `comefa.timing` (the same formulas the
    bit-level simulator validates),
  * the scenario parameters stated in the paper (precision, storage,
    element counts).

The paper's numbers come from VTR place-and-route across seeds - achieved
frequencies and mapping efficiencies we cannot re-run.  Those effects are
absorbed into one documented `EFFICIENCY[benchmark][variant]` factor
(utilization of the theoretical added-compute rate); everything else is
first-principles.  Tests assert the model reproduces the paper's published
speedups.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict

from ..comefa import timing
from . import resources as R
from .throughput import dsp_mac_throughput, lb_mac_throughput

# ---------------------------------------------------------------------------
# published results (Fig 9; 1.0 = no speedup) - the validation targets
# ---------------------------------------------------------------------------
PAPER_SPEEDUPS = {
    "gemv":            {"comefa-d": 1.81, "comefa-a": 1.59, "ccb": 1.72},
    "fir":             {"comefa-d": 1.22, "comefa-a": 1.22, "ccb": 1.00},
    "eltwise":         {"comefa-d": 1.00, "comefa-a": 1.00, "ccb": 0.00},
    "eltwise_nolimit": {"comefa-d": 1.65, "comefa-a": 1.50, "ccb": 0.00},
    "search":          {"comefa-d": 1.18, "comefa-a": 1.00, "ccb": 1.00},
    "raid":            {"comefa-d": 6.70, "comefa-a": 3.35, "ccb": 5.20},
    "reduction":       {"comefa-d": 5.30, "comefa-a": 3.30, "ccb": 5.10},
}

# utilization of the theoretical added compute rate (absorbs VTR-achieved
# frequency, LCU pipeline overlap efficiency, partial-sum readout, and
# co-mapping split).  1.0 = the full theoretical rate is realized.
EFFICIENCY: Dict[str, Dict[str, float]] = {
    "gemv":            {"comefa-d": 0.578, "comefa-a": 0.843, "ccb": 3.22},
    # eltwise without the DRAM limit is *swizzle-limited*: the paper reports
    # 16748 LBs of swizzle/transpose logic needed to feed the RAMs (vs 649
    # baseline) - only a small fraction of the theoretical RAM rate is fed.
    "eltwise_nolimit": {"comefa-d": 0.1506, "comefa-a": 0.2317},
    # CCB's published RAID point exceeds its 128-lane @469MHz bulk-XOR rate
    # against our calibrated baseline; re-based to [19]'s reported 5.2x.
    "raid":            {"comefa-d": 1.0, "comefa-a": 1.0, "ccb": 1.218},
}
# note on ccb/gemv 3.22: CCB's own evaluation [19] uses a fused bit-serial
# dot product whose per-MAC cycle count is ~3x lower than running our
# general MAC sequence on 2-cycle CCB ops; the factor re-bases to their
# published algorithm. See DESIGN.md.


@dataclasses.dataclass
class BenchResult:
    name: str
    variant: str
    t_baseline: float
    t_augmented: float

    @property
    def speedup(self) -> float:
        return self.t_baseline / self.t_augmented if self.t_augmented else 0.0


def _eff(bench: str, variant: str) -> float:
    return EFFICIENCY.get(bench, {}).get(variant, 1.0)


# ---------------------------------------------------------------------------
# compute-bound: GEMV (int8, DeepBench LSTM h=512 t=50)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _gemv_scheduled_macs_per_lane_cycle(w_bits: int, x_bits: int,
                                        acc_bits: int,
                                        recode: str = "naive") -> float:
    """Steady-state MACs/cycle/lane of the real tiled GEMV schedule.

    Builds a `comefa.schedule.GemvPlan` LCU schedule - k chunked through
    double-buffered resident-weight regions, activations a deterministic
    fixed-seed uniform stream (the SAME values under every recode, so
    digit schedules compare on identical operands: naive sees ~x_bits/2
    set bits, NAF ~x_bits/3 nonzero digits), recoded per ``recode``
    through `ir.specialize_streams` - and reads off the steady-state
    (pipeline-full) tile cost: max(load, compute), the load overlapped
    behind compute.  Several chunks are enough to reach steady state;
    each lane retires ``k_tile`` MACs per tile (the caller scales by the
    variant's lane count, as the closed-form branch does).
    """
    import numpy as np

    from ..comefa import ir as cir
    from ..comefa import schedule as csched
    from ..comefa.isa import N_COLS
    reserve_neg = cir.recode_is_signed(recode)
    k_tile = csched.gemv_k_tile(w_bits, acc_bits, reserve_neg=reserve_neg)
    k = 8 * k_tile
    plan = csched.plan_gemv(k, N_COLS, w_bits, x_bits, acc_bits,
                            reserve_neg=reserve_neg)
    x = np.random.default_rng(0).integers(0, 1 << x_bits, size=k)
    sched = plan.schedule([int(v) for v in x], optimized=True, recode=recode)
    # pipeline-full: each middle tile costs its own bottleneck phase, so
    # the steady-state rate averages them (tile costs vary with the
    # streamed values; taking the worst tile would bias the rate low)
    mids = sched.tile_costs[1:-1]
    steady = sum(max(c) for c in mids) / len(mids)
    return k_tile / steady


def _gemv_ram_rate(variant: str, achieved: bool = False,
                   recode: str = "naive") -> float:
    """Aggregate MAC rate of the whole CoMeFa fleet on the GEMV workload."""
    v = R.VARIANTS[variant]
    if achieved and v.supports_ooor:
        per_lane = _gemv_scheduled_macs_per_lane_cycle(8, 8, 27,
                                                       recode=recode)
        ram_rate = (R.BRAMS * v.lanes * per_lane * v.freq
                    / v.logic_cycle_factor)
    else:
        cyc = (timing.achieved_mac_cycles(8, 27) if achieved
               else timing.mac_cycles(8, 27))
        if v.supports_ooor:
            # OOOR zero-bit skipping, priced from the streamed-digit
            # statistics (naive binary digits: exactly 2x on uniform
            # operands - the paper's reported factor)
            cyc = cyc / timing.zero_skip_speedup(8, "naive")
        ram_rate = R.BRAMS * v.lanes * v.freq / (cyc * v.logic_cycle_factor)
    return ram_rate * _eff("gemv", variant)


def gemv(variant: str, h: int = 512, t: int = 50,
         achieved: bool = False, recode: str = "naive") -> BenchResult:
    """Work is split between DSP chains and CoMeFa RAMs (Sec. IV-C).

    Baseline: DSP-chain MACs at int8.  Proposed: DSPs + CoMeFa RAMs running
    the OOOR dot product (zero-bit skipping halves the per-MAC cycles,
    Sec. III-I); weights are pinned transposed, the vector streams.

    With `achieved=True` the CoMeFa side is priced from the *real*
    scheduled program: the `comefa.schedule.GemvPlan` LCU pipeline
    (weights chunked through double-buffered row regions, loads hidden
    behind the streamed OOOR compute, int8 operands / 27-bit
    accumulator as in Table II).  The closed-form default keeps the
    paper's generic-MAC-halved estimate, validated against Fig 9; the
    scheduled count is honest about the accumulator ripple every real
    add pays, so the achieved speedup sits below the paper point.
    ``recode`` re-prices the achieved schedule with Booth/NAF digit
    streams (`ir.specialize_streams`) instead of naive zero-skipping.
    """
    macs = 4 * h * (2 * h) * t                     # LSTM gate GEMVs
    base_rate = dsp_mac_throughput("int8") + lb_mac_throughput("int8")
    ram_rate = _gemv_ram_rate(variant, achieved, recode=recode)
    return BenchResult("gemv", variant, macs / base_rate,
                       macs / (base_rate + ram_rate))


def gemv_grid(variant: str, g: int = 8, h: int = 512, t: int = 50,
              achieved: bool = False) -> BenchResult:
    """Fleet-level sweep: G independent GEMV instances across the BRAMs.

    Models the `ComefaGrid` scenario at the hardware level.  The fleet's
    RAMs are split into `g` slices, one problem instance each:

      * *grid* (the augmented side): every slice has its own shared
        instruction FSM broadcast (Sec. III-D), so all slices compute
        concurrently and the fleet sustains its full aggregate rate;
      * *loop* (the baseline side): ONE instruction FSM is time-
        multiplexed across the slices - only the active instance's
        slice computes at any time, so the RAM side delivers 1/g of its
        rate while the DSP/LB base is unaffected.

    The speedup is the fleet-utilisation gain of broadcasting shared
    FSMs instead of looping one FSM over the slices; it approaches g as
    the RAM side dominates.  (The *simulator's* grid-vs-loop wall-clock
    win - one fused grid scan dispatch vs a Python loop of `ComefaArray.run`
    calls - is measured separately in `benchmarks/sim_speed.py`.)
    """
    assert g >= 1
    macs = g * 4 * h * (2 * h) * t
    base_rate = dsp_mac_throughput("int8") + lb_mac_throughput("int8")
    ram_rate = _gemv_ram_rate(variant, achieved)
    t_loop = macs / (base_rate + ram_rate / g)
    t_grid = macs / (base_rate + ram_rate)
    return BenchResult(f"gemv_grid{g}", variant, t_loop, t_grid)


# ---------------------------------------------------------------------------
# compute-bound: FIR filter (int16, 128 taps, streaming, LCU pipeline)
# ---------------------------------------------------------------------------

def fir(variant: str, taps: int = 128, n_samples: int = 1 << 20,
        achieved: bool = False) -> BenchResult:
    """Systolic DSP chain baseline vs DSP + CoMeFa with RAM chaining.

    The overall design frequency was ~215 MHz in both CoMeFa variants
    (Sec. V-B) - the bound is the streaming input distribution network, so
    -D and -A achieve the same speedup.  CCB cannot run this benchmark
    (no RAM-to-RAM chaining) -> speedup 1.0.

    With `achieved=True` the CoMeFa side is priced from the real
    scheduled multi-block program (`program.fir` through the IR pass
    pipeline): taps resident one per lane across ``ceil(taps / 160)``
    chained blocks, each streamed sample completing one MAC in *every*
    tap lane for the steady-state per-sample cycle count
    (`timing.achieved_fir_cycles_per_sample`).  The closed-form default
    keeps the paper's generic-MAC estimate (validated against Fig 9).
    """
    macs = taps * n_samples
    base_rate = dsp_mac_throughput("int16") + lb_mac_throughput("int16")
    v = R.VARIANTS[variant]
    if not v.supports_chaining:
        return BenchResult("fir", variant, macs / base_rate, macs / base_rate)
    # design-frequency-limited: the CoMeFa array adds lanes at f_design,
    # bounded by the LCU pipeline's streaming rate
    f_design = 215e6
    if achieved:
        # int16 taps/samples, 36-bit accumulator (the INT16 precision of
        # Table II); each chained group of n_blocks RAMs retires `taps`
        # MACs per streamed sample
        n_blocks = -(-taps // v.lanes)
        per_sample = timing.achieved_fir_cycles_per_sample(16, 16, 36)
        ram_rate = (R.BRAMS / n_blocks) * taps * f_design / per_sample
    else:
        # OOOR streamed samples: digit statistics, not a hard-coded halving
        cyc = timing.mac_cycles(16, 36) / timing.zero_skip_speedup(16, "naive")
        ram_rate = R.BRAMS * v.lanes * f_design / cyc
    # LCU pipeline: load/compute/unload overlap leaves the compute fraction
    lcu_overlap = 0.70
    ram_rate *= lcu_overlap
    return BenchResult("fir", variant, macs / base_rate,
                       macs / (base_rate + ram_rate))


# ---------------------------------------------------------------------------
# DRAM-bandwidth-bound: elementwise multiply (HFP8, 100K elements)
# ---------------------------------------------------------------------------

def eltwise(variant: str, n: int = 100_000,
            dram_limited: bool = True, achieved: bool = False) -> BenchResult:
    """Streaming a*b from DRAM at HFP8: 3 transfers of 8 bits per element.

    DRAM-bound: both designs saturate the same DRAM pipe -> speedup 1.
    With the DRAM restriction removed (Fig 9 "*"), compute rates decide.
    CCB has no floating-point support -> 0 (as plotted in the paper).
    """
    v = R.VARIANTS[variant]
    bits = 3 * 8 * n
    t_dram = bits / R.DRAM_BW_BITS_PER_S
    base_rate = dsp_mac_throughput("hfp8") + lb_mac_throughput("hfp8")
    if not v.supports_float:
        return BenchResult("eltwise", variant, t_dram, float("inf"))
    if dram_limited:
        return BenchResult("eltwise", variant, t_dram, t_dram)
    mul_cyc = (timing.achieved_fp_mul_cycles(4, 3) if achieved
               else timing.fp_mul_cycles(4, 3))
    ram_rate = R.BRAMS * v.lanes * v.freq / mul_cyc
    ram_rate *= _eff("eltwise_nolimit", variant)
    return BenchResult("eltwise_nolimit", variant, n / base_rate,
                       n / (base_rate + ram_rate))


# ---------------------------------------------------------------------------
# on-chip-BW-bound: database search (16-bit records in 256 RAMs)
# ---------------------------------------------------------------------------

def search(variant: str, n_blocks: int = 256, elems_per_col: int = 7,
           bits: int = 16, achieved: bool = False) -> BenchResult:
    """Search+replace a key across records resident in RAM (Sec. IV-C).

    Baseline: stream records through soft-logic comparators at 40b/port -
    with both ports reading and the replace write sharing a port, one
    record (16b) per port-cycle pair, at the (very high) baseline design
    frequency.  CoMeFa: `search_cycles` per record-row-group over 160
    lanes.  CCB's restricted PE doubles the cycle count (Sec. V-B).
    """
    v = R.VARIANTS[variant]
    n_records = n_blocks * 160 * elems_per_col
    # baseline: 2 reads (key compare) + occasional write; effective
    # 2 records/cycle/block through the two 40b ports at the (very high)
    # baseline design frequency
    f_base = 735e6
    t_base = (n_records / (2.0 * n_blocks)) / f_base
    cyc = (timing.achieved_search_cycles(bits) if achieved
           else timing.search_cycles(bits)) * v.logic_cycle_factor
    if not v.supports_ooor:
        cyc += bits        # key must be replicated/streamed without OOOR
    # +1 record group: FSM pipeline fill / mask setup
    t_aug = (elems_per_col + 1) * cyc / v.freq
    # the mapper keeps the soft-logic design when CoMeFa would be slower
    # (paper: no speedup for CoMeFa-A or CCB on this benchmark)
    return BenchResult("search", variant, t_base, min(t_aug, t_base))


# ---------------------------------------------------------------------------
# on-chip-BW-bound: RAID reconstruction (20-bit, XOR of stripes)
# ---------------------------------------------------------------------------

def raid(variant: str, n_blocks: int = 256, n_drives: int = 4,
         rows: int = 96, achieved: bool = False) -> BenchResult:
    """Untransposed bulk-XOR rebuild (Sec. IV-C).

    Baseline: per block-pair, read a || read b (dual port), write the XOR
    next cycle -> 40 result bits per 2 cycles per RAM.  CoMeFa: one full
    160-bit row per cycle (`raid_cycles`).
    """
    # `achieved` accepted for API symmetry: the XOR fold is one W1 write
    # per row with no idle Port-B partner, so the schedule is already tight.
    v = R.VARIANTS[variant]
    total_bits = n_blocks * rows * 160
    base_bits_per_s = n_blocks * (40 / 2.0) * 702e6   # achieved base fmax
    t_base = total_bits / base_bits_per_s
    lanes = v.lanes
    aug_bits_per_s = n_blocks * lanes * v.freq * _eff("raid", variant)
    t_aug = total_bits / aug_bits_per_s
    return BenchResult("raid", variant, t_base, t_aug)


# ---------------------------------------------------------------------------
# on-chip-BW-bound: reduction (precision swept 4..20 bits, Fig 12)
# ---------------------------------------------------------------------------

def reduction(variant: str, bits: int = 4, n_blocks: int = 256,
              elems_per_col: int = 4, achieved: bool = False) -> BenchResult:
    """Accumulate RAM-resident elements (Sec. IV-C, Figs. 9 & 12).

    Baseline: one element per cycle enters each block's pipelined LB adder
    tree through Port A (Port B streams partials) - cycle count is
    *precision-independent* ("baseline takes the same number of cycles for
    each precision"), frequency degrades mildly with precision.

    CoMeFa: column-serial adds + 2-step lane-tree reduction to 40 partials
    (`reduce_tree` - the simulator validates these cycle counts) runs at
    the *compute* frequency; unloading the 32-bit partials and the FSM
    fill/drain run in memory mode at the full BRAM frequency (memory-mode
    delay overhead is negligible, Sec. IV-D).

    CCB note: its Neural-Cache-style PE computes adds at one cycle/bit too
    (the 2x penalty applies only to ops needing the flexible truth-table,
    e.g. search) - consistent with CCB's reduction being ~equal to
    CoMeFa-D in Fig 12.
    """
    v = R.VARIANTS[variant]
    n_elems_per_block = 160 * elems_per_col
    f_base = 545e6 - 1.3e6 * (bits - 4)           # mild precision slope
    t_base = n_elems_per_block / f_base
    # in-RAM: (k-1) column-serial adds of growing width + 2-step lane tree
    col_add = sum(timing.add_cycles(bits + j) for j in range(elems_per_col - 1))
    tree = (timing.achieved_reduction_cycles(bits + elems_per_col - 1, steps=2)
            if achieved
            else timing.reduction_cycles(bits + elems_per_col - 1, steps=2))
    compute_cyc = col_add + tree                  # 1 cycle/bit on all three
    acc_bits = 32                                 # paper: 32-bit accumulator
    unload = timing.load_store_cycles(40, acc_bits)
    fsm_fill = 60                                 # instruction stream fill/drain
    t_aug = compute_cyc / v.freq + (unload + fsm_fill) / R.F_BRAM
    return BenchResult("reduction", variant, t_base, t_aug)


# ---------------------------------------------------------------------------
# serving roofline: decode tokens/sec per mm^2 (the serving-gap pricing)
# ---------------------------------------------------------------------------

def serve_roofline(w_bits: int = 8, x_bits: int = 8, d_model: int = 4096,
                   d_ff: int = 0, n_layers: int = 32,
                   recode: str = "naive") -> Dict[str, Dict[str, float]]:
    """Decode-step tokens/sec-per-mm^2: CoMeFa variants vs DSP baseline.

    Prices exactly the work `serve.comefa_exec.GridLinearExecutor` routes
    to the grid: per decode token, every layer's seven projections
    (attention wq/wk/wv/wo square in d_model, ffn wi/wg/wo against d_ff,
    default 4*d_model) as w_bits x x_bits GEMVs.  The CoMeFa side is
    priced from the *real* `comefa.schedule.GemvPlan` steady state
    (``_gemv_scheduled_macs_per_lane_cycle`` - the same schedules the
    bit-level simulator executes) with the accumulator width the serving
    executor actually allocates (`serve.comefa_exec.acc_bits_for`);
    CoMeFa-A, lacking OOOR streaming, pays the closed-form bit-serial MAC
    cycles instead.  Silicon cost uses Table IV: the augmented chip is
    ``chip_area_um2() * (1 + CHIP_OVERHEAD_FRAC[variant])``, the baseline
    the unmodified chip, so the per-mm^2 ratio answers whether the added
    compute pays for its area on the decode workload.

    Returns ``{design: {tok_s, area_mm2, tok_s_per_mm2, gain}}`` where
    ``gain`` is tok_s_per_mm2 relative to the DSP baseline.
    """
    from ..comefa.isa import ceil_log2
    from . import area

    d_ff = d_ff or 4 * d_model
    # 4 attention + 3 gated-ffn projections per layer, one token
    macs_per_token = n_layers * (4 * d_model * d_model + 3 * d_model * d_ff)
    acc_bits = w_bits + x_bits + ceil_log2(max(2, d_model))
    base_rate = dsp_mac_throughput("int8") + lb_mac_throughput("int8")
    base_area_mm2 = area.chip_area_um2() / 1e6

    out: Dict[str, Dict[str, float]] = {}
    base_tok_s = base_rate / macs_per_token
    base_density = base_tok_s / base_area_mm2
    out["dsp-baseline"] = {"tok_s": base_tok_s, "area_mm2": base_area_mm2,
                           "tok_s_per_mm2": base_density, "gain": 1.0}
    for variant in ("comefa-d", "comefa-a"):
        v = R.VARIANTS[variant]
        if v.supports_ooor:
            per_lane = _gemv_scheduled_macs_per_lane_cycle(
                w_bits, x_bits, acc_bits, recode=recode)
            ram_rate = (R.BRAMS * v.lanes * per_lane * v.freq
                        / v.logic_cycle_factor)
        else:
            cyc = timing.mac_cycles(w_bits, acc_bits)
            ram_rate = (R.BRAMS * v.lanes * v.freq
                        / (cyc * v.logic_cycle_factor))
        ram_rate *= _eff("gemv", variant)
        tok_s = (base_rate + ram_rate) / macs_per_token
        area_mm2 = base_area_mm2 * (1.0 + area.CHIP_OVERHEAD_FRAC[variant])
        density = tok_s / area_mm2
        out[variant] = {"tok_s": tok_s, "area_mm2": area_mm2,
                        "tok_s_per_mm2": density,
                        "gain": density / base_density}
    return out


# ---------------------------------------------------------------------------
# Fig 11: co-mapping sweep - fraction of work on CoMeFa RAMs
# ---------------------------------------------------------------------------

def comapping_sweep(variant: str, bench: str = "gemv", points: int = 21):
    """Speedup (cycle-based) vs fraction of work mapped to CoMeFa RAMs.

    Work alpha on RAMs runs concurrently with (1-alpha) on DSPs/LBs; the
    RAM path pays a load/unload overhead proportional to its share.  The
    sweet spot moves with the rate ratio (Sec. V-C).
    """
    base_rate = dsp_mac_throughput("int8") + lb_mac_throughput("int8")
    v = R.VARIANTS[variant]
    cyc = timing.mac_cycles(8, 27) / (timing.zero_skip_speedup(8, "naive")
                                      if v.supports_ooor else 1.0)
    ram_rate = (R.BRAMS * v.lanes * v.freq / cyc) * _eff("gemv", variant)
    overhead = 0.35 / ram_rate                    # load/unload per unit work
    out = []
    for i in range(points):
        alpha = i / (points - 1)
        t = max((1 - alpha) / base_rate, alpha / ram_rate + alpha * overhead)
        t0 = 1.0 / base_rate
        out.append((alpha, t0 / t))
    return out


BENCHES = {"gemv": gemv, "fir": fir, "eltwise": eltwise, "search": search,
           "raid": raid, "reduction": reduction}


def run_all(variants=("comefa-d", "comefa-a", "ccb"),
            achieved: bool = False) -> Dict[str, Dict[str, float]]:
    """All benchmark speedups.  `achieved=True` prices the CoMeFa side
    with the IR-optimized (co-issued) schedules; the default reproduces
    the paper's closed-form cycle counts (validated against Fig 9)."""
    out: Dict[str, Dict[str, float]] = {}
    kw = {"achieved": achieved}
    for name, fn in BENCHES.items():
        out[name] = {}
        for var in variants:
            out[name][var] = fn(var, **kw).speedup
    out["eltwise_nolimit"] = {
        var: eltwise(var, dram_limited=False, achieved=achieved).speedup
        for var in variants}
    # fleet-level grid sweep: shared-FSM slices vs one looped FSM (the
    # ComefaGrid scenario priced at the hardware level)
    out["gemv_grid8"] = {
        var: gemv_grid(var, g=8, achieved=achieved).speedup
        for var in variants}
    return out
