"""Closed-form cycle counts for CoMeFa operations (paper Secs. III-E/G/I).

These formulas drive the analytical FPGA performance model
(`fpga_model/perf.py`).  The functional simulator's generated programs are
asserted against them in tests - exact equality for the fixed-point ops
(the paper's n+1 / n^2+3n-2 are exact) and small-tolerance agreement for
floating point (the paper calls those counts approximate).

Alongside the paper's formulas, `achieved_cycles()` reports the
*post-optimization* counts: the length of the generated program after the
IR pass pipeline (constant folding, dead-write elimination, dual-port
co-issue - see `ir.py`).  Achieved counts are never above the closed-form
counts; `fpga_model/perf.py` can price benchmarks with either.
"""
from __future__ import annotations

import dataclasses
import functools


def add_cycles(n: int) -> int:
    """n-bit add: n sum cycles + 1 final carry store (Sec. III-E)."""
    return n + 1


def sub_cycles(n: int) -> int:
    """a - b = a + ~b + 1: invert (n) + carry preset (1) + add (n+1)."""
    return 2 * n + 2


def mul_cycles(n: int) -> int:
    """n-bit multiply, 2n-bit product (Sec. III-E): n^2 + 3n - 2."""
    return n * n + 3 * n - 2


def mac_cycles(n: int, acc_bits: int) -> int:
    """Multiply-accumulate: n-bit mul + accumulate into acc_bits (Fig 8)."""
    return mul_cycles(n) + add_cycles(acc_bits)


def fp_mul_cycles(e: int, m: int) -> int:
    """FP multiply ~= M^2 + 7M + 3E + 5 (Sec. III-G)."""
    return m * m + 7 * m + 3 * e + 5


def fp_add_cycles(e: int, m: int) -> int:
    """FP add ~= 2ME + 9M + 7E + 12 (Sec. III-G)."""
    return 2 * m * e + 9 * m + 7 * e + 12


def fp_mac_cycles(e: int, m: int) -> int:
    return fp_mul_cycles(e, m) + fp_add_cycles(e, m)


# ---------------------------------------------------------------------------
# streamed-operand digit statistics (Sec. III-I OOOR + Booth/NAF recoding)
#
# The IR's `specialize_streams` pass expands a streamed MAC into one
# accumulator-segment add per *nonzero digit* of the recoded operand, so
# cycle counts are digit statistics.  These helpers are the single source
# of truth the perf model prices OOOR from - no more hard-coded "/ 2".
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def expected_nonzero_digits(n_bits: int, recode: str = "naive") -> float:
    """Expected nonzero digits of a uniform n-bit operand, per recoding.

    Exact (enumerated over all 2^n values, not asymptotic):
      * ``"naive"``: mean popcount = n/2;
      * ``"naf"``:   mean NAF weight -> ~n/3 + O(1) (the canonical form's
        minimal-density advantage - the paper's "Booth" win);
      * ``"booth"``: classic radix-2 run-boundary count -> ~(n+1)/2 on
        average (its win is run-heavy streams, not uniform ones).

    NAF weight is computed with the identity weight(x) = popcount(x ^ 3x),
    Booth boundaries with popcount(x ^ (x << 1)); both are asserted
    against `ir.recode_digits` in tests.  Past 20 bits (beyond every
    precision in Table II) the per-bit densities have converged and the
    asymptotic forms are used.
    """
    import numpy as np
    assert n_bits >= 1
    if recode == "naive":
        return n_bits / 2.0
    if recode not in ("naf", "booth"):
        raise ValueError(f"unknown recode mode {recode!r}")
    if n_bits > 20:
        # asymptotic NAF density n/3 + 4/9; Booth boundary count is
        # exactly (n+1)/2 at every width (n+1 positions, each p=1/2)
        return (n_bits / 3.0 + 4.0 / 9.0 if recode == "naf"
                else (n_bits + 1) / 2.0)
    x = np.arange(1 << n_bits, dtype=np.int64)
    h = x ^ (3 * x) if recode == "naf" else x ^ (x << 1)
    ones = float(np.unpackbits(h.astype(">u8").view(np.uint8)).sum())
    return ones / (1 << n_bits)


@functools.lru_cache(maxsize=None)
def _signed_digit_stats(n_bits: int, recode: str) -> tuple:
    """(P(any negative digit), E[negative digits]) for uniform n-bit x.

    The expected per-element overhead of a signed recoding: one w_bits
    complement whenever any digit is negative, plus one preset-carry
    cycle per negative digit.  Exact via a vectorized digit recursion
    over all 2^n values (n capped at 20 - beyond every Table II
    precision - with the per-bit slope extrapolated past the cap).
    """
    import numpy as np
    if recode == "naive":
        return 0.0, 0.0
    if n_bits > 20:
        p20, e20 = _signed_digit_stats(20, recode)
        _, e19 = _signed_digit_stats(19, recode)
        return p20, e20 + (n_bits - 20) * (e20 - e19)
    x = np.arange(1 << n_bits, dtype=np.int64)
    neg = np.zeros_like(x)
    if recode == "booth":
        # d_i = x_{i-1} - x_i: negative exactly at 0 -> 1 rising edges
        edges = x & ~(x << 1)
        for i in range(n_bits):
            neg += (edges >> i) & 1
    else:                                   # naf
        cur = x.copy()
        while cur.any():
            d = np.where(cur & 1, 2 - (cur & 3), 0)
            neg += d < 0
            cur = (cur - d) >> 1
    return (float((neg > 0).mean()), float(neg.mean()))


def signed_recode_overhead(w_bits: int, n_bits: int,
                           recode: str = "naive") -> float:
    """Expected extra cycles per streamed element a signed recoding pays:
    the weight complement (w_bits, iff any digit is negative) plus one
    carry preset per negative digit.  0.0 for naive."""
    p_neg, e_neg = _signed_digit_stats(n_bits, recode)
    return p_neg * w_bits + e_neg


def zero_skip_speedup(n_bits: int, recode: str = "naive") -> float:
    """Cycle-count factor OOOR digit streaming saves vs streaming all bits.

    ``n_bits / expected_nonzero_digits``: exactly 2.0 for naive zero-bit
    skipping on a uniform operand (the paper's reported ~2x, Sec. III-I),
    ~3x for NAF recoding.  `fpga_model/perf.py` divides generic-MAC
    cycle counts by this instead of a hard-coded 2.
    """
    return n_bits / expected_nonzero_digits(n_bits, recode)


def digit_patterns(values, n_bits: int, recode: str = "naive"):
    """Per-value nonzero/negative digit bitmasks of a recoded stream.

    Returns ``(nonzero, negative)`` int64 arrays: bit ``i`` of
    ``nonzero[j]`` is set iff digit ``i`` of ``values[j]``'s recoding is
    nonzero, ``negative`` likewise for digits below zero.  Closed forms -
    naive is the value itself; Booth radix-2 boundaries are
    ``x ^ (x << 1)`` with negatives at the 0->1 rising edges
    ``x & ~(x << 1)``; NAF uses the canonical ``3x`` construction
    (``(x ^ 3x) >> 1`` nonzero, ``(x & ~3x) >> 1`` negative).  Asserted
    digit-for-digit against `ir.recode_digits` in tests; this is what
    lets `recode.chunk_stream_cycles` price a whole activation chunk
    without expanding a single program.
    """
    import numpy as np
    x = np.asarray(values, dtype=np.int64).ravel()
    assert n_bits >= 1
    assert ((x >= 0) & (x < (1 << n_bits))).all(), \
        f"values outside [0, 2^{n_bits})"
    if recode == "naive":
        return x, np.zeros_like(x)
    if recode == "booth":
        return x ^ (x << 1), x & ~(x << 1)
    if recode == "naf":
        h = 3 * x
        return (x ^ h) >> 1, (x & ~h) >> 1
    raise ValueError(f"unknown recode mode {recode!r}")


def nonzero_digit_counts(values, n_bits: int, recode: str = "naive"):
    """Vectorized exact nonzero-digit counts of a recoded value chunk.

    The per-value companion of `expected_nonzero_digits`: the length of
    each value's OOOR digit stream (= streamed adds it costs), exact
    rather than in expectation.  Signed recodings (Booth/NAF) may emit a
    digit at offset ``n_bits``; the count includes it.
    """
    import numpy as np
    nz, _ = digit_patterns(values, n_bits, recode)
    counts = np.zeros_like(nz)
    for i in range(n_bits + 1):
        counts += (nz >> i) & 1
    return counts


def nonzero_digit_count(value: int, n_bits: int,
                        recode: str = "naive") -> int:
    """Exact nonzero digits of ONE recoded value (its OOOR stream length)."""
    return int(nonzero_digit_counts([value], n_bits, recode)[0])


def streamed_mac_cycles(w_bits: int, acc_bits: int, x: int, x_bits: int,
                        recode: str = "naive") -> int:
    """Exact cycles of one specialized streamed MAC (``acc += w * x``).

    Mirrors `ir.specialize_streams`'s `StreamMac` expansion: a digit at
    offset b costs ``acc_bits - b`` add/ripple cycles (+1 carry preset
    for a negative digit), one w_bits-cycle complement is paid iff any
    digit is negative, and signed modes stop at the first digit whose
    weight segment no longer fits the accumulator.  Asserted cycle-exact
    against the generated programs in tests/test_streams.py.
    """
    from .ir import recode_digits
    digits = recode_digits(int(x), x_bits, recode)
    total = w_bits if any(d < 0 for d in digits) else 0
    for off, d in enumerate(digits):
        if d == 0:
            continue
        if recode != "naive" and off + w_bits > acc_bits:
            break
        total += acc_bits - off + (1 if d < 0 else 0)
    return total


def ooor_dot_cycles(k: int, w_bits: int, x_bits: int,
                    acc_bits: int, zero_skip: bool = True,
                    recode: str = "naive", x_values=None) -> int:
    """Dot product of length k with weights resident, x streamed (Sec. III-I).

    Each contributing digit costs one accumulator-segment add.  Given the
    concrete ``x_values`` the count is *exact* - it equals the generated
    (unoptimized) `program.ooor_dot` / `ooor_dot_booth` /
    `specialize_streams` schedule cycle-for-cycle, for every recoding.
    Without values, the expected-density estimate: with OOOR zero-bit
    skipping the average x has ``expected_nonzero_digits(x_bits, recode)``
    contributing digits (x_bits/2 naive - the paper's reported 2x -
    ~x_bits/3 NAF) vs all x_bits for the naive all-bits schedule.
    """
    if x_values is not None:
        assert len(x_values) == k, (len(x_values), k)
        return acc_bits + sum(
            streamed_mac_cycles(w_bits, acc_bits, int(v), x_bits,
                                recode=recode)
            for v in x_values)
    bits_per_elem = (expected_nonzero_digits(x_bits, recode) if zero_skip
                     else x_bits)
    per_add = add_cycles(w_bits) + max(0, acc_bits - (w_bits + 1))  # ripple
    overhead = k * signed_recode_overhead(w_bits, x_bits, recode)
    return int(round(k * bits_per_elem * per_add + overhead)) \
        + acc_bits                                          # + acc zeroing


def load_store_cycles(n_elems: int, n_bits: int, port_width: int = 40) -> int:
    """Port traffic to (un)load n_elems of n_bits through the 40b port.

    Hybrid mode fixes the geometry at 512x40; one bit-slice word moves 40
    element-bits per cycle (the swizzle FIFO sustains one word/cycle).
    """
    import math
    return math.ceil(n_elems / port_width) * n_bits


def reduction_cycles(n_bits: int, lanes: int = 160, steps: int = 2,
                     acc_bits: int = 32) -> int:
    """In-RAM tree reduction to `lanes/2**steps` partial sums (Sec. IV-C).

    Step s (distance 2^s) costs 2^s * w_s shift cycles + (w_s + 1) add
    cycles where w_s = n_bits + s is the growing accumulator width.
    Matches `program.reduce_tree`.
    """
    total = 0
    w = n_bits
    for s in range(steps):
        total += (1 << s) * w + (w + 1)
        w += 1
    return total


def chained_reduction_cycles(n_bits: int, lanes: int = 160,
                             n_blocks: int = 1) -> int:
    """Full reduction of ALL lanes of a chained array to one scalar.

    ceil(log2(lanes * n_blocks)) doubling steps: the in-block steps plus
    the chain steps whose shift distances hop partial sums across block
    boundaries through the corner PEs (Sec. III-F).  Step s costs
    2^s * w_s shift cycles + (w_s + 1) add cycles with w_s = n_bits + s.
    Matches `program.reduce_to_scalar` exactly (n_blocks=1 included - the
    degenerate chain).
    """
    from .isa import ceil_log2
    # same per-step cost model as the partial-sum tree, run to scalar depth
    return reduction_cycles(n_bits, lanes=lanes,
                            steps=ceil_log2(lanes * n_blocks))


def fir_cycles(n_samples: int, x_bits: int, acc_bits: int,
               x_values=None, include_init: bool = True,
               recode: str = "naive", tap_bits: int = 0) -> int:
    """Transposed-form FIR over chained blocks (Sec. IV-C).

    Per sample: one accumulator-segment add per *nonzero digit* b of the
    recoded sample (OOOR zero-bit skipping; an add at offset b ripples
    acc_bits - b cycles) plus an acc_bits-cycle chained left shift of the
    partial sums.  Exact (matches `program.fir` for the same recoding)
    when the sample stream `x_values` is given; otherwise the paper's
    average-density estimate (``expected_nonzero_digits`` digits at mean
    offset (x_bits-1)/2).  Signed recodings need `tap_bits` for the tap
    complement a negative digit pays.  `include_init` adds the one-off
    accumulator zeroing.
    """
    if recode != "naive" and tap_bits <= 0:
        raise ValueError("signed recodings price a tap complement: "
                         "pass tap_bits")
    if x_values is not None:
        assert n_samples == len(x_values), (
            f"n_samples={n_samples} inconsistent with "
            f"{len(x_values)} x_values")
        adds = sum(streamed_mac_cycles(tap_bits, acc_bits, int(x_t),
                                       x_bits, recode=recode)
                   for x_t in x_values)
    else:
        adds = int(round(n_samples * (
            expected_nonzero_digits(x_bits, recode)
            * (acc_bits - (x_bits - 1) / 2)
            + signed_recode_overhead(tap_bits, x_bits, recode))))
    total = adds + n_samples * acc_bits
    return total + (acc_bits if include_init else 0)


def gemm_cycles(m: int, k: int, n: int, bits: int, n_blocks: int = 1,
                lcu: bool = True) -> int:
    """Cycles for the tiled ``m x k @ k x n`` GEMM schedule (Sec. IV-A).

    Re-derives `schedule.GemmPlan`'s timeline from closed forms - tile
    geometry, per-phase costs, and the double-buffered three-stage
    pipeline recurrence - without building any program, and the tests
    assert cycle-exact agreement with the generated schedule.  With
    ``lcu=False`` the phases run back-to-back (the serial schedule);
    with ``lcu=True`` steady-state tiles cost ``max(load, compute,
    unload)`` - the load-compute-unload overlap that hides data movement
    behind compute.
    """
    from .isa import COL_MUX, N_COLS, ceil_log2
    steps = ceil_log2(k)
    group = 1 << steps
    span = n_blocks * N_COLS
    if group > span:
        raise ValueError(f"k={k} needs {group} lanes, have {span}")
    acc_bits = 2 * bits + steps
    dots = span // group
    n_out = m * n
    n_tiles = -(-n_out // dots)
    load = 2 * load_store_cycles(N_COLS, bits)
    compute = (mul_cycles(bits) + steps
               + reduction_cycles(2 * bits, steps=steps))

    def unload(n_dots: int) -> int:
        phases: dict = {}
        for p in range(n_dots):
            lane = p * group
            phases.setdefault(lane // N_COLS, set()).add(lane % COL_MUX)
        return acc_bits * max(len(s) for s in phases.values())

    costs = [(load, compute,
              unload(dots if t < n_tiles - 1
                     else n_out - (n_tiles - 1) * dots))
             for t in range(n_tiles)]
    if not lcu:
        return sum(sum(c) for c in costs)
    # double-buffered three-stage pipeline (same recurrence the Schedule
    # timeline implements, re-stated here independently)
    lag = 2
    end_l: list = []
    end_c: list = []
    end_u: list = []
    for t, (lo, co, un) in enumerate(costs):
        end_l.append(max(end_l[t - 1] if t >= 1 else 0,
                         end_c[t - lag] if t >= lag else 0) + lo)
        end_c.append(max(end_l[t], end_c[t - 1] if t >= 1 else 0,
                         end_u[t - lag] if t >= lag else 0) + co)
        end_u.append(max(end_c[t], end_u[t - 1] if t >= 1 else 0) + un)
    return end_u[-1]


@functools.lru_cache(maxsize=None)
def achieved_gemm_cycles(m: int, k: int, n: int, bits: int,
                         n_blocks: int = 1, lcu: bool = True) -> int:
    """Pipelined GEMM cycles with the IR-optimized tile program.

    Builds the real `schedule.GemmPlan` schedule (post-pass compute
    lengths) instead of the closed-form compute cost; never above
    `gemm_cycles` for the same shape.
    """
    from .schedule import plan_gemm
    sched = plan_gemm(m, k, n, bits, n_blocks=n_blocks).schedule(
        optimized=True)
    return sched.total_cycles if lcu else sched.serial_cycles


def search_cycles(n_bits: int) -> int:
    """DB search+replace: xor (n) + OR-reduce (n-1) + mask (1) + clear (n)."""
    return 3 * n_bits


def raid_cycles(n_words: int, n_drives: int) -> int:
    """RAID rebuild, untransposed layout: copy parity + XOR per drive."""
    return n_words * n_drives


@dataclasses.dataclass(frozen=True)
class Precision:
    """A numeric format for the throughput/benchmark sweeps (Fig 8)."""
    name: str
    int_bits: int = 0          # fixed-point operand width (0 = float)
    acc_bits: int = 0          # fixed-point accumulator width
    e_bits: int = 0            # float exponent bits
    m_bits: int = 0            # float mantissa bits
    acc_e: int = 0
    acc_m: int = 0

    @property
    def is_float(self) -> bool:
        return self.int_bits == 0

    def mac(self) -> int:
        if self.is_float:
            # multiply in (e,m); accumulate in the wider accumulator format
            return fp_mul_cycles(self.e_bits, self.m_bits) + \
                fp_add_cycles(self.acc_e, self.acc_m)
        return mac_cycles(self.int_bits, self.acc_bits)


# ---------------------------------------------------------------------------
# achieved (post-optimization) cycle counts
#
# Each entry builds the real generated program through `program.py`, runs
# the IR pass pipeline, and reports its scheduled length.  Imports are
# deferred so `timing` stays importable from `program` without a cycle.
# ---------------------------------------------------------------------------

def _alloc():
    from .ir import RowAllocator
    return RowAllocator()


@functools.lru_cache(maxsize=None)
def achieved_cycles(op: str, *args: int) -> int:
    """Post-optimization cycle count of the generated program for `op`.

    Supported ops (args):
      add(n) | sub(n) | mul(n) | mac(n, acc_bits) | zero(n) | search(n)
      reduction(n_bits, steps) | fp_mul(e, m) | fp_add(e, m)
      ooor_dot(k, w_bits, x_bits, acc_bits[, recode])
                                              [average-density operand]
      chained_reduction(n_bits, n_blocks)     [all-lane scalar reduction]
      fir(n_samples, tap_bits, x_bits, acc_bits) [average-density samples]
    """
    from . import program
    a = _alloc()
    if op == "add":
        (n,) = args
        p = program.add(a.alloc(n), a.alloc(n), a.alloc(n + 1))
    elif op == "sub":
        (n,) = args
        p = program.sub(a.alloc(n), a.alloc(n), a.alloc(n + 1), a.alloc(n))
    elif op == "mul":
        (n,) = args
        p = program.mul(a.alloc(n), a.alloc(n), a.alloc(2 * n))
    elif op == "mac":
        n, acc_bits = args
        x, y, acc = a.alloc(n), a.alloc(n), a.alloc(acc_bits)
        prod = a.alloc(2 * n)
        p = program.mul(x, y, prod) + program.add_into(acc, prod, 0)
    elif op == "zero":
        (n,) = args
        p = program.zero_rows(a.alloc(n))
    elif op == "search":
        (n,) = args
        p = program.search_replace(a.alloc(n), 0b0101010101010101 &
                                   ((1 << n) - 1), n, a.alloc(n))
    elif op == "reduction":
        n_bits, steps = args
        val = a.alloc(n_bits + steps + 1)
        scratch = a.alloc(n_bits + steps)
        p = program.reduce_tree(val, scratch, n_bits, steps)
    elif op == "fp_mul":
        e, m = args
        sa, sb, so = a.alloc(1), a.alloc(1), a.alloc(1)
        p = program.fp_mul(0, a.alloc(e), a.alloc(m), 0, a.alloc(e),
                           a.alloc(m), sa[0], sb[0], so[0], a.alloc(e),
                           a.alloc(m), a.alloc(e + 3 + 2 * m + 2 * (m + 1)),
                           e, m)
    elif op == "fp_add":
        e, m = args
        scr = a.alloc(2 * (e + 1) + e + e + 2 * (m + 1) + e + (m + 3))
        p = program.fp_add_same_sign(a.alloc(e), a.alloc(m), a.alloc(e),
                                     a.alloc(m), a.alloc(e), a.alloc(m),
                                     scr, e, m)
    elif op == "chained_reduction":
        n_bits, n_blocks = args
        steps, chain_steps = program.full_reduce_steps(n_blocks)
        total = steps + chain_steps
        val = a.alloc(n_bits + total)
        scratch = a.alloc(n_bits + total - 1)
        p = program.reduce_to_scalar(val, scratch, n_bits,
                                     n_blocks=n_blocks)
    elif op == "fir":
        n_samples, tap_bits, x_bits, acc_bits = args
        # deterministic average-density sample stream: alternating bits
        # give exactly ceil(x_bits/2) set bits at any sample width
        pattern = sum(1 << b for b in range(0, x_bits, 2))
        x = [pattern] * n_samples
        taps = a.alloc(tap_bits)
        acc = a.alloc(acc_bits)
        p = program.fir(taps, acc, x, x_bits)
    elif op == "ooor_dot":
        k, w_bits, x_bits, acc_bits = args[:4]
        recode = args[4] if len(args) > 4 else "naive"
        # deterministic average-density operand: alternating bit pattern
        # has exactly ceil(x_bits/2) set bits (the paper's ~2x zero-skip
        # claim), at any operand width
        x = [sum(1 << b for b in range(0, x_bits, 2))] * k
        w = [a.alloc(w_bits) for _ in range(k)]
        acc = a.alloc(acc_bits)
        if recode == "naive":
            p = program.ooor_dot(w, x, x_bits, acc)
        else:
            from .ir import specialize_streams
            sym = program.ooor_dot_stream(w, x_bits, acc,
                                          neg_scratch=a.alloc(w_bits))
            p = specialize_streams(sym, x, recode=recode)
    else:
        raise ValueError(f"unknown op {op!r}")
    return p.optimize().cycles


def achieved_mac_cycles(n: int, acc_bits: int) -> int:
    return achieved_cycles("mac", n, acc_bits)


def achieved_fp_mul_cycles(e: int, m: int) -> int:
    return achieved_cycles("fp_mul", e, m)


def achieved_fp_add_cycles(e: int, m: int) -> int:
    return achieved_cycles("fp_add", e, m)


def achieved_search_cycles(n: int) -> int:
    return achieved_cycles("search", n)


def achieved_reduction_cycles(n_bits: int, steps: int = 2) -> int:
    return achieved_cycles("reduction", n_bits, steps)


def achieved_chained_reduction_cycles(n_bits: int, n_blocks: int = 1) -> int:
    return achieved_cycles("chained_reduction", n_bits, n_blocks)


def achieved_fir_cycles(n_samples: int, tap_bits: int, x_bits: int,
                        acc_bits: int) -> int:
    return achieved_cycles("fir", n_samples, tap_bits, x_bits, acc_bits)


def achieved_fir_cycles_per_sample(tap_bits: int, x_bits: int,
                                   acc_bits: int) -> int:
    """Steady-state per-sample cycles of the scheduled FIR program.

    Differencing two program lengths removes the one-off accumulator
    initialisation, leaving the accumulate + chained-shift cost one
    streamed sample adds to the optimized schedule.
    """
    return (achieved_fir_cycles(2, tap_bits, x_bits, acc_bits)
            - achieved_fir_cycles(1, tap_bits, x_bits, acc_bits))


# the paper's evaluated precisions (Sec. V-A)
INT4 = Precision("int4", int_bits=4, acc_bits=16)
INT8 = Precision("int8", int_bits=8, acc_bits=27)
INT16 = Precision("int16", int_bits=16, acc_bits=36)
HFP8 = Precision("hfp8", e_bits=4, m_bits=3, acc_e=6, acc_m=9)
FP16 = Precision("fp16", e_bits=5, m_bits=10, acc_e=8, acc_m=23)
PRECISIONS = (INT4, INT8, INT16, HFP8, FP16)
