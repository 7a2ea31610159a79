"""CoMeFa program generators (the "instruction generation FSM" of Sec. III-D).

Each function assembles the bit-serial instruction sequence for one
operation, mirroring the algorithms of Sec. III-E/G/I, and emits it as an
`ir.Program` - a first-class IR object the optimizing assembler passes
(`ir.py`) and the simulator's encode cache (`block.py`) operate on.
Unoptimized cycle counts are the program lengths; `timing.py` holds the
paper's closed-form formulas (which the tests assert agree) plus the
post-optimization "achieved" counts.

Operand convention: an n-bit operand is a list of n row indices, LSB first
(an `ir.Operand` from a `RowAllocator`, or any plain index sequence).
All lanes (columns) execute the same program - one program computes 160
results per block, `n_blocks * 160` results per array.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from . import ir
from .ir import (Operand, Program, RowAllocator, StreamExt, StreamMac,
                 StreamedOperand, specialize_streams)
from .isa import (Instr, N_COLS, PRED_ALWAYS, PRED_CARRY, PRED_MASK,
                  PRED_NOT_CARRY, ROW_ONES, TT_AND, TT_COPY_A, TT_NOT_A,
                  TT_OR, TT_XOR, TT_ZERO, W1_RIGHT, W1_S, W2_CARRY,
                  W2_LEFT, ceil_log2, latch_clear)

Rows = Sequence[int]


def _w1(**kw) -> Instr:
    return Instr(wp1_en=1, w1_sel=W1_S, **kw)


# ---------------------------------------------------------------------------
# register-level primitives
# ---------------------------------------------------------------------------

def zero_rows(rows: Rows) -> Program:
    """dst <- 0 (one cycle per row)."""
    return Program(_w1(dst_row=r, truth_table=TT_ZERO, c_rst=1)
                   for r in rows)


def copy_rows(src: Rows, dst: Rows, pred_sel: int = PRED_ALWAYS) -> Program:
    """dst <- src (optionally predicated), one cycle per row."""
    return Program(_w1(src1_row=s, dst_row=d, truth_table=TT_COPY_A,
                       c_rst=1, pred_sel=pred_sel)
                   for s, d in zip(src, dst))


def logic2(src1: Rows, src2: Rows, dst: Rows, tt: int,
           pred_sel: int = PRED_ALWAYS) -> Program:
    """Bulk bitwise op: dst <- f(src1, src2). One cycle per row (Sec. V-A)."""
    return Program(_w1(src1_row=a, src2_row=b, dst_row=d, truth_table=tt,
                       c_rst=1, pred_sel=pred_sel)
                   for a, b, d in zip(src1, src2, dst))


def logic_ext(src1: Rows, dst: Rows, tt: int, ext_bits: Sequence[int],
              pred_sel: int = PRED_ALWAYS) -> Program:
    """OOOR bitwise op against an outside operand broadcast bit-by-bit.

    The eager (pre-specialized) form; `logic_ext_stream` emits the same
    schedule symbolically against a `StreamedOperand`, for programs built
    before the outside value is known.
    """
    return Program(_w1(src1_row=a, dst_row=d, truth_table=tt, c_rst=1,
                       b_ext=1, ext_bit=e, pred_sel=pred_sel)
                   for a, d, e in zip(src1, dst, ext_bits))


def logic_ext_stream(src1: Rows, dst: Rows, tt: int,
                     stream: StreamedOperand,
                     pred_sel: int = PRED_ALWAYS) -> Program:
    """Symbolic `logic_ext`: dst <- f(src1, stream), value bound later.

    Bit i of the streamed operand feeds row i's broadcast; specialization
    with value v yields exactly ``logic_ext(src1, dst, tt, bits_of(v))``.
    """
    prog = Program(name=f"logic_ext[{stream.name}]")
    for i, (a, d) in enumerate(zip(src1, dst)):
        if i >= stream.n_bits:
            break                     # legacy zip-with-bits truncation
        prog.append_stream(StreamExt(
            _w1(src1_row=a, dst_row=d, truth_table=tt, c_rst=1, b_ext=1,
                pred_sel=pred_sel), stream, i))
    return prog


def clear_latches() -> Program:
    """Reset the carry and mask latches (one cycle, no row writes)."""
    return Program([latch_clear()])


def preset_carry() -> Program:
    """Force the carry latch to 1 (reads the constant ones row twice)."""
    return Program([Instr(src1_row=ROW_ONES, src2_row=ROW_ONES,
                          truth_table=TT_AND, c_en=1, c_rst=1)])


def store_carry(dst_row: int, pred_sel: int = PRED_ALWAYS) -> Program:
    """Write the latched carry to a row via Port B's write path (mux W2)."""
    return Program([Instr(dst_row=dst_row, wp2_en=1, w2_sel=W2_CARRY,
                          pred_sel=pred_sel)])


# ---------------------------------------------------------------------------
# fixed-point arithmetic (Sec. III-E)
# ---------------------------------------------------------------------------

def add(a: Rows, b: Rows, dst: Rows, pred_sel: int = PRED_ALWAYS,
        store_cout: bool = True, preset: bool = False) -> Program:
    """dst <- a + b.  n+1 cycles for n-bit operands (paper Sec. III-E).

    dst must have n+1 rows when store_cout (the extra final-carry row).
    `preset` starts the carry chain at 1 (used by `sub`).
    """
    n = len(a)
    prog = Program()
    for i in range(n):
        prog.append(_w1(src1_row=a[i], src2_row=b[i], dst_row=dst[i],
                        truth_table=TT_XOR, c_en=1,
                        c_rst=1 if (i == 0 and not preset) else 0,
                        pred_sel=pred_sel))
    if store_cout:
        prog += store_carry(dst[n], pred_sel=pred_sel)
    return prog


def add_ext(a: Rows, const_bits: Sequence[int], dst: Rows,
            pred_sel: int = PRED_ALWAYS, store_cout: bool = True,
            preset: bool = False) -> Program:
    """OOOR add: dst <- a + constant (constant streamed bit-serially).

    The eager form; `add_ext_stream` emits the same n+1-cycle schedule
    symbolically when the added value is bound at specialization time.
    """
    n = len(a)
    prog = Program()
    for i in range(n):
        prog.append(_w1(src1_row=a[i], dst_row=dst[i], truth_table=TT_XOR,
                        b_ext=1, ext_bit=const_bits[i], c_en=1,
                        c_rst=1 if (i == 0 and not preset) else 0,
                        pred_sel=pred_sel))
    if store_cout:
        prog += store_carry(dst[n], pred_sel=pred_sel)
    return prog


def add_ext_stream(a: Rows, stream: StreamedOperand, dst: Rows,
                   pred_sel: int = PRED_ALWAYS, store_cout: bool = True,
                   preset: bool = False) -> Program:
    """Symbolic OOOR add-const: dst <- a + stream, value bound later.

    Every bit position costs one cycle regardless of its value (the
    carry must ripple), so specialization substitutes broadcast bits
    without dead-digit elimination; with value v the result equals
    ``add_ext(a, bits_of(v), dst, ...)`` instruction-for-instruction.
    Bits past the stream width add zero (carry propagation only).
    """
    n = len(a)
    prog = Program(name=f"add_ext[{stream.name}]")
    for i in range(n):
        instr = _w1(src1_row=a[i], dst_row=dst[i], truth_table=TT_XOR,
                    b_ext=1, c_en=1,
                    c_rst=1 if (i == 0 and not preset) else 0,
                    pred_sel=pred_sel)
        if i < stream.n_bits:
            prog.append_stream(StreamExt(instr, stream, i))
        else:
            prog.append(instr)        # ext_bit 0: ripple the carry only
    if store_cout:
        prog += store_carry(dst[n], pred_sel=pred_sel)
    return prog


def sub(a: Rows, b: Rows, dst: Rows, tmp: Rows,
        store_cout: bool = True) -> Program:
    """dst <- a - b via a + ~b + 1.  2n+2 cycles (+1 for carry-out row).

    The stored carry-out is the *no-borrow* flag: 1 iff a >= b (unsigned).
    tmp: n scratch rows for ~b.
    """
    n = len(a)
    prog = logic2(b, b, tmp, TT_NOT_A)          # tmp <- ~b        (n cycles)
    prog += preset_carry()                      # carry <- 1       (1 cycle)
    prog += add(a, tmp, dst, store_cout=store_cout, preset=True)
    return prog


def mul(a: Rows, b: Rows, dst: Rows) -> Program:
    """dst(2n rows) <- a * b (unsigned).  Exactly n^2+3n-2 cycles.

    Shift-and-add with mask predication (Sec. III-E):
      - iteration 0 writes P[j] = b[j] AND a[0] directly (n cycles), upper
        half of P is zeroed (n cycles);
      - iterations i=1..n-1: load mask <- a[i] (1), predicated in-place add
        of b into P[i..i+n-1] (n), predicated carry store into P[i+n] (1).
    """
    n = len(a)
    assert len(dst) == 2 * n
    prog = Program()
    prog += zero_rows(dst[n:])                              # n
    prog += logic2(b, [a[0]] * n, dst[:n], TT_AND)          # n (iteration 0)
    for i in range(1, n):
        prog.append(Instr(src1_row=a[i], truth_table=TT_COPY_A, m_en=1,
                          c_rst=1))                         # mask <- a[i]
        prog += add(b, dst[i:i + n], dst[i:i + n], pred_sel=PRED_MASK,
                    store_cout=False)
        # masked columns must not pollute P[i+n]: predicated carry store
        prog += store_carry(dst[i + n], pred_sel=PRED_MASK)
    return prog


# in-place add of b into acc starting at bit offset `off` (used by dot/OOOR)
def add_into(acc: Rows, b: Rows, off: int,
             pred_sel: int = PRED_ALWAYS) -> Program:
    n = len(b)
    assert off + n <= len(acc)
    seg = list(acc[off:off + n])
    prog = add(seg, b, seg, pred_sel=pred_sel, store_cout=False)
    if off + n < len(acc):
        # ripple the carry-out through the remaining accumulator bits:
        # acc[off+n:] += carry  ==  add_ext of constant 0 with preset carry
        rem = list(acc[off + n:])
        prog += add_ext(rem, [0] * len(rem), rem, pred_sel=pred_sel,
                        store_cout=False, preset=True)
    return prog


# ---------------------------------------------------------------------------
# shifts (Sec. III-F)
# ---------------------------------------------------------------------------

def shift_lanes(src: Rows, dst: Rows, left: bool = True) -> Program:
    """Shift an operand one *lane* (column) left/right.  One cycle per row.

    Left shift: lane i receives lane i+1's bit (data moves toward lane 0),
    via W1 selecting the right neighbour's S; right shift via W2/left
    neighbour - matching Fig 2/6b.  Block chaining applies when the array
    was built with chain=True.
    """
    prog = Program()
    for s, d in zip(src, dst):
        if left:
            prog.append(Instr(src1_row=s, dst_row=d, truth_table=TT_COPY_A,
                              c_rst=1, wp1_en=1, w1_sel=W1_RIGHT))
        else:
            prog.append(Instr(src1_row=s, dst_row=d, truth_table=TT_COPY_A,
                              c_rst=1, wp2_en=1, w2_sel=W2_LEFT))
    return prog


# ---------------------------------------------------------------------------
# reduction (Sec. IV-C "Reduction")
# ---------------------------------------------------------------------------

def reduce_pairwise(val: Rows, scratch: Rows, width: int,
                    distance: int) -> Program:
    """One tree-reduction step: every lane adds the lane `distance` to its
    right: val[0:width+1] <- val + shift_left^distance(val).

    scratch needs `width` rows.  Cost: distance*width + (width+1) cycles.
    """
    prog = Program()
    cur = list(val[:width])
    for d in range(distance):
        prog += shift_lanes(cur, scratch[:width], left=True)
        cur = list(scratch[:width])
    prog += add(val[:width], cur, list(val[:width + 1]), store_cout=True)
    return prog


def reduce_tree(val: Rows, scratch: Rows, width: int, steps: int,
                chain_steps: int = 0) -> Program:
    """Reduce 2^(steps+chain_steps) consecutive lanes into each group head.

    After step s the live accumulator width grows by one bit.  Lane L of
    each group of 2^steps lanes ends with the group sum in lane 0 (other
    lanes hold garbage partial sums - exactly the paper's "40 partial sums
    per RAM" pattern when steps=2 over the 4 column-mux phases).

    `chain_steps` continues the distance-doubling past the in-block lane
    span: those steps' shift distances meet or exceed the 160-lane block
    width, so the partial sums hop across block boundaries through the
    corner-PE threading of adjacent RAMs (`W1_RIGHT` left shifts crossing
    the chain seam, Sec. III-F / Fig 6b).  Running a program with
    chain_steps > 0 - or any step whose groups straddle a block edge -
    requires an array built with ``chain=True``; on an unchained array the
    seam shifts in zeros and the cross-block partials are lost.

    val needs width + steps + chain_steps rows; scratch one fewer.
    """
    prog = Program()
    w = width
    for s in range(steps + chain_steps):
        prog += reduce_pairwise(val, scratch, w, 1 << s)
        w += 1
    return prog


def full_reduce_steps(n_blocks: int = 1, lanes: int = N_COLS):
    """(steps, chain_steps) reducing every lane of `n_blocks` blocks.

    Together they cover ceil(log2(lanes * n_blocks)) doubling steps: the
    first `steps` stay inside one block's lane span, the remaining
    `chain_steps` have distances >= the block width and hop partial sums
    across the RAM-to-RAM chain.  n_blocks=1 is the degenerate chain
    (chain_steps == 0).
    """
    total = ceil_log2(lanes * n_blocks)
    in_block = min(total, ceil_log2(lanes))
    return in_block, total - in_block


def reduce_to_scalar(val: Rows, scratch: Rows, width: int,
                     n_blocks: int = 1, lanes: int = N_COLS) -> Program:
    """Reduce ALL lanes of ALL chained blocks into lane 0 of block 0.

    The flat chained row is `n_blocks * lanes` wide; ceil(log2) doubling
    steps leave the grand total in the leftmost lane (edge shifts feed
    zeros, so lanes past the last block contribute nothing).  val needs
    width + ceil(log2(n_blocks * lanes)) rows, scratch one fewer.
    Requires chain=True whenever n_blocks > 1.
    """
    steps, chain_steps = full_reduce_steps(n_blocks, lanes)
    return reduce_tree(val, scratch, width, steps, chain_steps=chain_steps)


# ---------------------------------------------------------------------------
# FIR filter (Sec. IV-C): resident taps, streamed samples, chained shifts
# ---------------------------------------------------------------------------

def fir_sample_stream(taps: Rows, acc: Rows, stream: StreamedOperand,
                      shift: bool = True,
                      neg_scratch: Optional[Rows] = None) -> Program:
    """Symbolic transposed-FIR sample step: accumulate stream, then shift.

    The streamed sample is a `StreamMac` placeholder - the value-dependent
    accumulate schedule is chosen by `ir.specialize_streams` (naive
    zero-skip or Booth/NAF signed digits when `neg_scratch` rows are
    given); the trailing chained left shift is concrete.
    """
    prog = Program(name=f"fir_sample[{stream.name}]")
    prog.append_stream(StreamMac(stream, tuple(taps), tuple(acc),
                                 None if neg_scratch is None
                                 else tuple(neg_scratch)))
    if shift:
        prog += shift_lanes(acc, acc, left=True)
    return prog


def fir_sample(taps: Rows, acc: Rows, x_t: int, x_bits: int,
               shift: bool = True, recode: str = "naive",
               neg_scratch: Optional[Rows] = None) -> Program:
    """One transposed-FIR sample step: accumulate, then shift partials.

    Every lane holds one resident tap (lane j of the chained row = h_j)
    and a partial sum.  The streamed sample x_t is an outside operand the
    FSM inspects (OOOR, Sec. III-I): only the *nonzero digits* of the
    recoded sample trigger adds of the tap rows into the accumulator -
    zero digits cost nothing.  The schedule is emitted symbolically
    (`fir_sample_stream`) and specialized here; signed recodings
    (``"booth"`` / ``"naf"``) need `neg_scratch` rows for the tap
    complement.  The trailing chained left shift moves every partial one
    lane toward lane 0 (crossing block seams via the corner PEs),
    implementing the delay line: s_j(t) = h_j * x(t) + s_{j+1}(t-1).
    """
    sym = fir_sample_stream(taps, acc,
                            StreamedOperand(0, x_bits, "x_t"),
                            shift=shift, neg_scratch=neg_scratch)
    return specialize_streams(sym, [int(x_t)], recode=recode)


def fir_stream(taps: Rows, acc: Rows, n_samples: int, x_bits: int,
               neg_scratch: Optional[Rows] = None) -> Program:
    """Symbolic transposed-form FIR over `n_samples` streamed samples.

    Sample t is stream index t; `ir.specialize_streams` with the concrete
    sample vector produces the value-dependent schedule.
    """
    prog = zero_rows(acc)
    prog.name = "fir"
    for t in range(n_samples):
        prog += fir_sample_stream(taps, acc,
                                  StreamedOperand(t, x_bits, f"x[{t}]"),
                                  neg_scratch=neg_scratch)
    return prog


def fir(taps: Rows, acc: Rows, x_values: Sequence[int], x_bits: int,
        recode: str = "naive",
        neg_scratch: Optional[Rows] = None) -> Program:
    """Transposed-form FIR: y(t) = sum_j h_j * x(t - j) (Sec. IV-C).

    Taps stay resident one-per-lane across `n_blocks * 160` chained lanes;
    samples stream through the instruction generator (OOOR).  After the
    accumulate phase of sample t, lane 0 of block 0 holds y(t); the shift
    phase then drains it and advances the delay line.  A filter wider than
    one block's 160 lanes only works on a chain=True array - exactly the
    paper's FIR benchmark configuration (Sec. III-F / IV-C).

    Emitted unspecialized (`fir_stream`) then specialized against the
    sample vector: ``recode`` picks the digit set per sample (signed
    modes need `neg_scratch` rows for the tap complement).

    acc needs >= x_bits + tap_bits rows (tap_bits + x_bits + log2(n_taps)
    to be overflow-safe for the full filter).
    """
    sym = fir_stream(taps, acc, len(x_values), x_bits,
                     neg_scratch=neg_scratch)
    return specialize_streams(sym, [int(v) for v in x_values],
                              recode=recode)


# ---------------------------------------------------------------------------
# OOOR dot product (Sec. III-I): weights resident, activations streamed
# ---------------------------------------------------------------------------

def ooor_dot_stream(weight_rows: Sequence[Rows], x_bits: int, acc: Rows,
                    neg_scratch: Optional[Rows] = None,
                    first_stream: int = 0, zero_acc: bool = True) -> Program:
    """Symbolic OOOR dot product: acc <- sum_j w_j * stream_j.

    The value-independent template every streamed-GEMV consumer shares:
    element j is stream index ``first_stream + j``; `specialize_streams`
    substitutes the concrete activation vector and picks the digit
    schedule (naive zero-skip, or Booth/NAF when `neg_scratch` rows are
    provided for the complement of a negatively-weighted digit).
    """
    prog = Program(name="ooor_dot")
    if zero_acc:
        prog += zero_rows(acc)
    neg = None if neg_scratch is None else tuple(neg_scratch)
    for j, w in enumerate(weight_rows):
        prog.append_stream(StreamMac(
            StreamedOperand(first_stream + j, x_bits, f"x[{j}]",
                            digit_set="binary" if neg is None else "signed"),
            tuple(w), tuple(acc), neg))
    return prog


def ooor_dot(weight_rows: Sequence[Rows], x_values: Sequence[int],
             x_bits: int, acc: Rows) -> Program:
    """acc <- sum_j w_j * x_j with x outside the RAM.

    For each j, only the *set* bits b of x_j trigger an add of w_j into the
    accumulator at offset b - the paper's zero-bit-skipping optimization
    (~2x on average vs. streaming all bits).  The schedule is emitted
    unspecialized (`ooor_dot_stream`) and specialized here with naive
    binary digits, which is exactly the OOOR mechanism: the outside
    operand is visible to the FSM, not stored in the array.
    """
    sym = ooor_dot_stream(weight_rows, x_bits, acc)
    return specialize_streams(sym, [int(v) for v in x_values],
                              recode="naive")


# ---------------------------------------------------------------------------
# database search / RAID (Sec. IV-C bulk bitwise)
# ---------------------------------------------------------------------------

def search_replace(record_rows: Rows, key: int, n_bits: int,
                   tmp: Rows) -> Program:
    """Zero out records equal to `key` (DB search benchmark).

    xor with key (OOOR, n cycles) -> OR-reduce the xor bits into a "differs"
    flag (n-1 cycles, accumulated in tmp[0]) -> load mask from the flag ->
    clear record rows predicated on match (mask = differs -> we need the
    complement, so the mask is loaded from NOR instead).
    """
    n = n_bits
    key_bits = [(key >> i) & 1 for i in range(n)]
    prog = logic_ext(record_rows, tmp[:n], TT_XOR, key_bits)
    for i in range(1, n):
        prog += logic2([tmp[0]], [tmp[i]], [tmp[0]], TT_OR)
    # mask <- (differs == 0), i.e. NOT of tmp[0]
    prog.append(Instr(src1_row=tmp[0], truth_table=TT_NOT_A, m_en=1, c_rst=1))
    prog += [_w1(dst_row=r, truth_table=TT_ZERO, c_rst=1, pred_sel=PRED_MASK)
             for r in record_rows]
    return prog


def raid_rebuild(data_rows: Sequence[Rows], parity: Rows, out: Rows) -> Program:
    """Reconstruct a lost RAID stripe: out <- XOR of all surviving rows.

    Un-transposed layout (Sec. IV-C): each row holds one full operand, so a
    w-word stripe needs w XOR cycles per surviving drive.
    """
    prog = copy_rows(parity, out)
    for rows in data_rows:
        prog += logic2(out, rows, out, TT_XOR)
    return prog


# ---------------------------------------------------------------------------
# floating point (Sec. III-G, algorithms adapted from FloatPIM)
# ---------------------------------------------------------------------------

def fp_mul(sa: int, ea: Rows, ma: Rows, sb: int, eb: Rows, mb: Rows,
           sign_a_row: int, sign_b_row: int, sign_out: int,
           e_out: Rows, m_out: Rows, scratch: Rows, e_bits: int,
           m_bits: int, bias: Optional[int] = None) -> Program:
    """Floating-point multiply, sign/exponent/mantissa rows per element.

    Layout: exponents biased, mantissas without the implicit 1 (IEEE-like,
    no subnormals, truncating rounding - FloatPIM semantics).
    Scratch needs 2*(m_bits+1) + (e_bits+2) + (m_bits+1)*2 rows.

    Cycle count ~= M^2+7M+3E+5 (paper's approximation; tests assert the
    exact program length stays within a few cycles of it).
    """
    E, M = e_bits, m_bits
    if bias is None:
        bias = (1 << (E - 1)) - 1
    prog = Program()
    # sign
    prog += logic2([sign_a_row], [sign_b_row], [sign_out], TT_XOR)
    # exponent: e_out = ea + eb - bias, computed in place (carry scratch row)
    esum = list(e_out) + [scratch[0]]
    prog += add(ea, eb, esum, store_cout=True)
    neg_bias = ((1 << (E + 1)) - bias) & ((1 << (E + 1)) - 1)
    nb_bits = [(neg_bias >> i) & 1 for i in range(E + 1)]
    prog += add_ext(esum, nb_bits, esum, store_cout=False)
    # mantissa with implicit leading one: the constant ones row *is* the
    # leading-1 bit, so no operand copies are needed (A = rows ma + ones).
    a1 = list(ma) + [ROW_ONES]
    b1 = list(mb) + [ROW_ONES]
    prod = list(scratch[1:1 + 2 * (M + 1)])
    prog += mul(a1, b1, prod)                       # (M+1)^2+3(M+1)-2
    # normalize: product value v in [1,4); top bit prod[2M+1] == (v >= 2).
    prog.append(Instr(src1_row=prod[2 * M + 1], truth_table=TT_COPY_A,
                      m_en=1, c_rst=1))
    # fraction bits: v<2 -> prod[M:2M]; v>=2 -> prod[M+1:2M+1] (result v/2).
    # unconditional low-case copy, then masked high-case overwrite
    prog += copy_rows(prod[M:2 * M], m_out)
    prog += copy_rows(prod[M + 1:2 * M + 1], m_out, pred_sel=PRED_MASK)
    # exponent correction: +1 when the mask is set
    one_bits = [1] + [0] * E
    prog += add_ext(esum, one_bits, esum, pred_sel=PRED_MASK,
                    store_cout=False)
    return prog


def fp_add_same_sign(ea: Rows, ma: Rows, eb: Rows, mb: Rows,
                     e_out: Rows, m_out: Rows, scratch: Rows,
                     e_bits: int, m_bits: int) -> Program:
    """Floating-point add for operands of equal sign (magnitude add).

    Mixed-sign addition needs a leading-zero-count renormalisation loop the
    paper only costs approximately; the simulator implements the same-sign
    path exactly (see DESIGN.md scope note), the timing model uses the
    paper's 2ME+9M+7E+12 formula for both.

    Steps: exponent compare/subtract -> operand select (carry predicates) ->
    barrel-aligned mantissa shift (E stages of predicated row copies) ->
    mantissa add -> 1-step renormalise + exponent increment.
    """
    E, M = e_bits, m_bits
    prog = Program()
    pool = RowAllocator.from_rows(scratch)   # register-file over the scratch

    def take(k, name="t"):
        return pool.alloc(k, name, contiguous=False)

    d_ab = take(E + 1, "d_ab")      # ea - eb (carry row = a>=b flag)
    d_ba = take(E + 1, "d_ba")
    tmp = take(E, "tmp")
    e_big = take(E, "e_big")
    m_big = take(M + 1, "m_big")    # with implicit 1
    m_small = take(M + 1, "m_small")
    d_abs = take(E, "d_abs")
    ssum = take(M + 3, "ssum")

    prog += sub(ea, eb, d_ab, tmp, store_cout=True)   # carry=1 iff ea>=eb
    prog += sub(eb, ea, d_ba, tmp, store_cout=True)
    # carry latch currently holds the borrow flag of (eb-ea); reload the
    # a>=b flag from d_ab's stored carry row (CGEN with A=B=flag, cin=0):
    prog.append(Instr(src1_row=d_ab[E], src2_row=d_ab[E],
                      truth_table=TT_AND, c_en=1, c_rst=1))
    prog += copy_rows(ea, e_big, pred_sel=PRED_CARRY)
    prog += copy_rows(eb, e_big, pred_sel=PRED_NOT_CARRY)
    prog += copy_rows(ma, m_big[:M], pred_sel=PRED_CARRY)
    prog += copy_rows(mb, m_big[:M], pred_sel=PRED_NOT_CARRY)
    prog += copy_rows(mb, m_small[:M], pred_sel=PRED_CARRY)
    prog += copy_rows(ma, m_small[:M], pred_sel=PRED_NOT_CARRY)
    prog += copy_rows([ROW_ONES], [m_big[M]])
    prog += copy_rows([ROW_ONES], [m_small[M]])
    prog += copy_rows(d_ab[:E], d_abs, pred_sel=PRED_CARRY)
    prog += copy_rows(d_ba[:E], d_abs, pred_sel=PRED_NOT_CARRY)
    # align m_small right by d_abs: E barrel stages of predicated copies
    for k in range(E):
        prog.append(Instr(src1_row=d_abs[k], truth_table=TT_COPY_A, m_en=1,
                          c_rst=1))
        s = 1 << k
        for j in range(M + 1):
            src = m_small[j + s] if j + s <= M else None
            if src is None:
                prog += [_w1(dst_row=m_small[j], truth_table=TT_ZERO,
                             c_rst=1, pred_sel=PRED_MASK)]
            else:
                prog += copy_rows([src], [m_small[j]], pred_sel=PRED_MASK)
    # mantissa add (M+1 bits + carry)
    prog += add(m_big, m_small, ssum[:M + 2], store_cout=True)
    # renormalise: if carry-out bit (sum >= 2.0) set, shift right 1 & e+1
    prog.append(Instr(src1_row=ssum[M + 1], truth_table=TT_COPY_A, m_en=1,
                      c_rst=1))
    prog += copy_rows(ssum[:M], m_out)               # no-overflow case
    prog += copy_rows(ssum[1:M + 1], m_out, pred_sel=PRED_MASK)
    prog += copy_rows(e_big, e_out)
    prog += add_ext(e_out, [1] + [0] * (E - 1), e_out, pred_sel=PRED_MASK,
                    store_cout=False)
    return prog


# ---------------------------------------------------------------------------
# extended ops: compare/select, max-reduce, division, Booth OOOR
# (all built from the same ISA - the paper's "versatile blocks" claim)
# ---------------------------------------------------------------------------

def compare_ge(a: Rows, b: Rows, tmp: Rows, flag_row: int) -> Program:
    """flag <- (a >= b) per lane, via the subtract borrow chain.

    2n+3 cycles; leaves the flag in `flag_row` AND in the carry latch
    (so a following predicated op can use PRED_CARRY directly).
    """
    n = len(a)
    prog = sub(a, b, list(tmp[:n]) + [flag_row], list(tmp[n:2 * n]),
               store_cout=True)
    return prog


def select(cond_carry: bool, a: Rows, b: Rows, dst: Rows) -> Program:
    """dst <- carry ? a : b (2n cycles of predicated copies)."""
    prog = copy_rows(a, dst, pred_sel=PRED_CARRY)
    prog += copy_rows(b, dst, pred_sel=PRED_NOT_CARRY)
    return prog


def reduce_max(val: Rows, scratch: Rows, n_bits: int,
               distance: int) -> Program:
    """One max-tree step: each lane takes max(self, lane+distance).

    scratch: n_bits (shifted copy) + 2*n_bits+1 (compare temps) rows.
    """
    n = n_bits
    shifted = list(scratch[:n])
    tmp = list(scratch[n:3 * n + 1])
    prog = Program()
    cur = list(val[:n])
    for _ in range(distance):
        prog += shift_lanes(cur, shifted, left=True)
        cur = shifted
    # carry <- (self >= shifted); keep self where true, else take shifted
    prog += compare_ge(val[:n], shifted, tmp, tmp[2 * n])
    prog += copy_rows(shifted, val[:n], pred_sel=PRED_NOT_CARRY)
    return prog


def div(a: Rows, b: Rows, quot: Rows, rem: Rows, scratch: Rows
        ) -> Program:
    """Restoring long division: quot, rem <- a // b, a % b (unsigned).

    a, b, quot, rem: n rows each; scratch: 2n+1 + n rows.
    ~n*(3n+5) cycles - bit-serial division is expensive, exactly why the
    paper steers division-free algorithms toward CoMeFa blocks.
    """
    n = len(a)
    pool = RowAllocator.from_rows(scratch)
    diff = pool.alloc(n + 1, "diff", contiguous=False)
    tmp = pool.alloc(n, "tmp", contiguous=False)
    prog = zero_rows(rem)
    for i in reversed(range(n)):
        # rem = (rem << 1) | a_i   (shift within the bit rows of each lane)
        for j in reversed(range(1, n)):
            prog += copy_rows([rem[j - 1]], [rem[j]])
        prog += copy_rows([a[i]], [rem[0]])
        # carry <- rem >= b ; diff = rem - b
        prog += sub(rem, b, diff, tmp, store_cout=True)
        # reload the no-borrow flag into the carry latch
        prog.append(Instr(src1_row=diff[n], src2_row=diff[n],
                          truth_table=TT_AND, c_en=1, c_rst=1))
        # if no borrow: rem = diff, quot_i = 1 else quot_i = 0
        prog += copy_rows(diff[:n], rem, pred_sel=PRED_CARRY)
        prog += copy_rows([ROW_ONES], [quot[i]], pred_sel=PRED_CARRY)
        prog += [_w1(dst_row=quot[i], truth_table=TT_ZERO, c_rst=1,
                     pred_sel=PRED_NOT_CARRY)]
    return prog


def booth_digits(x: int, n_bits: int) -> List[int]:
    """Canonical (NAF) Booth recoding of x: digits in {-1,0,+1}.

    sum(d_i * 2^i) == x.  The non-adjacent form has minimal Hamming
    weight among signed-digit representations - never more nonzero
    digits than binary, and ~2x fewer for runs of ones: the paper's
    "efficient algorithms like booth multiplication can also be
    deployed" (Sec. III-I).  Legacy alias of `ir.naf_digits`; the classic
    radix-2 recoding lives at `ir.booth_radix2_digits`.
    """
    return ir.naf_digits(x)


def ooor_dot_booth(weight_rows: Sequence[Rows], x_values: Sequence[int],
                   x_bits: int, acc: Rows, neg_scratch: Rows
                   ) -> Program:
    """OOOR dot product with NAF-Booth-recoded outside operand.

    For x values with long runs of ones (e.g. 0b0111110), Booth recoding
    cuts add passes well below popcount(x); worst case equals naive OOOR.
    Negative digits subtract: w is complemented into scratch once per
    element, then added with a preset carry at the digit offset.  The
    schedule is the NAF specialization of the same `ooor_dot_stream`
    template the naive dot uses.
    """
    sym = ooor_dot_stream(weight_rows, x_bits, acc, neg_scratch=neg_scratch)
    return specialize_streams(sym, [int(v) for v in x_values],
                              recode="naf")


# ---------------------------------------------------------------------------
# ProgramBuilder: allocator-backed assembly of whole kernels
# ---------------------------------------------------------------------------

class ProgramBuilder:
    """Assemble CoMeFa programs against allocator-managed row operands.

    Replaces the seed code's hand-threaded `list(range(...))` row
    bookkeeping: operands come from a `RowAllocator`, every op allocates
    its own destination, and `build()` returns an `ir.Program` annotated
    with the live-out rows (everything still allocated - freed scratch is
    declared dead, which is what arms the dead-write-elimination pass).

        b = ProgramBuilder("madd")
        x, y = b.input(8, "x"), b.input(8, "y")
        p = b.mul(x, y)
        s = b.add(p, p)
        prog = b.build()          # optimized, live_out = {x, y, p, s}

    Inputs are placed with `layout.place(arr, values, op.base, op.n_bits)`.
    """

    def __init__(self, name: str = "prog",
                 alloc: Optional[RowAllocator] = None):
        self.name = name
        self.alloc = alloc or RowAllocator()
        self._prog = Program(name=name)
        self._live = set()
        self._retired = set()

    # -- operands ----------------------------------------------------------
    def input(self, n_bits: int, name: str = "in") -> Operand:
        """Allocate rows for an operand the caller will place data into."""
        op = self.alloc.alloc(n_bits, name)
        self._live.update(op)
        return op

    def temp(self, n_bits: int, name: str = "tmp") -> Operand:
        """Allocate scratch rows; call `drop()` when done to mark it dead."""
        op = self.alloc.alloc(n_bits, name)
        self._live.update(op)
        return op

    def drop(self, op: Operand) -> None:
        """Mark an operand dead at program exit (arms dead-write elim).

        The rows are NOT returned to the allocator: instructions already
        emitted still write them, so handing them to a later `input()`
        would let the program clobber caller-placed data mid-run.  They
        stay retired for the builder's lifetime.
        """
        if self._retired & set(op):
            raise ValueError(f"operand {op!r} already dropped")
        if not set(op) <= (self._live | self._retired):
            raise ValueError(f"operand {op!r} not from this builder")
        self._retired.update(op)
        self._live.difference_update(op)

    # -- ops (each allocates its destination and emits the schedule) -------
    def emit(self, prog) -> None:
        self._prog += prog

    def zero(self, n_bits: int, name: str = "z") -> Operand:
        dst = self.input(n_bits, name)
        self._prog += zero_rows(dst)
        return dst

    def copy(self, src: Rows, pred_sel: int = PRED_ALWAYS,
             name: str = "cp") -> Operand:
        dst = self.input(len(src), name)
        self._prog += copy_rows(src, dst, pred_sel=pred_sel)
        return dst

    def logic(self, a: Rows, b: Rows, tt: int, name: str = "l") -> Operand:
        dst = self.input(len(a), name)
        self._prog += logic2(a, b, dst, tt)
        return dst

    def add(self, a: Rows, b: Rows, store_cout: bool = True,
            name: str = "sum") -> Operand:
        dst = self.input(len(a) + (1 if store_cout else 0), name)
        self._prog += add(a, b, dst, store_cout=store_cout)
        return dst

    def sub(self, a: Rows, b: Rows, name: str = "diff") -> Operand:
        n = len(a)
        dst = self.input(n + 1, name)
        tmp = self.temp(n)
        self._prog += sub(a, b, dst, tmp)
        self.drop(tmp)
        return dst

    def mul(self, a: Rows, b: Rows, name: str = "prod") -> Operand:
        dst = self.input(2 * len(a), name)
        self._prog += mul(a, b, dst)
        return dst

    def dot(self, weights: Sequence[Rows], x_values: Sequence[int],
            x_bits: int, acc_bits: int, name: str = "acc") -> Operand:
        """OOOR dot product into a fresh accumulator (Sec. III-I)."""
        acc = self.input(acc_bits, name)
        self._prog += ooor_dot(weights, list(x_values), x_bits, acc)
        return acc

    def reduce(self, val: Rows, width: int, steps: int,
               chain_steps: int = 0) -> None:
        """In-place lane-tree reduction.

        val needs width + steps + chain_steps rows; chain_steps extra
        block-hopping steps require a chain=True array.
        """
        total = steps + chain_steps
        assert len(val) >= width + total, \
            f"val needs {width + total} rows, has {len(val)}"
        tmp = self.temp(max(1, width + total - 1))
        self._prog += reduce_tree(val, tmp, width, steps,
                                  chain_steps=chain_steps)
        self.drop(tmp)

    def reduce_all(self, val: Rows, width: int, n_blocks: int = 1) -> None:
        """Reduce every lane of every chained block into lane 0 of block 0.

        val needs width + ceil(log2(n_blocks * 160)) rows; the shifts of
        the chain-hop steps require the array to be built with chain=True
        when n_blocks > 1.
        """
        steps, chain_steps = full_reduce_steps(n_blocks)
        self.reduce(val, width, steps, chain_steps=chain_steps)

    def fir(self, taps: Rows, x_values: Sequence[int], x_bits: int,
            acc_bits: int, name: str = "acc") -> Operand:
        """Transposed FIR into a fresh accumulator (resident taps, streamed
        samples); y(t) appears in lane 0 after each sample's accumulate."""
        acc = self.input(acc_bits, name)
        self._prog += fir(taps, acc, list(x_values), x_bits)
        return acc

    # -- finalise ----------------------------------------------------------
    def build(self, optimize: bool = True) -> Program:
        """The assembled program; optimized through the IR pass pipeline."""
        prog = self._prog.with_live_out(self._live)
        prog.name = self.name
        return prog.optimize() if optimize else prog
