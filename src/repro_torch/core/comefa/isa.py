"""CoMeFa 40-bit instruction set (paper Fig. 5).

The paper specifies a 40-bit instruction written to the reserved address
0x1FF on Port A, with "self-explanatory" fields driving the PE control
signals directly (src1_row / src2_row / dst_row, truth-table bits, predicate
select, write-mux selects, carry/mask control).  The exact bit layout is not
published, so we fix a concrete layout below and keep it stable across the
encoder, decoder, simulator and timing model.

Bit layout (LSB first)::

    [ 6: 0]  src1_row    row read on Port A  (operand bit A)
    [13: 7]  src2_row    row read on Port B  (operand bit B)
    [20:14]  dst_row     row written in the write phase
    [24:21]  truth_table TR output = tt[(A << 1) | B]   (TR3..TR0)
    [26:25]  pred_sel    write-driver enable: 0=VDD(always) 1=mask
                         2=carry 3=not-carry              (mux "P", Fig 2)
    [28:27]  w1_sel      Port-A write mux: 0=S 1=d_in1 2=right-neighbour S
                         (left shift) 3=unused            (mux "W1")
    [30:29]  w2_sel      Port-B write mux: 0=carry 1=d_in2 2=left-neighbour S
                         (right shift) 3=unused           (mux "W2")
    [31]     wp1_en      activate Port-A write path ("wps1")
    [32]     wp2_en      activate Port-B write path ("wps2")
    [33]     c_en        carry latch updates this cycle
    [34]     c_rst       carry latch is reset before compute
    [35]     m_en        mask latch loads TR output this cycle
    [36]     ext_bit     broadcast operand bit for OOOR ops (Sec. III-I)
    [37]     b_ext       if set, the PE's B input is `ext_bit` instead of the
                         Port-B read (models One-Operand-Outside-RAM)
    [39:38]  reserved

Only one of wp1_en/wp2_en is set per instruction in the programs we
generate: Port A writes the sum path (S), Port B writes the carry path.

Truth-table constants: index = (A << 1) | B, i.e. bit0 = f(0,0),
bit1 = f(0,1), bit2 = f(1,0), bit3 = f(1,1).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

N_ROWS = 128          # physical wordlines
N_COLS = 160          # physical bitline pairs == PE lanes (CoMeFa-D)
WORD_BITS = 40        # logical port width in hybrid mode (512 x 40)
COL_MUX = 4           # column multiplexing factor
INSTR_ADDR = 0x1FF    # reserved logical address for instructions

# Reserved constant rows, initialised by `ComefaArray.reset()` and relied on
# by program generators and the IR constant-folding pass (`ir.py`).
ROW_ONES = N_ROWS - 1   # row 127: all ones
ROW_ZEROS = N_ROWS - 2  # row 126: all zeros
RESERVED_ROWS = (ROW_ZEROS, ROW_ONES)
# Rows available to operands: everything except the reserved constant rows.
# Row-budget checks (RowAllocator, the sim-backed kernels) derive from this
# rather than hardcoding the number.
USABLE_ROWS = N_ROWS - len(RESERVED_ROWS)


def ceil_log2(x: int) -> int:
    """Smallest k with 2^k >= x (0 for x <= 1); sizes reduction trees."""
    return max(0, int(x - 1).bit_length())

# truth tables (TR output indexed by (A<<1)|B)
TT_ZERO = 0b0000
TT_AND = 0b1000
TT_A_ANDN_B = 0b0100   # A & ~B
TT_COPY_A = 0b1100
TT_NOTA_AND_B = 0b0010
TT_COPY_B = 0b1010
TT_XOR = 0b0110
TT_OR = 0b1110
TT_NOR = 0b0001
TT_XNOR = 0b1001
TT_NOT_B = 0b0101
TT_NOT_A = 0b0011
TT_NAND = 0b0111
TT_ONE = 0b1111

# predicate select values (mux P)
PRED_ALWAYS = 0
PRED_MASK = 1
PRED_CARRY = 2
PRED_NOT_CARRY = 3

# W1 select
W1_S = 0
W1_DIN = 1
W1_RIGHT = 2     # take right neighbour's S  -> left shift
# W2 select
W2_CARRY = 0
W2_DIN = 1
W2_LEFT = 2      # take left neighbour's S   -> right shift
W2_ZERO = 3      # write driver pulls the bitline low (constant 0).  The
                 # 40-bit ISA leaves this encoding unused; the IR co-issue
                 # scheduler uses it to retarget TT_ZERO row clears onto the
                 # otherwise-idle Port-B write path.

FIELDS = (
    ("src1_row", 0, 7),
    ("src2_row", 7, 7),
    ("dst_row", 14, 7),
    ("truth_table", 21, 4),
    ("pred_sel", 25, 2),
    ("w1_sel", 27, 2),
    ("w2_sel", 29, 2),
    ("wp1_en", 31, 1),
    ("wp2_en", 32, 1),
    ("c_en", 33, 1),
    ("c_rst", 34, 1),
    ("m_en", 35, 1),
    ("ext_bit", 36, 1),
    ("b_ext", 37, 1),
)
FIELD_NAMES = tuple(f[0] for f in FIELDS)
N_FIELDS = len(FIELDS)

# ---------------------------------------------------------------------------
# Engine-level (micro-op) field matrix.
#
# The simulator consumes programs as an int32 field matrix whose columns are
# the ISA fields plus two *engine* fields that exist so the IR scheduler can
# co-issue an independent Port-B write alongside a Port-A instruction
# (`ir.coissue_dual_port`):
#
#   dst2_row   row written by the Port-B write path (W2).  For a plain
#              instruction this equals dst_row - both write paths target the
#              single ISA destination, exactly the old engine behaviour.
#   pred2_sel  predicate select for the Port-B write driver.  Equals
#              pred_sel for a plain instruction.
#
# A fused micro-op is two 40-bit ISA words retired in one processing cycle:
# the compute side drives the PE and Port A, the W2 side only consumes the
# latched carry (or drives zero) and Port B's write port - the Port-A/Port-B
# concurrency of the true-dual-port BRAM that single-`dst_row` encoding
# cannot express.
# ---------------------------------------------------------------------------
ENGINE_FIELD_NAMES = FIELD_NAMES + ("dst2_row", "pred2_sel")
N_ENGINE_FIELDS = len(ENGINE_FIELD_NAMES)
_W2_SEL_IDX = FIELD_NAMES.index("w2_sel")


@dataclasses.dataclass(frozen=True)
class Instr:
    """One decoded CoMeFa instruction."""
    src1_row: int = 0
    src2_row: int = 0
    dst_row: int = 0
    truth_table: int = TT_ZERO
    pred_sel: int = PRED_ALWAYS
    w1_sel: int = W1_S
    w2_sel: int = W2_CARRY
    wp1_en: int = 0
    wp2_en: int = 0
    c_en: int = 0
    c_rst: int = 0
    m_en: int = 0
    ext_bit: int = 0
    b_ext: int = 0

    def __post_init__(self):
        for name, _, width in FIELDS:
            v = getattr(self, name)
            if not 0 <= v < (1 << width):
                raise ValueError(f"field {name}={v} out of range (width {width})")

    def encode(self) -> int:
        """Pack to the 40-bit word written at address 0x1FF."""
        word = 0
        for name, off, _ in FIELDS:
            word |= getattr(self, name) << off
        return word

    @staticmethod
    def decode(word: int) -> "Instr":
        if not 0 <= word < (1 << WORD_BITS):
            raise ValueError("instruction word must fit in 40 bits")
        kw = {}
        for name, off, width in FIELDS:
            kw[name] = (word >> off) & ((1 << width) - 1)
        return Instr(**kw)

    def to_vector(self) -> np.ndarray:
        return np.array([getattr(self, n) for n in FIELD_NAMES], dtype=np.int32)

    def engine_vector(self) -> List[int]:
        """ISA fields widened with the engine fields (dst2=dst, pred2=pred).

        Legacy fixup: a W2_CARRY write with c_rst=1 historically wrote the
        *gated* carry input (i.e. 0); the engine's W2 carry source is now the
        raw latch, so such an instruction is rewritten to W2_ZERO here.
        """
        v = [getattr(self, n) for n in FIELD_NAMES]
        if self.wp2_en and self.w2_sel == W2_CARRY and self.c_rst:
            v[_W2_SEL_IDX] = W2_ZERO
        return v + [self.dst_row, self.pred_sel]


def latch_clear() -> Instr:
    """Instruction that resets both PE latches in one cycle, no row writes.

    Reads the all-zeros row on both ports with TT_ZERO: the mask latch
    loads TR = 0 (`m_en`), and the carry latch loads CGEN(0, 0, 0) = 0
    (`c_en` with `c_rst` gating the carry input).  Used at `run_programs`
    batch boundaries so latch state cannot leak between programs.
    """
    return Instr(src1_row=ROW_ZEROS, src2_row=ROW_ZEROS,
                 truth_table=TT_ZERO, c_en=1, c_rst=1, m_en=1)


def encode_program(instrs: Sequence[Instr]) -> np.ndarray:
    """Program -> int32 field matrix [T, N_ENGINE_FIELDS] for the engine."""
    if len(instrs) == 0:
        return np.zeros((0, N_ENGINE_FIELDS), dtype=np.int32)
    return np.array([i.engine_vector() for i in instrs], dtype=np.int32)


def program_words(instrs: Sequence[Instr]) -> List[int]:
    """Program as raw 40-bit words (what the host writes to 0x1FF)."""
    return [i.encode() for i in instrs]
