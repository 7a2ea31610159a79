"""First-class program IR for CoMeFa instruction streams.

The paper's "instruction generation FSM" (Sec. III-D) emits bit-serial
schedules; this module treats those schedules as *compiled artifacts* rather
than flat instruction lists:

  * `Program`    - the IR container: an ordered list of *slots*, each slot
                   holding one or two `isa.Instr` that retire in a single
                   processing cycle.  Carries effect metadata, an optional
                   live-out row set, and caches of its engine encoding and a
                   structural fingerprint (keying the simulator's encode
                   cache in `block.py`).
  * `RowAllocator` / `Operand`
                 - a register-file allocator for row operands, replacing the
                   hand-threaded `Rows` index lists of the seed code.
  * `StreamedOperand` / `StreamMac` / `StreamExt`
                 - *symbolic* outside operands (Sec. III-I OOOR): a program
                   can be emitted unspecialized, with placeholder slots
                   standing for "stream this yet-unknown value bit-serially";
                   `specialize_streams` later substitutes concrete values,
                   recoding them into naive / Booth / NAF digit streams and
                   eliminating dead (zero) digits - the paper's FSM
                   zero-bit skipping lifted into a compiler pass.
  * passes       - `fold_constant_rows` (Sec. III-B: the reserved all-ones /
                   all-zeros rows plus in-program constant tracking),
                   `eliminate_dead_writes` (scratch writes never observed at
                   program exit), and `coissue_dual_port` (Sec. II-A/III-A:
                   the true-dual-port BRAM has two independent write paths,
                   W1 on Port A and W2 on Port B, but the flat encoding only
                   ever used one per cycle - this pass packs an independent
                   W2 write into an adjacent cycle's idle Port B).

Effect metadata is *derived* from the instruction fields, conservatively:
over-approximated reads and under-approximated kills, so every pass is
sound by construction.  `tests/test_ir.py` asserts optimized programs are
bit-identical in memory/latch state to their unoptimized forms on random
operands.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from . import isa
from .diagnostics import (CONCAT_INPUT, PASS_STRUCTURE, STREAM_DIGITS,
                          STREAM_MISSING, STREAM_RANGE, STREAM_RECODE,
                          SYMBOLIC_SLOT, VerificationError, raise_diag)
from .isa import (Instr, N_ROWS, PRED_ALWAYS, PRED_CARRY, PRED_MASK,
                  PRED_NOT_CARRY, RESERVED_ROWS, ROW_ONES, ROW_ZEROS,
                  TT_ONE, TT_ZERO, W1_RIGHT, W1_S, W2_CARRY, W2_ZERO)

Slot = Tuple[Instr, ...]          # 1 instr, or 2 fused into one cycle


# ---------------------------------------------------------------------------
# effect metadata
# ---------------------------------------------------------------------------

def _tt_swap_ab(tt: int) -> int:
    """Truth table with the A/B operand roles exchanged."""
    return ((tt & 0b1001)
            | ((tt >> 1) & 0b0010)        # f(1,0) <- old f(0,1)
            | ((tt << 1) & 0b0100))       # f(0,1) <- old f(1,0)


def _tt_fix_a(tt: int, a: int) -> int:
    """Truth table specialised to a constant A: result depends on B only."""
    t0 = (tt >> ((a << 1) | 0)) & 1
    t1 = (tt >> ((a << 1) | 1)) & 1
    return t0 | (t1 << 1) | (t0 << 2) | (t1 << 3)


def _tt_fix_b(tt: int, b: int) -> int:
    """Truth table specialised to a constant B: result depends on A only."""
    t0 = (tt >> ((0 << 1) | b)) & 1
    t1 = (tt >> ((1 << 1) | b)) & 1
    return t0 | (t0 << 1) | (t1 << 2) | (t1 << 3)


def _tt_uses_a(tt: int) -> bool:
    return _tt_fix_a(tt, 0) != _tt_fix_a(tt, 1)


def _tt_uses_b(tt: int) -> bool:
    return _tt_fix_b(tt, 0) != _tt_fix_b(tt, 1)


@dataclasses.dataclass(frozen=True)
class Effects:
    """Row/latch effects of one instruction (conservative)."""
    reads: frozenset          # rows whose values feed the PE or a write mux
    writes: frozenset         # rows possibly written (may-write: predicated)
    full_writes: frozenset    # rows written in every lane (pred = ALWAYS)
    reads_carry: bool
    writes_carry: bool
    reads_mask: bool
    writes_mask: bool


def instr_effects(i: Instr) -> Effects:
    """Derive the effect set of one instruction from its fields.

    Reads are over-approximated (a row is listed whenever its value *could*
    influence state); full_writes are under-approximated (only unpredicated
    writes kill a row) - the safe directions for every pass below.
    """
    reads = set()
    # the PE's A/B inputs feed TR (used by S -> the W1/W2 shift write paths
    # and the mask latch) and CGEN (used when the carry latch updates)
    consumes_tr = ((i.wp1_en and i.w1_sel in (W1_S, W1_RIGHT)) or i.m_en
                   or (i.wp2_en and i.w2_sel == isa.W2_LEFT))
    if i.c_en or consumes_tr:
        a_used = i.c_en or _tt_uses_a(i.truth_table)
        b_used = i.c_en or _tt_uses_b(i.truth_table)
        if a_used:
            reads.add(i.src1_row)
        if b_used and not i.b_ext:
            reads.add(i.src2_row)
    writes = set()
    if i.wp1_en or i.wp2_en:
        writes.add(i.dst_row)
    full = set(writes) if i.pred_sel == PRED_ALWAYS else set()
    reads_carry = (i.pred_sel in (PRED_CARRY, PRED_NOT_CARRY)
                   or (i.wp2_en and i.w2_sel == W2_CARRY and not i.c_rst)
                   or (i.c_en and not i.c_rst)
                   or (consumes_tr and not i.c_rst))   # S = TR ^ c_in
    return Effects(frozenset(reads), frozenset(writes), frozenset(full),
                   reads_carry=reads_carry, writes_carry=bool(i.c_en),
                   reads_mask=i.pred_sel == PRED_MASK,
                   writes_mask=bool(i.m_en))


# ---------------------------------------------------------------------------
# row-register allocation
# ---------------------------------------------------------------------------

class Operand(tuple):
    """A named, allocated group of rows - usable anywhere `Rows` is.

    Behaves as a tuple of row indices (LSB first), so the program
    generators, `layout.place` and slicing all work unchanged.
    """
    name: str

    def __new__(cls, rows: Iterable[int], name: str = "t"):
        self = super().__new__(cls, rows)
        self.name = name
        return self

    @property
    def base(self) -> int:
        return self[0]

    @property
    def n_bits(self) -> int:
        return len(self)

    def __repr__(self):
        return f"Operand({self.name}: rows {list(self)})"


class RowAllocator:
    """Register-file allocator for the 128 wordlines of one block.

    Replaces the seed's hand-threaded `list(range(...))` row bookkeeping:
    operands are allocated contiguously (so `layout.place(arr, v, op.base,
    op.n_bits)` works), freed explicitly or via `scratch()`, and the
    reserved constant rows are never handed out.
    """

    def __init__(self, n_rows: int = N_ROWS,
                 reserved: Sequence[int] = RESERVED_ROWS):
        self.n_rows = n_rows
        self._free = sorted(set(range(n_rows)) - set(reserved))
        self._reserved = tuple(reserved)
        self._allocated = set()

    @classmethod
    def from_rows(cls, rows: Sequence[int]) -> "RowAllocator":
        """An allocator over an explicit row pool (e.g. caller scratch)."""
        a = cls.__new__(cls)
        a.n_rows = N_ROWS
        a._free = sorted(set(rows))
        a._reserved = ()
        a._allocated = set()
        return a

    @property
    def n_free(self) -> int:
        return len(self._free)

    def alloc(self, n_bits: int, name: str = "t",
              contiguous: bool = True) -> Operand:
        """Allocate `n_bits` rows - contiguous (first fit) by default, so
        `layout.place(arr, v, op.base, op.n_bits)` works on the result."""
        free = self._free
        if not contiguous:
            if len(free) < n_bits:
                raise MemoryError(f"{n_bits} rows requested, "
                                  f"{len(free)} free")
            rows = free[:n_bits]
            del free[:n_bits]
            self._allocated.update(rows)
            return Operand(rows, name)
        run = 0
        for idx in range(len(free)):
            run = run + 1 if (idx and free[idx] == free[idx - 1] + 1) else 1
            if run == n_bits:
                start = idx - n_bits + 1
                rows = free[start:idx + 1]
                del free[start:idx + 1]
                self._allocated.update(rows)
                return Operand(rows, name)
        raise MemoryError(
            f"no contiguous run of {n_bits} rows free "
            f"({len(free)} fragmented rows left)")

    def free(self, op: Sequence[int]) -> None:
        for r in op:
            if r not in self._allocated:
                raise ValueError(
                    f"row {r} not allocated from this allocator "
                    f"(double free, foreign operand, or reserved row)")
        self._allocated.difference_update(op)
        self._free = sorted(set(self._free) | set(op))

    def scratch(self, n_bits: int, name: str = "scratch"):
        """Context manager: temporary operand, freed on exit."""
        alloc = self

        class _Scratch:
            def __enter__(self_inner):
                self_inner.op = alloc.alloc(n_bits, name)
                return self_inner.op

            def __exit__(self_inner, *exc):
                alloc.free(self_inner.op)
                return False

        return _Scratch()


# ---------------------------------------------------------------------------
# streamed operands (Sec. III-I OOOR, as first-class IR)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StreamedOperand:
    """A symbolic outside operand: value streamed by the FSM, not stored.

    The OOOR mechanism (Sec. III-I) lets the instruction-generation FSM
    inspect an operand that never enters the array and emit only the
    instructions its nonzero digits require.  Generators emit programs
    *unspecialized* against one of these; `specialize_streams` substitutes
    the concrete value per invocation (recoded into the chosen digit set).

    `index` names the position of the concrete value in the sequence
    handed to `specialize_streams`; `digit_set` declares what the
    consuming slots can execute - ``"binary"`` ({0, 1}: substitution and
    zero-skipping only) or ``"signed"`` ({-1, 0, +1}: Booth/NAF recoding,
    which needs a complement scratch region at the consuming `StreamMac`).
    """
    index: int
    n_bits: int
    name: str = "x"
    digit_set: str = "signed"

    def __post_init__(self):
        assert self.index >= 0 and self.n_bits >= 1
        assert self.digit_set in ("binary", "signed"), self.digit_set


class StreamSlot:
    """Marker base for symbolic slots awaiting stream specialization."""
    __slots__ = ()


@dataclasses.dataclass(frozen=True)
class StreamMac(StreamSlot):
    """Symbolic ``acc += weight * stream``: one digit-serial MAC.

    Expands, per nonzero digit d of the recoded stream value at offset
    ``off``, into an accumulator-segment add (d = +1) or a
    complement-add with preset carry plus sign extension (d = -1, which
    requires the ``neg`` scratch rows).  Zero digits expand to nothing -
    the dead-digit elimination that used to live inside `ooor_dot`.
    """
    stream: StreamedOperand
    weight: Tuple[int, ...]
    acc: Tuple[int, ...]
    neg: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        object.__setattr__(self, "weight", tuple(self.weight))
        object.__setattr__(self, "acc", tuple(self.acc))
        if self.neg is not None:
            object.__setattr__(self, "neg", tuple(self.neg))
            assert len(self.neg) >= len(self.weight)


@dataclasses.dataclass(frozen=True)
class StreamExt(StreamSlot):
    """Symbolic OOOR instruction: `instr` with ``ext_bit`` = stream bit.

    The template must already read its B operand from the broadcast path
    (``b_ext=1``); specialization substitutes bit ``bit`` of the stream's
    concrete value.  This is the streamed form of the `logic_ext` /
    `add_ext` OOOR generators (eltwise against an outside operand,
    add-a-constant) - one cycle per row either way, but the value no
    longer needs to be known at emission time.
    """
    instr: Instr
    stream: StreamedOperand
    bit: int

    def __post_init__(self):
        assert self.instr.b_ext == 1, "StreamExt template must set b_ext"
        assert 0 <= self.bit < self.stream.n_bits


# -- digit recoders ---------------------------------------------------------

def naive_digits(x: int, n_bits: int) -> List[int]:
    """Plain binary digits of x, LSB first ({0, 1} - popcount schedule)."""
    assert 0 <= x < (1 << n_bits)
    return [(x >> i) & 1 for i in range(n_bits)]


def booth_radix2_digits(x: int, n_bits: int) -> List[int]:
    """Classic radix-2 Booth recoding: d_i = x_{i-1} - x_i (x_{-1} = 0).

    Digits in {-1, 0, +1}; nonzero exactly at run boundaries, so long
    runs of ones collapse to two digits - but a uniformly random operand
    averages ~(n+1)/2 boundaries, *denser* than binary's n/2.  NAF
    (`naf_digits`) dominates it on average; this recoder exists because
    the paper names Booth explicitly and run-heavy streams (thermometer
    codes, saturated activations) are its sweet spot.
    """
    assert 0 <= x < (1 << n_bits)
    digits = []
    prev = 0
    for i in range(n_bits):
        cur = (x >> i) & 1
        digits.append(prev - cur)
        prev = cur
    digits.append(prev)                    # d_n = x_{n-1}
    while digits and digits[-1] == 0:
        digits.pop()
    return digits


def naf_digits(x: int) -> List[int]:
    """Canonical (non-adjacent form) signed-digit recoding of x.

    Minimal Hamming weight among {-1, 0, +1} representations: never
    denser than binary, ~n/3 expected nonzero digits vs binary's n/2
    for a uniform n-bit operand.  (`program.booth_digits` is the legacy
    alias.)
    """
    digits = []
    while x:
        if x & 1:
            d = 2 - (x & 3)              # +1 if x%4==1, -1 if x%4==3
            x -= d
        else:
            d = 0
        digits.append(d)
        x >>= 1
    return digits


RECODERS = {
    "naive": naive_digits,
    "booth": booth_radix2_digits,
    "naf": lambda x, n_bits: naf_digits(x),
}
# modes whose digit alphabet includes -1 (need a complement scratch region)
SIGNED_RECODES = frozenset({"booth", "naf"})


def recode_is_signed(recode) -> bool:
    """Whether a recode mode can emit negative digits (callable: assume yes)."""
    return recode in SIGNED_RECODES or callable(recode)


def recode_digits(x: int, n_bits: int, recode: str = "naive") -> List[int]:
    """Digit stream for x under a recoding mode (or a callable recoder)."""
    fn = RECODERS.get(recode, recode)
    if not callable(fn):
        raise_diag(STREAM_RECODE,
                   f"unknown recode mode {recode!r} "
                   f"(have {sorted(RECODERS)})")
    digits = fn(x, n_bits)
    assert sum(d << i for i, d in enumerate(digits)) == x
    return digits


# ---------------------------------------------------------------------------
# the Program IR container
# ---------------------------------------------------------------------------

class Program:
    """An instruction stream as a first-class, optimisable object.

    List-like over `Instr` (append / extend / += / + / iteration), so the
    generator style of `program.py` keeps working, but internally an ordered
    list of *slots*: after `optimize()` a slot may hold two instructions
    that retire in one cycle via the dual write ports.  `len(p)` and
    `p.cycles` count slots, i.e. processing cycles.

    A slot may also be a *symbolic* `StreamSlot` (`StreamMac` /
    `StreamExt`): such a program is a template over outside operands and
    cannot be encoded, cycle-counted, or optimized until
    `specialize_streams` substitutes concrete values - the cycle count
    genuinely depends on the streamed digits.
    """

    __slots__ = ("_slots", "name", "live_out", "_encoded", "_key")

    def __init__(self, instrs: Iterable[Instr] = (), name: str = "prog",
                 live_out: Optional[Iterable[int]] = None):
        self._slots: List[Slot] = [(i,) for i in instrs]
        self.name = name
        self.live_out = frozenset(live_out) if live_out is not None else None
        self._encoded: Optional[np.ndarray] = None
        self._key = None

    # -- construction ------------------------------------------------------
    @classmethod
    def from_slots(cls, slots: Sequence[Slot], name: str = "prog",
                   live_out=None) -> "Program":
        p = cls(name=name, live_out=live_out)
        p._slots = list(slots)
        return p

    def _dirty(self):
        self._encoded = None
        self._key = None

    def append(self, instr: Instr) -> None:
        self._slots.append((instr,))
        self._dirty()

    def append_stream(self, slot: "StreamSlot") -> None:
        """Append a symbolic streamed-operand slot (program turns symbolic)."""
        assert isinstance(slot, StreamSlot)
        self._slots.append(slot)
        self._dirty()

    def extend(self, instrs: Iterable[Instr]) -> None:
        if isinstance(instrs, Program):
            self._slots.extend(instrs._slots)
        else:
            self._slots.extend((i,) for i in instrs)
        self._dirty()

    def __iadd__(self, other) -> "Program":
        self.extend(other)
        return self

    def __add__(self, other) -> "Program":
        p = Program.from_slots(list(self._slots), name=self.name,
                               live_out=self.live_out)
        p.extend(other)
        return p

    def __radd__(self, other) -> "Program":
        p = Program(other if not isinstance(other, Program) else ())
        p.extend(self)
        return p

    # -- inspection --------------------------------------------------------
    def __len__(self) -> int:
        return len(self._slots)

    @property
    def is_symbolic(self) -> bool:
        """True when any slot is a streamed-operand placeholder."""
        return any(isinstance(s, StreamSlot) for s in self._slots)

    def streams(self) -> Tuple[StreamedOperand, ...]:
        """Distinct streamed operands referenced, ordered by index."""
        seen = {}
        for s in self._slots:
            if isinstance(s, StreamSlot):
                seen.setdefault(s.stream.index, s.stream)
        return tuple(seen[i] for i in sorted(seen))

    def _concrete(self, what: str) -> None:
        if self.is_symbolic:
            sym_idx = next(i for i, s in enumerate(self._slots)
                           if isinstance(s, StreamSlot))
            raise_diag(
                SYMBOLIC_SLOT,
                f"cannot {what} a symbolic program ({self.name!r} still "
                f"references streamed operands "
                f"{[s.name for s in self.streams()]}); run "
                f"ir.specialize_streams(program, values) first",
                program=self.name, slot=sym_idx)

    @property
    def cycles(self) -> int:
        self._concrete("cycle-count")
        return len(self._slots)

    @property
    def slots(self) -> Tuple[Slot, ...]:
        return tuple(self._slots)

    def instrs(self) -> List[Instr]:
        """Flattened instruction list in original program order."""
        self._concrete("flatten")
        return [i for slot in self._slots for i in slot]

    def __iter__(self):
        return iter(self.instrs())

    @property
    def n_instrs(self) -> int:
        self._concrete("count instructions of")
        return sum(len(s) for s in self._slots)

    @property
    def is_fused(self) -> bool:
        return any(not isinstance(s, StreamSlot) and len(s) > 1
                   for s in self._slots)

    def with_live_out(self, rows: Iterable[int]) -> "Program":
        """Same program, annotated with the rows observed after it runs."""
        p = Program.from_slots(list(self._slots), name=self.name,
                               live_out=frozenset(rows))
        return p

    def __repr__(self):
        if self.is_symbolic:
            n_sym = sum(1 for s in self._slots if isinstance(s, StreamSlot))
            return (f"Program({self.name!r}: symbolic, {len(self._slots)} "
                    f"slots of which {n_sym} streamed, "
                    f"{len(self.streams())} streams)")
        fused = sum(1 for s in self._slots if len(s) > 1)
        return (f"Program({self.name!r}: {self.n_instrs} instrs in "
                f"{self.cycles} cycles, {fused} co-issued)")

    # -- encode cache ------------------------------------------------------
    @property
    def key(self) -> Tuple:
        """Structural fingerprint: keys the simulator's encode cache."""
        if self._key is None:
            self._key = tuple(self._slots)
        return self._key

    def encode(self) -> np.ndarray:
        """Engine field matrix [cycles, N_ENGINE_FIELDS] (cached)."""
        self._concrete("encode")
        if self._encoded is None:
            if not self._slots:
                self._encoded = np.zeros((0, isa.N_ENGINE_FIELDS), np.int32)
            else:
                self._encoded = np.array(
                    [_slot_vector(s) for s in self._slots], dtype=np.int32)
        return self._encoded

    # -- optimisation ------------------------------------------------------
    def optimize(self, passes: Optional[Sequence] = None,
                 live_out: Optional[Iterable[int]] = None,
                 verify: bool = False) -> "Program":
        """Run the pass pipeline; returns a new, semantically equal Program.

        Default pipeline: constant-row folding -> dead-write elimination
        (needs a live-out annotation to do anything) -> dual-port co-issue.

        With ``verify=True`` every pass is translation-validated: the
        reference interpreter in `verify.py` runs the slots before and
        after the rewrite from seeded random machine states and a
        `VerificationError` (with `pass-footprint` / `pass-value` /
        `pass-latch` diagnostics) refuses the miscompile if the written
        footprint grew or any live-out row or final latch diverged.
        """
        self._concrete("optimize")
        lo = frozenset(live_out) if live_out is not None else self.live_out
        if self.is_fused:
            # already scheduled: the default pipeline operates on unfused
            # slots and re-running it cannot improve the schedule, so the
            # default request is an idempotent no-op.  Explicitly requested
            # passes cannot be honoured on fused slots - fail loudly rather
            # than silently skipping them.
            if passes is not None:
                raise_diag(
                    PASS_STRUCTURE,
                    "cannot run explicit passes on an already-fused "
                    "program; optimize before co-issue scheduling",
                    program=self.name)
            return Program.from_slots(list(self._slots), name=self.name,
                                      live_out=lo)
        if passes is None:
            passes = DEFAULT_PASSES
        slots: List[Slot] = [tuple(s) for s in self._slots]
        for p in passes:
            new_slots = p(slots, live_out=lo)
            if verify:
                from . import verify as _verify  # deferred: verify imports ir
                diags = _verify.validate_pass(
                    slots, new_slots, live_out=lo, name=self.name,
                    pass_name=getattr(p, "__name__", repr(p)))
                errors = [d for d in diags if d.is_error]
                if errors:
                    raise VerificationError(errors)
            slots = new_slots
        return Program.from_slots(slots, name=self.name + "+opt",
                                  live_out=lo)


def concat_programs(programs: Sequence, name: str = "batch",
                    reset_latches: bool = True) -> Program:
    """Concatenate programs into one, isolating latch state at boundaries.

    Carry/mask latch values survive a program's last cycle by design (an
    add's final carry store depends on it), so naive concatenation leaks
    program i's latches into program i+1 - silently wrong for any program
    that predicates on a latch before setting it.  With `reset_latches`
    (the default) a one-cycle `isa.latch_clear` slot is inserted at every
    boundary.  `ComefaArray.run_programs` applies the same boundary
    treatment at the encoded-matrix level (keeping the per-program encode
    caches warm); this IR-level form is for composing multi-phase programs
    that are optimized or inspected as one object.
    """
    out = Program(name=name)
    live = set()
    annotated = True
    for idx, p in enumerate(programs):
        if not isinstance(p, Program):
            items = list(p)
            bad = next((x for x in items if not isinstance(x, Instr)), None)
            if bad is not None:
                raise_diag(
                    CONCAT_INPUT,
                    f"constituent {idx} is not an IR program: contains "
                    f"{type(bad).__name__} (expected isa.Instr elements "
                    f"or an ir.Program)", program=name, slot=idx)
            p = items
        if reset_latches and idx:
            out.append(isa.latch_clear())
        out.extend(p)
        if isinstance(p, Program) and p.live_out is not None:
            live |= p.live_out
        else:
            annotated = False
    if annotated and live:
        # the union keeps dead-write elimination armed on the batch; any
        # unannotated constituent forces the conservative "all rows live"
        out.live_out = frozenset(live)
    return out


# ---------------------------------------------------------------------------
# pass: streamed-operand specialization (Booth/NAF recoding + dead digits)
# ---------------------------------------------------------------------------

def _expand_stream_mac(slot: StreamMac, value: int, recode: str,
                       out: List[Slot], program_name: Optional[str] = None,
                       slot_index: Optional[int] = None) -> None:
    """Concrete instruction slots for one digit-serial MAC.

    Expansion contract (pinned bit-exact against the legacy eager
    generators by tests/test_streams.py):

      * ``recode="naive"``: one `add_into` per *set* bit b - byte-for-byte
        the schedule `program.ooor_dot` used to emit eagerly;
      * signed modes (``"booth"`` / ``"naf"``): one complement of the
        weight into the `neg` scratch iff any digit is negative, then per
        nonzero digit a segment add (+1) or preset-carry complement add
        with sign extension (-1) - byte-for-byte `program.ooor_dot_booth`
        (including its stop at the first digit whose weight segment no
        longer fits the accumulator).
    """
    from . import program as pgen           # deferred: program imports ir
    w, acc = list(slot.weight), list(slot.acc)
    nw = len(w)
    digits = recode_digits(value, slot.stream.n_bits, recode)
    if any(d < 0 for d in digits):
        if slot.stream.digit_set != "signed" or slot.neg is None:
            raise_diag(
                STREAM_DIGITS,
                f"recode={recode!r} produced negative digits but stream "
                f"{slot.stream.name!r} has digit_set="
                f"{slot.stream.digit_set!r} / no neg scratch rows; "
                f"emit the StreamMac with neg rows or use recode='naive'",
                program=program_name, slot=slot_index)
        neg = list(slot.neg)[:nw]
        out.extend(pgen.logic2(w, w, neg, isa.TT_NOT_A)._slots)
    if recode == "naive":
        for off, d in enumerate(digits):
            if d:
                out.extend(pgen.add_into(acc, w, off)._slots)
        return
    for off, d in enumerate(digits):
        if d == 0:
            continue
        if off + nw > len(acc):
            break                            # legacy ooor_dot_booth stop
        if d > 0:
            out.extend(pgen.add_into(acc, w, off)._slots)
        else:
            seg = acc[off:off + nw]
            out.extend(pgen.preset_carry()._slots)
            out.extend(pgen.add(seg, neg, seg, preset=True,
                                store_cout=False)._slots)
            rem = acc[off + nw:]
            if rem:
                out.extend(pgen.add_ext(rem, [1] * len(rem), rem,
                                        store_cout=False,
                                        preset=True)._slots)


def specialize_streams(program: "Program", values: Sequence[int],
                       recode: str = "naive", optimize: bool = False,
                       live_out=None) -> "Program":
    """Substitute concrete values for a program's streamed operands.

    The pass-pipeline stage that turns a symbolic (value-independent)
    program into the value-dependent schedule the FSM would actually
    emit: every `StreamExt` gets its concrete broadcast bit, and every
    `StreamMac` expands into adds for the *nonzero digits* of the
    recoded value only (dead-digit elimination - the paper's OOOR
    zero-bit skipping, plus Booth/NAF signed-digit recoding when
    ``recode`` selects it).

    `values[i]` feeds every slot whose stream has ``index == i``.
    Concrete slots pass through untouched, so specialization composes
    with already-lowered prefixes (accumulator zeroing, shifts).  With
    ``optimize=True`` the result additionally folds through the default
    pass pipeline (constant-row folding, dead-write elimination,
    dual-port co-issue) so recoded add passes still pick up W2 riders.
    """
    if not isinstance(program, Program):
        program = Program(program)
    streams = program.streams()
    if streams and streams[-1].index >= len(values):
        raise_diag(
            STREAM_MISSING,
            f"program references stream index {streams[-1].index} but "
            f"only {len(values)} values were supplied",
            program=program.name)
    for s in streams:
        v = int(values[s.index])
        if not 0 <= v < (1 << s.n_bits):
            raise_diag(STREAM_RANGE,
                       f"value {v} out of range for {s.n_bits}-bit "
                       f"stream {s.name!r}", program=program.name)
    out: List[Slot] = []
    for slot_index, slot in enumerate(program._slots):
        if isinstance(slot, StreamMac):
            _expand_stream_mac(slot, int(values[slot.stream.index]),
                               recode, out, program_name=program.name,
                               slot_index=slot_index)
        elif isinstance(slot, StreamExt):
            bit = (int(values[slot.stream.index]) >> slot.bit) & 1
            out.append((dataclasses.replace(slot.instr, ext_bit=bit),))
        else:
            out.append(slot)
    lo = live_out if live_out is not None else program.live_out
    p = Program.from_slots(out, name=f"{program.name}@{recode}",
                           live_out=lo)
    return p.optimize() if optimize else p


def _slot_vector(slot: Slot) -> List[int]:
    """Merge a slot's 1-2 instructions into one engine field vector."""
    if len(slot) == 1:
        return slot[0].engine_vector()
    a, b = slot
    w = a if (a.wp2_en and not a.wp1_en) else b       # the W2 side
    c = b if w is a else a                            # the compute/W1 side
    v = c.engine_vector()
    names = isa.ENGINE_FIELD_NAMES
    v[names.index("wp2_en")] = 1
    v[names.index("w2_sel")] = (W2_ZERO if (w.w2_sel == W2_CARRY and w.c_rst)
                                else w.w2_sel)
    v[names.index("dst2_row")] = w.dst_row
    v[names.index("pred2_sel")] = w.pred_sel
    return v


# ---------------------------------------------------------------------------
# pass: constant-row folding
# ---------------------------------------------------------------------------

def fold_constant_rows(slots: List[Slot], live_out=None) -> List[Slot]:
    """Fold reads of known-constant rows into the instruction itself.

    Tracks row constants through the program, seeded with the reserved
    all-zeros / all-ones rows the array initialises at reset:
      * a Port-B read of a constant row becomes an `ext_bit` broadcast
        (freeing Port B - the OOOR mechanism of Sec. III-I used as a
        compiler canonicalisation);
      * a Port-A read of a constant row is swapped to Port B first (the PE's
        truth table is re-indexed; CGEN is symmetric) then folded the same
        way, and the truth table is specialised - `copy ROW_ONES` becomes a
        read-free TT_ONE write, `copy ROW_ZEROS` a TT_ZERO write (which the
        co-issue pass can retarget onto Port B);
      * a write of a constant a row is already known to hold is dropped.
    """
    known: Dict[int, int] = {ROW_ZEROS: 0, ROW_ONES: 1}
    out: List[Slot] = []
    for slot in slots:
        if len(slot) != 1:
            raise ValueError("fold_constant_rows must run before co-issue")
        i = slot[0]
        uses_a = i.c_en or _tt_uses_a(i.truth_table)
        uses_b = i.c_en or _tt_uses_b(i.truth_table)
        # swap a constant A operand onto the B port when B's port is live
        if (uses_a and i.src1_row in known and not i.b_ext
                and not (uses_b and i.src2_row in known) and i.c_en == 0
                and i.w1_sel != W1_RIGHT):
            i = dataclasses.replace(i, src1_row=i.src2_row,
                                    src2_row=i.src1_row,
                                    truth_table=_tt_swap_ab(i.truth_table))
            uses_a, uses_b = uses_b, uses_a
        # fold a constant B operand into the ext-bit broadcast
        if uses_b and not i.b_ext and i.src2_row in known:
            i = dataclasses.replace(i, b_ext=1, ext_bit=known[i.src2_row])
        # specialise the truth table against the (now ext) constant B
        if i.b_ext and i.c_en == 0 and _tt_uses_b(i.truth_table):
            i = dataclasses.replace(
                i, truth_table=_tt_fix_b(i.truth_table, i.ext_bit))
        # constant tracking + redundant-write elimination
        val = _written_const(i)
        wrote = instr_effects(i).writes
        if (val is not None and known.get(i.dst_row) == val
                and i.c_en == 0 and i.m_en == 0
                and i.pred_sel == PRED_ALWAYS):
            continue                                   # row already holds it
        for r in wrote:
            known.pop(r, None)
        if val is not None and i.pred_sel == PRED_ALWAYS:
            known[i.dst_row] = val
        out.append((i,))
    return out


def _written_const(i: Instr) -> Optional[int]:
    """The constant this instruction writes to dst_row, if provable."""
    if i.wp1_en and not i.wp2_en and i.w1_sel == W1_S and i.c_rst:
        if i.truth_table == TT_ZERO:
            return 0
        if i.truth_table == TT_ONE:
            return 1
    if i.wp2_en and not i.wp1_en:
        if i.w2_sel == W2_ZERO or (i.w2_sel == W2_CARRY and i.c_rst):
            return 0
    return None


# ---------------------------------------------------------------------------
# pass: dead-write elimination
# ---------------------------------------------------------------------------

def eliminate_dead_writes(slots: List[Slot], live_out=None) -> List[Slot]:
    """Remove writes to rows that are overwritten (or never observed) before
    any read.  A no-op without a live-out annotation: program exit state is
    observable through the memory-mode ports, so every row is live at exit
    unless the program says otherwise.
    """
    if live_out is None:
        return slots
    live = set(live_out) | {ROW_ZEROS, ROW_ONES}
    out_rev: List[Slot] = []
    for slot in reversed(slots):
        if len(slot) != 1:
            raise ValueError("eliminate_dead_writes must run before co-issue")
        i = slot[0]
        eff = instr_effects(i)
        if eff.writes and not (eff.writes & live):
            if eff.writes_carry or eff.writes_mask:
                # keep the latch update, drop the dead row write
                i = dataclasses.replace(i, wp1_en=0, wp2_en=0)
                eff = instr_effects(i)
            else:
                continue
        live -= eff.full_writes
        live |= eff.reads
        out_rev.append((i,))
    return list(reversed(out_rev))


# ---------------------------------------------------------------------------
# pass: dual-port write co-issue
# ---------------------------------------------------------------------------

def _w2_side_ok(w: Instr) -> bool:
    """Can `w` ride along on Port B of another cycle?

    It must write only through W2, from a source needing no row read
    (the latched carry, or constant zero), and must not update a latch.
    """
    return (w.wp2_en == 1 and w.wp1_en == 0 and w.c_en == 0 and w.m_en == 0
            and (w.w2_sel == W2_CARRY or w.w2_sel == W2_ZERO))


def _as_w2_zero(i: Instr) -> Optional[Instr]:
    """Rewrite a W1 zero-write as an equivalent Port-B W2_ZERO write."""
    if (i.wp1_en == 1 and i.wp2_en == 0 and i.w1_sel == W1_S
            and i.truth_table == TT_ZERO and i.c_rst == 1
            and i.c_en == 0 and i.m_en == 0):
        return Instr(dst_row=i.dst_row, wp2_en=1, w2_sel=W2_ZERO,
                     pred_sel=i.pred_sel)
    return None


def _can_fuse(first: Instr, second: Instr) -> bool:
    """Is fusing adjacent (first; second) into one cycle sound?

    Exactly one of the pair must be a free-riding W2 write (`_w2_side_ok`);
    the other (the compute side C) keeps the PE, latches, and Port A.
    Soundness conditions per direction are derived in docs/program_ir.md.
    """
    for w, c, w_first in ((first, second, True), (second, first, False)):
        if not _w2_side_ok(w) or c.wp2_en:
            continue
        w_reads_carry = w.w2_sel == W2_CARRY and not w.c_rst
        if w_first:
            # W originally ran first: it saw pre-cycle latches (engine
            # semantics match exactly); C must not observe W's write.
            c_eff = instr_effects(c)
            if w.dst_row in c_eff.reads:
                continue
            if c.wp1_en and c.dst_row == w.dst_row:
                continue                      # write order would flip
        else:
            # W originally ran second: C must not change what W observes.
            if w_reads_carry and c.c_en:
                continue
            if w.pred_sel == PRED_MASK and c.m_en:
                continue
            if (w.pred_sel in (PRED_CARRY, PRED_NOT_CARRY)) and c.c_en:
                continue
        return True
    return False


def _port_write_race(c: Instr, w: Instr) -> bool:
    """Would fusing compute `c` with W2 rider `w` race on a row?

    The simulator retires W1 before W2, so a same-row fusion is
    *simulator*-deterministic - but on a true-dual-port BRAM two ports
    writing one address in one cycle is undefined unless the write
    enables cannot both assert.  The only lane-disjoint predicate pair
    the ISA can express is {PRED_CARRY, PRED_NOT_CARRY} (the select /
    restoring-division pattern); any other same-row combination can
    double-drive a cell and is rejected by the scheduler and flagged
    `port-race` by the verifier.
    """
    if not c.wp1_en or c.dst_row != w.dst_row:
        return False
    return {c.pred_sel, w.pred_sel} != {PRED_CARRY, PRED_NOT_CARRY}


# lookahead bound for the co-issue list scheduler: far enough to clear a
# typical add/ripple sequence, small enough to keep the pass linear-ish
COISSUE_WINDOW = 16


def _hoistable(w: Instr, rows_read, rows_written,
               carry_dirty: bool, mask_dirty: bool) -> bool:
    """Can W's write legally move back past the scanned instructions?

    W is a free-riding Port-B write (`_w2_side_ok`).  Hoisting it into an
    earlier host cycle is sound iff nothing between the host and W's
    original slot (host included, for the latch conditions) observes the
    move:

      * no intervening instruction reads W's destination row (it would
        see the new value early) or writes it (the final value would
        flip from W's to the intervening write's);
      * W's data source and predicate sample the latches at the *host*
        cycle's start, so no instruction from the host up to W's
        original slot may update a latch W observes (`c_en` vs a
        `W2_CARRY` source or a carry predicate, `m_en` vs `PRED_MASK`).
    """
    if w.dst_row in rows_read or w.dst_row in rows_written:
        return False
    reads_carry = ((w.w2_sel == W2_CARRY and not w.c_rst)
                   or w.pred_sel in (PRED_CARRY, PRED_NOT_CARRY))
    if reads_carry and carry_dirty:
        return False
    if w.pred_sel == PRED_MASK and mask_dirty:
        return False
    return True


def coissue_dual_port(slots: List[Slot], live_out=None,
                      window: int = COISSUE_WINDOW) -> List[Slot]:
    """List-scheduling packer of independent W1/W2 writes.

    Walks the program left to right.  A cycle whose Port-B write path is
    idle becomes a *host*: the scheduler scans up to `window` following
    instructions for the first free-riding Port-B write - a carry store,
    a `W2_ZERO` clear, or a `TT_ZERO` W1 clear rewritable onto Port B
    (`_as_w2_zero`) - that can soundly retire in the host's cycle
    (`_hoistable`), and fuses the pair.  Adjacent pairs are the
    distance-1 special case (the seed pass); the lookahead additionally
    hoists W2 writes *across* non-conflicting instructions whose own
    Port B is busy (shifts, other carry stores) - the ROADMAP
    "co-issue beyond adjacent pairs" list-scheduling variant.

    An instruction that is itself a Port-B write can also ride on the
    *next* instruction's cycle (the W-first direction of `_can_fuse`):
    its sources sample pre-cycle latches either way, so the engine
    semantics match the original order exactly.

    TT_ZERO row clears are retargeted onto Port B so zero/copy-heavy
    sequences - operand clears, predicated select patterns, multiplier
    partial-product initialisation - pack two rows per cycle.
    """
    instrs: List[Instr] = []
    for slot in slots:
        if len(slot) != 1:
            raise ValueError("coissue_dual_port must run on unfused slots")
        instrs.append(slot[0])
    n = len(instrs)
    effs = [instr_effects(ins) for ins in instrs]
    riders = [ins if _w2_side_ok(ins) else _as_w2_zero(ins)
              for ins in instrs]
    consumed = [False] * n
    out: List[Slot] = []
    for i in range(n):
        if consumed[i]:
            continue
        x = instrs[i]
        fused = False
        if not x.wp2_en:
            # host candidate: scan the window for a hoistable W2 rider
            rows_read: set = set()
            rows_written: set = set()
            carry_dirty = bool(x.c_en)
            mask_dirty = bool(x.m_en)
            scanned = 0
            j = i + 1
            while j < n and scanned < window:
                if consumed[j]:
                    j += 1
                    continue
                w = riders[j]
                if (w is not None and not _port_write_race(x, w)
                        and _hoistable(w, rows_read, rows_written,
                                       carry_dirty, mask_dirty)):
                    out.append((x, w))
                    consumed[j] = True
                    fused = True
                    break
                eff = effs[j]
                rows_read |= eff.reads
                rows_written |= eff.writes
                carry_dirty |= eff.writes_carry
                mask_dirty |= eff.writes_mask
                scanned += 1
                j += 1
        if not fused:
            # W-first direction: x (a Port-B write) rides on the next
            # instruction's cycle
            j = i + 1
            while j < n and consumed[j]:
                j += 1
            if j < n:
                y = instrs[j]
                x2 = riders[i]
                if x2 is not None and _can_fuse(x2, y):
                    out.append((x2, y))
                    consumed[j] = True
                    fused = True
        if not fused:
            out.append((x,))
    return out


DEFAULT_PASSES = (fold_constant_rows, eliminate_dead_writes,
                  coissue_dual_port)


def optimize(program, live_out=None, verify: bool = False) -> Program:
    """Convenience: lift a raw instruction list to IR and optimise it.

    ``verify=True`` translation-validates every pass (see
    `Program.optimize`) and refuses a miscompile with a structured
    `VerificationError`.
    """
    if not isinstance(program, Program):
        program = Program(program)
    return program.optimize(live_out=live_out, verify=verify)
