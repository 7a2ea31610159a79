"""Static program verifier + miscompile detector for the CoMeFa IR.

The IR stack rewrites programs aggressively — constant-row folding,
dead-write elimination, a windowed dual-port co-issue scheduler, and
per-value stream specialization — and a silent write–write race or seam
misuse produces plausible-but-wrong bits.  This module turns the
invariants those passes rely on into checked properties:

  static hazard analysis (`verify_program` / `verify_batch`)
    * **dual-port hazards**: same-cycle W1/W2 writes to one row whose
      write drivers can overlap (undefined on true-dual-port BRAM), and
      fused slots whose Port-B side is not a legal free-riding W2 write;
    * **resource legality**: no writes into the reserved constant rows
      (`isa.RESERVED_ROWS`) that the fold pass and `ComefaArray.reset`
      treat as immutable; lane shifts flagged when the run context is an
      unchained multi-block array (seam lanes would shift in zeros);
    * **latch dataflow**: reads of the carry/mask latches before any
      in-scope write — an error when the program's inbound latch state
      is unknown (`clear_latches=False`), a boundary *warning* when
      programs are concatenated with ``reset_latches=False`` (PR 2's
      latch-leak class); symbolic `StreamMac`/`StreamExt` slots that
      would reach the encoder unspecialized.

  plan/schedule legality (`verify_plan` / `verify_schedule`)
    * `GemmPlan`/`GemvPlan` row regions pairwise disjoint and outside
      the reserved rows; `Schedule` timelines re-checked against the
      engine-serialization and double-buffer-lag recurrence.

  translation validation (`validate_pass` / `ir.optimize(verify=True)`)
    * a bit-level dataflow interpreter (pure numpy, independent of the
      torch engines) runs the program before and after each optimizer
      pass from seeded random states and refuses the rewrite unless the
      written-row footprint shrank-or-held and every live-out row plus
      the final latch state is bit-identical.  Passes are lane-uniform
      (they rewrite rows, predicates and latch plumbing, never lane
      indices), so equivalence on a small-lane model implies
      equivalence at the physical 160-lane geometry.

Every finding is a `diagnostics.Diagnostic` (stable code, program name,
slot index, rows, severity); `ir.optimize(verify=True)` and the
``REPRO_TORCH_COMEFA_VERIFY=1`` pre-encode hook in `block.encoded` raise
`VerificationError` on error-severity findings.

CLI::

    python -m repro_torch.core.comefa.verify [--all | --selftest] [-v]

sweeps every generator program and planner tile program in the repo
(including per-recode stream specializations, cross-checked for value
equivalence) and runs the mutation self-tests (seeded hazard injection
must be caught).  CI runs ``--all`` as a tier-1 step.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from . import ir, isa
from ...obs import trace as obs_trace
from .diagnostics import (BUFFER_LAG, ERROR, PASS_FOOTPRINT, PASS_LATCH,
                          PASS_VALUE, PHASE_ORDER, PORT_RACE, REGION_OVERLAP,
                          REGION_RESERVED, RESERVED_WRITE, SEAM_SHIFT,
                          SLOT_STRUCTURE, STALE_LATCH, SYMBOLIC_SLOT,
                          WARNING, Diagnostic, VerificationError)
from .isa import (N_ROWS, PRED_CARRY, RESERVED_ROWS, ROW_ONES, ROW_ZEROS,
                  W1_RIGHT, W2_LEFT)

__all__ = [
    "Diagnostic", "VerificationError",
    "verify_program", "verify_batch", "assert_verified",
    "verify_plan", "verify_schedule",
    "written_rows", "run_reference", "validate_pass",
    "validate_specialization", "maybe_verify", "maybe_verify_batch",
    "verify_enabled", "main",
]


# ---------------------------------------------------------------------------
# slot-level static hazard analysis
# ---------------------------------------------------------------------------

def _as_slots(program) -> Tuple[List, str]:
    """(slot list, name) from a Program, an Instr iterable, or slots."""
    if isinstance(program, ir.Program):
        return list(program.slots), program.name
    slots = []
    for item in program:
        if isinstance(item, isa.Instr):
            slots.append((item,))
        else:
            slots.append(tuple(item) if not isinstance(item, ir.StreamSlot)
                         else item)
    return slots, "prog"


def _rider_side(slot: Tuple[isa.Instr, ...]) -> Optional[isa.Instr]:
    """The W2 free-rider of a fused slot, per `ir._slot_vector`'s merge."""
    a, b = slot
    return a if (a.wp2_en and not a.wp1_en) else b


def _is_shift(i: isa.Instr) -> bool:
    return ((i.wp1_en and i.w1_sel == W1_RIGHT)
            or (i.wp2_en and i.w2_sel == W2_LEFT))


def verify_program(program, *, name: Optional[str] = None, n_blocks: int = 1,
                   chain: bool = True, clear_latches: bool = True,
                   stale_severity: str = ERROR) -> List[Diagnostic]:
    """Static hazard scan of one program.  Returns all findings.

    Context parameters describe the array the program will run on:
    `n_blocks`/`chain` arm the seam-shift check (a lane shift on an
    unchained multi-block array feeds zeros across every block seam),
    and `clear_latches` declares whether the carry/mask latches are
    known-cleared on entry (true after `ComefaArray.reset()` or a
    `run_programs` boundary) — when False, any latch read before an
    in-program write reports `stale-latch`.
    """
    slots, default_name = _as_slots(program)
    pname = name if name is not None else default_name
    diags: List[Diagnostic] = []
    carry_ok = clear_latches        # latch value is defined at this point
    mask_ok = clear_latches

    def emit(code, msg, *, slot=None, rows=(), severity=ERROR):
        diags.append(Diagnostic(code=code, message=msg, severity=severity,
                                program=pname, slot=slot, rows=tuple(rows)))

    for idx, slot in enumerate(slots):
        if isinstance(slot, ir.StreamSlot):
            stream = slot.stream
            emit(SYMBOLIC_SLOT,
                 f"symbolic {type(slot).__name__} over stream "
                 f"{stream.name!r} (index {stream.index}) cannot be "
                 f"encoded; run ir.specialize_streams first", slot=idx)
            continue
        instrs = tuple(slot)
        compute, rider = instrs[0], None
        if len(instrs) == 2:
            rider = _rider_side(slot)
            compute = instrs[0] if rider is instrs[1] else instrs[1]
            if not ir._w2_side_ok(rider) or compute.wp2_en:
                emit(SLOT_STRUCTURE,
                     "fused slot is not (compute, W2 free-rider): the "
                     "rider must write only through Port B from the "
                     "latched carry or constant zero, without latch "
                     "updates", slot=idx)
                rider = None          # port analysis would be meaningless
        elif len(instrs) != 1:
            emit(SLOT_STRUCTURE, f"slot holds {len(instrs)} instructions; "
                 "a cycle retires at most two (one per write port)",
                 slot=idx)
            continue
        # --- dual-port write hazards ---------------------------------
        if rider is not None and ir._port_write_race(compute, rider):
            emit(PORT_RACE,
                 f"W1 and W2 both write row {rider.dst_row} in one cycle "
                 f"with overlapping write drivers (pred {compute.pred_sel} "
                 f"vs {rider.pred_sel}): undefined on true-dual-port BRAM",
                 slot=idx, rows=(rider.dst_row,))
        if len(instrs) == 1 and compute.wp1_en and compute.wp2_en:
            emit(PORT_RACE,
                 f"single instruction drives both write ports into row "
                 f"{compute.dst_row}; the W1 and W2 data paths can carry "
                 f"different values", slot=idx, rows=(compute.dst_row,))
        # --- resource legality ----------------------------------------
        for i in instrs:
            bad = ir.instr_effects(i).writes & set(RESERVED_ROWS)
            if bad:
                emit(RESERVED_WRITE,
                     "write targets the reserved constant row(s) the "
                     "fold pass and reset() rely on", slot=idx, rows=bad)
        if n_blocks > 1 and not chain and any(_is_shift(i) for i in instrs):
            emit(SEAM_SHIFT,
                 f"lane shift on an unchained {n_blocks}-block array: "
                 "block-seam lanes shift in zeros, cross-block data is "
                 "lost", slot=idx, severity=WARNING)
        # --- latch dataflow (reads sample pre-cycle latch state) ------
        for i in instrs:
            eff = ir.instr_effects(i)
            if eff.reads_carry and not carry_ok:
                emit(STALE_LATCH,
                     "reads the carry latch before any in-scope write: "
                     "the value is whatever the previous program left "
                     "latched", slot=idx, severity=stale_severity)
                carry_ok = True       # report each latch once per program
            if eff.reads_mask and not mask_ok:
                emit(STALE_LATCH,
                     "reads the mask latch before any in-scope write: "
                     "the value is whatever the previous program left "
                     "latched", slot=idx, severity=stale_severity)
                mask_ok = True
        for i in instrs:
            eff = ir.instr_effects(i)
            carry_ok = carry_ok or eff.writes_carry
            mask_ok = mask_ok or eff.writes_mask
    return diags


def verify_batch(programs: Sequence, *, reset_latches: bool = True,
                 n_blocks: int = 1, chain: bool = True,
                 clear_latches: bool = True) -> List[Diagnostic]:
    """Hazard scan of a `run_programs` batch, with boundary semantics.

    With ``reset_latches`` every program starts from cleared latches
    (the inserted `isa.latch_clear` boundary).  Without it, program i+1
    inherits program i's final latch state: a latch read before an
    in-program write is then flagged `stale-latch` at *warning*
    severity — deliberate latch threading is the documented use of
    ``reset_latches=False``, but the PR-2 latch-leak bug is exactly
    this pattern appearing by accident.
    """
    diags: List[Diagnostic] = []
    for idx, p in enumerate(programs):
        boundary_clear = reset_latches or (idx == 0 and clear_latches)
        diags.extend(verify_program(
            p, n_blocks=n_blocks, chain=chain,
            clear_latches=boundary_clear,
            stale_severity=ERROR if boundary_clear else WARNING))
    return diags


def assert_verified(program, **context) -> None:
    """Raise `VerificationError` on any error-severity finding."""
    errors = [d for d in verify_program(program, **context) if d.is_error]
    if errors:
        raise VerificationError(errors)


# ---------------------------------------------------------------------------
# plan / schedule legality
# ---------------------------------------------------------------------------

def _plan_regions(plan) -> List[Tuple[str, Tuple[int, ...]]]:
    """Named row regions of a GemmPlan or GemvPlan (duck-typed)."""
    regions: List[Tuple[str, Tuple[int, ...]]] = []
    if hasattr(plan, "scratch"):                     # GemmPlan
        for buf in plan.buffers:
            regions += [(f"x{buf.index}", tuple(buf.x)),
                        (f"y{buf.index}", tuple(buf.y)),
                        (f"acc{buf.index}", tuple(buf.acc))]
        regions.append(("scratch", tuple(plan.scratch)))
    else:                                            # GemvPlan
        for buf in plan.buffers:
            regions.append((f"wbuf{buf.index}", tuple(buf.rows)))
        regions.append(("acc", tuple(plan.acc)))
        if plan.neg is not None:
            regions.append(("neg", tuple(plan.neg)))
    return regions


def verify_plan(plan, *, name: Optional[str] = None) -> List[Diagnostic]:
    """Row-region legality of a tiling plan.

    The `RowAllocator` guarantees disjoint, reserved-free regions at
    construction; this re-derives both properties from the plan object
    itself, so a hand-built or mutated plan (or an allocator bug) is
    caught before its row indices reach a program generator.
    """
    pname = name if name is not None else type(plan).__name__
    regions = _plan_regions(plan)
    diags: List[Diagnostic] = []
    for i, (name_a, rows_a) in enumerate(regions):
        dup = {r for r in rows_a if rows_a.count(r) > 1}
        if dup:
            diags.append(Diagnostic(
                code=REGION_OVERLAP, program=pname, rows=dup,
                message=f"region {name_a} lists row(s) more than once"))
        for name_b, rows_b in regions[i + 1:]:
            common = set(rows_a) & set(rows_b)
            if common:
                diags.append(Diagnostic(
                    code=REGION_OVERLAP, program=pname, rows=common,
                    message=f"regions {name_a} and {name_b} overlap: "
                            f"double-buffered phases would clobber each "
                            f"other"))
        bad = {r for r in rows_a
               if r in RESERVED_ROWS or not 0 <= r < N_ROWS}
        if bad:
            diags.append(Diagnostic(
                code=REGION_RESERVED, program=pname, rows=bad,
                message=f"region {name_a} includes reserved or "
                        f"out-of-range rows"))
    return diags


def verify_schedule(sched) -> List[Diagnostic]:
    """Re-check a `Schedule` timeline against the pipeline invariants.

    Independent of `Schedule.timeline()`'s recurrence: each engine
    (load port / PE / unload port) must run one tile at a time in tile
    order, a tile's phases must not overlap each other, and row-region
    reuse must respect the ``n_buffers`` double-buffering lag — tile
    t's load may not start before tile t-lag's compute released the
    operand buffer, nor its compute before t-lag's unload released the
    result buffer.
    """
    spans = {(s.tile, s.kind): s for s in sched.timeline()}
    lag = sched.n_buffers
    diags: List[Diagnostic] = []

    def emit(code, msg, tile):
        diags.append(Diagnostic(code=code, message=msg,
                                program=sched.name, slot=tile))

    for t in range(sched.n_tiles):
        load = spans[(t, "load")]
        comp = spans[(t, "compute")]
        unl = spans[(t, "unload")]
        if not (load.end <= comp.start and comp.end <= unl.start):
            emit(PHASE_ORDER, f"tile {t} phases overlap: load ends "
                 f"{load.end}, compute {comp.start}..{comp.end}, unload "
                 f"starts {unl.start}", t)
        if t >= 1:
            for kind in ("load", "compute", "unload"):
                if spans[(t, kind)].start < spans[(t - 1, kind)].end:
                    emit(PHASE_ORDER,
                         f"tile {t} {kind} starts before tile {t - 1} "
                         f"{kind} finished: one engine, one tile at a "
                         f"time", t)
        if t >= lag:
            if load.start < spans[(t - lag, "compute")].end:
                emit(BUFFER_LAG,
                     f"tile {t} load reuses the operand buffer at cycle "
                     f"{load.start}, before tile {t - lag}'s compute "
                     f"released it at {spans[(t - lag, 'compute')].end}", t)
            if comp.start < spans[(t - lag, "unload")].end:
                emit(BUFFER_LAG,
                     f"tile {t} compute reuses the result buffer at cycle "
                     f"{comp.start}, before tile {t - lag}'s unload "
                     f"released it at {spans[(t - lag, 'unload')].end}", t)
    return diags


# ---------------------------------------------------------------------------
# translation validation: reference interpreter + pass equivalence
# ---------------------------------------------------------------------------

_F = {n: i for i, n in enumerate(isa.ENGINE_FIELD_NAMES)}


def _encode_slots(slots) -> np.ndarray:
    if not slots:
        return np.zeros((0, isa.N_ENGINE_FIELDS), np.int64)
    return np.array([ir._slot_vector(tuple(s)) for s in slots], np.int64)


def run_reference(slots, mem: np.ndarray, carry: np.ndarray,
                  mask: np.ndarray, chain: bool = True):
    """Pure-numpy reference interpreter over the engine field matrix.

    Mirrors `block._step` cycle-for-cycle (predication from *latched*
    values, W2 carry source is the raw pre-update latch, W1 write-back
    before W2) but shares no code with the torch engines — this is the
    independent semantics the translation validator trusts.  State
    shapes: ``mem[nb, N_ROWS, lanes]``, ``carry/mask[nb, lanes]``.
    Returns new state; inputs are not mutated.
    """
    mem = mem.astype(np.uint8).copy()
    carry = carry.astype(np.uint8).copy()
    mask = mask.astype(np.uint8).copy()
    ones = np.ones_like(mask)
    zeros_latch = np.zeros_like(carry)

    def pred(sel):
        if sel == isa.PRED_ALWAYS:
            return ones
        if sel == isa.PRED_MASK:
            return mask
        if sel == isa.PRED_CARRY:
            return carry
        return 1 - carry

    for f in np.asarray(_encode_slots(slots), dtype=np.int64):
        a = mem[:, f[_F["src1_row"]], :]
        if f[_F["b_ext"]]:
            b = np.full_like(a, f[_F["ext_bit"]])
        else:
            b = mem[:, f[_F["src2_row"]], :]
        idx = (a.astype(np.int64) << 1) | b
        tr = ((f[_F["truth_table"]] >> idx) & 1).astype(np.uint8)
        c_in = zeros_latch if f[_F["c_rst"]] else carry
        s = tr ^ c_in
        cgen = (a & b) | (c_in & (a ^ b))
        # shifts take the neighbour's S; chain flattens the (nb, lanes)
        # axes so corner PEs thread across block seams
        flat = s.reshape(-1) if chain else s
        from_right = np.zeros_like(flat)
        from_left = np.zeros_like(flat)
        from_right[..., :-1] = flat[..., 1:]
        from_left[..., 1:] = flat[..., :-1]
        if chain:
            from_right = from_right.reshape(s.shape)
            from_left = from_left.reshape(s.shape)
        w1_sel, w2_sel = f[_F["w1_sel"]], f[_F["w2_sel"]]
        val1 = (s if w1_sel == isa.W1_S
                else from_right if w1_sel == isa.W1_RIGHT
                else np.zeros_like(s))
        val2 = (carry if w2_sel == isa.W2_CARRY
                else from_left if w2_sel == isa.W2_LEFT
                else np.zeros_like(s))
        we1 = pred(f[_F["pred_sel"]]) if f[_F["wp1_en"]] else None
        we2 = pred(f[_F["pred2_sel"]]) if f[_F["wp2_en"]] else None
        carry = cgen if f[_F["c_en"]] else carry
        mask = tr if f[_F["m_en"]] else mask
        if we1 is not None:
            dst = f[_F["dst_row"]]
            mem[:, dst, :] = np.where(we1 == 1, val1, mem[:, dst, :])
        if we2 is not None:
            dst2 = f[_F["dst2_row"]]
            mem[:, dst2, :] = np.where(we2 == 1, val2, mem[:, dst2, :])
    return mem, carry, mask


def written_rows(slots) -> frozenset:
    """Union of may-written rows over a concrete slot list."""
    rows: set = set()
    for slot in slots:
        if isinstance(slot, ir.StreamSlot):
            raise VerificationError(Diagnostic(
                code=SYMBOLIC_SLOT,
                message="footprint of a symbolic slot is value-dependent; "
                        "specialize before validation"))
        for i in slot:
            rows |= ir.instr_effects(i).writes
    return frozenset(rows)


def _random_states(n_blocks: int, lanes: int, trials: int, seed: int):
    """Seeded random machine states honouring the reserved-row invariant."""
    rng = np.random.default_rng(seed)
    for _ in range(trials):
        mem = rng.integers(0, 2, (n_blocks, N_ROWS, lanes), dtype=np.uint8)
        mem[:, ROW_ZEROS, :] = 0
        mem[:, ROW_ONES, :] = 1
        carry = rng.integers(0, 2, (n_blocks, lanes), dtype=np.uint8)
        mask = rng.integers(0, 2, (n_blocks, lanes), dtype=np.uint8)
        yield mem, carry, mask


def validate_pass(before, after, *, live_out=None, name: str = "prog",
                  pass_name: str = "pass", n_blocks: int = 2,
                  lanes: int = 8, trials: int = 2, seed: int = 0,
                  chain: bool = True) -> List[Diagnostic]:
    """Translation validation of one rewrite: `before` slots -> `after`.

    Refuses the rewrite unless (a) the written-row footprint did not
    grow, and (b) from every seeded random start state the live-out
    rows (all rows when `live_out` is None — only dead-write
    elimination may perturb non-live rows, and it is inert without an
    annotation) and the final carry/mask latches are bit-identical.
    """
    diags: List[Diagnostic] = []
    extra = written_rows(after) - written_rows(before)
    if extra:
        diags.append(Diagnostic(
            code=PASS_FOOTPRINT, program=name, rows=extra,
            message=f"pass {pass_name!r} grew the written-row footprint: "
                    f"the rewritten program writes rows the original "
                    f"never touched"))
    check_rows = (sorted(live_out) if live_out is not None
                  else list(range(N_ROWS)))
    for mem, carry, mask in _random_states(n_blocks, lanes, trials, seed):
        mem_b, carry_b, mask_b = run_reference(before, mem, carry, mask,
                                               chain=chain)
        mem_a, carry_a, mask_a = run_reference(after, mem, carry, mask,
                                               chain=chain)
        bad = [r for r in check_rows
               if not np.array_equal(mem_b[:, r, :], mem_a[:, r, :])]
        if bad:
            diags.append(Diagnostic(
                code=PASS_VALUE, program=name, rows=bad,
                message=f"pass {pass_name!r} changed live-out row values "
                        f"(caught by the reference interpreter on a "
                        f"seeded random state)"))
        if (not np.array_equal(carry_b, carry_a)
                or not np.array_equal(mask_b, mask_a)):
            diags.append(Diagnostic(
                code=PASS_LATCH, program=name,
                message=f"pass {pass_name!r} changed the final carry/mask "
                        f"latch state: a following program predicated on "
                        f"a latch would diverge"))
        if diags:
            break                      # one failing state is proof enough
    return diags


def validate_specialization(symbolic, values: Sequence[int], *,
                            live_out: Iterable[int],
                            recodes: Sequence[str] = ("naive", "booth",
                                                      "naf"),
                            n_blocks: int = 1, lanes: int = 8,
                            trials: int = 2, seed: int = 0,
                            name: Optional[str] = None) -> List[Diagnostic]:
    """Cross-recode translation validation of `ir.specialize_streams`.

    Every digit recoding of the same symbolic template must agree on
    the live-out rows (the accumulator): the first recode is the
    reference, every other one is interpreted from the same seeded
    states and compared.  Scratch rows (e.g. the signed-recode `neg`
    region) are deliberately excluded — they are where the schedules
    legitimately differ.
    """
    pname = name if name is not None else getattr(symbolic, "name", "prog")
    progs = {r: ir.specialize_streams(symbolic, list(values), recode=r)
             for r in recodes}
    ref_recode = recodes[0]
    rows = sorted(live_out)
    diags: List[Diagnostic] = []
    for mem, carry, mask in _random_states(n_blocks, lanes, trials, seed):
        ref_mem, _, _ = run_reference(progs[ref_recode].slots, mem, carry,
                                      mask)
        for r in recodes[1:]:
            got_mem, _, _ = run_reference(progs[r].slots, mem, carry, mask)
            bad = [row for row in rows
                   if not np.array_equal(ref_mem[:, row, :],
                                         got_mem[:, row, :])]
            if bad:
                diags.append(Diagnostic(
                    code=PASS_VALUE, program=pname, rows=bad,
                    message=f"specialization recode={r!r} disagrees with "
                            f"recode={ref_recode!r} on the live-out rows"))
    return diags


# ---------------------------------------------------------------------------
# the pre-encode hook (REPRO_TORCH_COMEFA_VERIFY)
# ---------------------------------------------------------------------------

_ENV_VAR = "REPRO_TORCH_COMEFA_VERIFY"
_checked_keys: set = set()
_CHECKED_MAX = 4096


def verify_enabled() -> bool:
    """Is the ``REPRO_TORCH_COMEFA_VERIFY`` pre-encode hook armed?"""
    return os.environ.get(_ENV_VAR, "").strip().lower() not in (
        "", "0", "false", "off")


def maybe_verify(program) -> None:
    """Pre-encode hook: verify an `ir.Program` when the env flag is set.

    Called by `block.encoded` on every Program headed for the engines
    (covering `ComefaArray` and `ComefaGrid` run paths alike).  Raw
    instruction lists and encoded matrices are exempt — the IR-level
    contract (reserved constant rows, single-writer ports) is exactly
    what property tests exercising the bare simulator bypass on
    purpose.  Results are cached by the program's structural key, so a
    hot kernel re-running one program pays the scan once.
    """
    if not isinstance(program, ir.Program) or not verify_enabled():
        return
    if program.is_symbolic:
        return                         # encode() raises its own diagnostic
    key = program.key
    if key in _checked_keys:
        return
    # span the cold path only: cached keys cost a set lookup, so the
    # verifier latency the trace shows is the real per-program scan
    with obs_trace.span("comefa.verify",
                        program=getattr(program, "name", "") or "?"):
        assert_verified(program)
    if len(_checked_keys) >= _CHECKED_MAX:
        _checked_keys.clear()
    _checked_keys.add(key)


def maybe_verify_batch(programs: Sequence, reset_latches: bool) -> None:
    """Batch-boundary hook for `run_programs` under the env flag.

    Adds the cross-program latch analysis `maybe_verify` cannot see:
    with ``reset_latches=False`` a program reading a latch before
    writing it inherits its predecessor's state — reported at warning
    severity (deliberate threading is legal), so only error-severity
    findings raise here.
    """
    if not verify_enabled():
        return
    progs = [p for p in programs if isinstance(p, ir.Program)
             and not p.is_symbolic]
    if not progs:
        return
    errors = [d for d in verify_batch(progs, reset_latches=reset_latches)
              if d.is_error]
    if errors:
        raise VerificationError(errors)


# ---------------------------------------------------------------------------
# the sweep: every generator program + planner tile program in the repo
# ---------------------------------------------------------------------------

def _generator_catalog():
    """(name, program, live_out, context) for every shipped generator."""
    from . import program as pgen       # deferred: program imports ir
    entries = []

    def add_entry(prog, live_out=None, **ctx):
        entries.append((prog.name, prog, live_out, ctx))

    alloc = ir.RowAllocator()
    a = alloc.alloc(4, "a")
    b = alloc.alloc(4, "b")
    d5 = alloc.alloc(5, "d5")
    d8 = alloc.alloc(8, "d8")
    tmp = alloc.alloc(9, "tmp")

    p = pgen.zero_rows(d8); p.name = "zero_rows"; add_entry(p)
    p = pgen.copy_rows(a, b); p.name = "copy_rows"; add_entry(p)
    p = pgen.logic2(a, b, d5[:4], isa.TT_XOR); p.name = "logic2"
    add_entry(p)
    p = pgen.logic_ext(a, d5[:4], isa.TT_AND, [1, 0, 1, 1])
    p.name = "logic_ext"; add_entry(p)
    p = pgen.clear_latches(); p.name = "clear_latches"; add_entry(p)
    p = pgen.preset_carry(); p.name = "preset_carry"; add_entry(p)
    p = pgen.store_carry(d5[0]); p.name = "store_carry"; add_entry(p)
    p = pgen.add(a, b, d5); p.name = "add4"; add_entry(p, set(d5))
    p = pgen.add_ext(a, [1, 1, 0, 1], d5); p.name = "add_ext"
    add_entry(p, set(d5))
    p = pgen.sub(a, b, d5, tmp[:4]); p.name = "sub4"; add_entry(p, set(d5))
    p = pgen.mul(a, b, d8); p.name = "mul4"; add_entry(p, set(d8))
    p = pgen.add_into(d8, b, 2); p.name = "add_into"; add_entry(p, set(d8))
    p = pgen.shift_lanes(a, d5[:4]); p.name = "shift_lanes"; add_entry(p)
    p = pgen.compare_ge(a, b, tmp[:8], tmp[8]); p.name = "compare_ge"
    add_entry(p)
    p = pgen.compare_ge(a, b, tmp[:8], tmp[8]) + pgen.select(True, a, b,
                                                             d5[:4])
    p.name = "select"; add_entry(p)
    p = pgen.search_replace(a, key=0b1010, n_bits=4, tmp=tmp[:4])
    p.name = "search_replace"; add_entry(p)
    p = pgen.raid_rebuild([a, b], d5[:4], d8[:4]); p.name = "raid_rebuild"
    add_entry(p)
    dscr = alloc.alloc(13, "dscr")
    p = pgen.div(a, b, d5[:4], d8[:4], dscr); p.name = "div4"
    add_entry(p, set(d5[:4]) | set(d8[:4]))

    # reductions / shifts (chained contexts)
    alloc2 = ir.RowAllocator()
    val = alloc2.alloc(9, "val")
    scr = alloc2.alloc(13, "scr")
    p = pgen.reduce_pairwise(val, scr, width=4, distance=2)
    p.name = "reduce_pairwise"; add_entry(p, set(val), n_blocks=2)
    p = pgen.reduce_tree(val, scr, width=4, steps=3, chain_steps=2)
    p.name = "reduce_tree"; add_entry(p, set(val), n_blocks=2)
    p = pgen.reduce_max(val[:4], scr, n_bits=4, distance=2)
    p.name = "reduce_max"; add_entry(p, set(val[:4]), n_blocks=2)

    # OOOR / streamed (specialized under every recode)
    alloc3 = ir.RowAllocator()
    w0 = alloc3.alloc(4, "w0")
    w1 = alloc3.alloc(4, "w1")
    acc = alloc3.alloc(10, "acc")
    neg = alloc3.alloc(4, "neg")
    p = pgen.ooor_dot([w0, w1], [0b1011, 0b0100], 4, acc)
    p.name = "ooor_dot"; add_entry(p, set(acc))
    p = pgen.ooor_dot_booth([w0, w1], [0b1011, 0b0111], 4, acc, neg)
    p.name = "ooor_dot_booth"; add_entry(p, set(acc))
    for recode in ("naive", "booth", "naf"):
        p = pgen.fir(w0, acc, [5, 0, 11, 3], 4, recode=recode,
                     neg_scratch=neg)
        p.name = f"fir@{recode}"; add_entry(p, set(acc), n_blocks=2)
    p = ir.specialize_streams(
        pgen.add_ext_stream(w0, ir.StreamedOperand(0, 4, "k"), acc[:5]),
        [0b0110])
    p.name = "add_ext_stream"; add_entry(p, set(acc[:5]))
    p = ir.specialize_streams(
        pgen.logic_ext_stream(w0, acc[:4], isa.TT_XOR,
                              ir.StreamedOperand(0, 4, "k")), [0b1001])
    p.name = "logic_ext_stream"; add_entry(p, set(acc[:4]))

    # floating point
    alloc4 = ir.RowAllocator()
    E, M = 4, 5
    ea = alloc4.alloc(E, "ea"); ma = alloc4.alloc(M, "ma")
    eb = alloc4.alloc(E, "eb"); mb = alloc4.alloc(M, "mb")
    sa = alloc4.alloc(3, "signs")
    eo = alloc4.alloc(E, "eo"); mo = alloc4.alloc(M, "mo")
    fscr = alloc4.alloc(2 * (M + 1) + (E + 2) + 2 * (M + 1), "fscr")
    p = pgen.fp_mul(0, ea, ma, 0, eb, mb, sa[0], sa[1], sa[2], eo, mo,
                    fscr, E, M)
    p.name = "fp_mul"; add_entry(p, set(eo) | set(mo) | {sa[2]})
    alloc5 = ir.RowAllocator()
    ea = alloc5.alloc(E, "ea"); ma = alloc5.alloc(M, "ma")
    eb = alloc5.alloc(E, "eb"); mb = alloc5.alloc(M, "mb")
    eo = alloc5.alloc(E, "eo"); mo = alloc5.alloc(M, "mo")
    fscr = alloc5.alloc(2 * (E + 1) + 3 * E + 2 * (M + 1) + (M + 3), "fscr")
    p = pgen.fp_add_same_sign(ea, ma, eb, mb, eo, mo, fscr, E, M)
    p.name = "fp_add"; add_entry(p, set(eo) | set(mo))
    return entries


def _sweep_generators(verbose: bool = False) -> List[str]:
    """Verify + translation-validate every generator program.  Returns
    failure descriptions (empty == all clean)."""
    failures: List[str] = []
    for name, prog, live_out, ctx in _generator_catalog():
        errors = [d for d in verify_program(prog, name=name, **ctx)
                  if d.is_error]
        failures += [f"{name}: {d}" for d in errors]
        try:
            opt = prog.optimize(live_out=live_out, verify=True)
        except VerificationError as e:
            failures += [f"{name} (optimize): {d}" for d in e.diagnostics]
            continue
        errors = [d for d in verify_program(opt, name=name + "+opt", **ctx)
                  if d.is_error]
        failures += [f"{name}+opt: {d}" for d in errors]
        if verbose:
            print(f"  {name:<22} {len(prog.slots):>4} slots -> "
                  f"{len(opt.slots):>4} verified")
    return failures


def _sweep_plans(verbose: bool = False) -> List[str]:
    """Verify planner row regions, schedules, and tile programs."""
    from . import schedule as sched_mod  # deferred: schedule imports ir
    failures: List[str] = []

    def note(label, diags):
        failures.extend(f"{label}: {d}" for d in diags if d.is_error)

    for m, k, n, bits, nb in ((2, 4, 2, 4, 1), (2, 8, 4, 4, 2)):
        plan = sched_mod.plan_gemm(m, k, n, bits, n_blocks=nb)
        label = f"gemm{m}x{k}x{n}b{bits}"
        note(label, verify_plan(plan, name=label))
        note(label, verify_schedule(plan.schedule()))
        for buf in (0, 1):
            prog = plan.compute_program(buf, optimized=False)
            note(label, [d for d in verify_program(
                prog, n_blocks=nb, chain=True) if d.is_error])
            try:
                opt = prog.optimize(verify=True)
            except VerificationError as e:
                failures += [f"{label} (optimize): {d}"
                             for d in e.diagnostics]
                continue
            note(label + "+opt", verify_program(opt, n_blocks=nb,
                                                chain=True))
        if verbose:
            print(f"  {label:<22} plan + {plan.n_tiles} tiles verified")

    rng = np.random.default_rng(7)
    for reserve_neg in (False, True):
        plan = sched_mod.plan_gemv(k=12, n=8, w_bits=4, x_bits=4,
                                   acc_bits=12, k_tile=3,
                                   reserve_neg=reserve_neg)
        label = f"gemv_k12{'_neg' if reserve_neg else ''}"
        note(label, verify_plan(plan, name=label))
        x = [int(v) for v in rng.integers(0, 16, plan.k)]
        note(label, verify_schedule(plan.schedule(x)))
        recodes = ("naive", "booth", "naf") if reserve_neg else ("naive",)
        for tile in plan.tiles():
            chunk = x[tile.k_start:tile.k_end]
            sym = plan.symbolic_chunk_program(tile)
            sym_diags = verify_program(sym, name=sym.name)
            if not any(d.code == SYMBOLIC_SLOT for d in sym_diags):
                failures.append(f"{label}: symbolic template not reported "
                                f"by the verifier")
            note(label, validate_specialization(
                sym, chunk, live_out=set(plan.acc), recodes=recodes,
                name=f"{label}.t{tile.index}"))
            for recode in recodes:
                prog = plan.tile_program(tile, chunk, optimized=False,
                                         recode=recode)
                note(f"{label}@{recode}",
                     verify_program(prog, n_blocks=plan.n_blocks))
                try:
                    prog.optimize(live_out=set(plan.acc), verify=True)
                except VerificationError as e:
                    failures += [f"{label}@{recode} (optimize): {d}"
                                 for d in e.diagnostics]
        if verbose:
            print(f"  {label:<22} plan + {plan.n_tiles} tiles x "
                  f"{len(recodes)} recodes verified")
    return failures


# ---------------------------------------------------------------------------
# mutation self-tests: seeded hazard injection must be caught
# ---------------------------------------------------------------------------

def _selftests(seed: int = 0) -> List[Tuple[str, bool, str]]:
    """(label, caught, detail) per injected hazard/miscompile class."""
    import dataclasses

    from . import program as pgen
    from . import schedule as sched_mod
    rng = np.random.default_rng(seed)
    results: List[Tuple[str, bool, str]] = []

    def record(label, diags_or_codes, want_code):
        codes = [d.code if isinstance(d, Diagnostic) else d
                 for d in diags_or_codes]
        results.append((label, want_code in codes,
                        f"want {want_code}, got {sorted(set(codes))}"))

    # 1. dual-port write race: W1 and W2 target one row, same predicate
    row = int(rng.integers(0, 100))
    host = isa.Instr(src1_row=1, src2_row=2, dst_row=row,
                     truth_table=isa.TT_XOR, wp1_en=1, c_rst=1)
    rider = isa.Instr(dst_row=row, wp2_en=1, w2_sel=isa.W2_ZERO)
    mut = ir.Program.from_slots([(host, rider)], name="mut-port-race")
    record("port-race", verify_program(mut), PORT_RACE)

    # 2. reserved-row write injected into a clean program
    clean = pgen.add([2, 3], [4, 5], [6, 7, 8])
    hot = pgen.copy_rows([9], [ROW_ZEROS])
    record("reserved-write", verify_program(clean + hot), RESERVED_WRITE)

    # 3a. stale-latch read: carry consumed with unknown inbound state
    record("stale-latch", verify_program(pgen.store_carry(5),
                                         clear_latches=False), STALE_LATCH)
    # 3b. the PR-2 leak shape: predicate on a latch across an unreset
    # run_programs boundary
    leaky = verify_batch(
        [pgen.add([2, 3], [4, 5], [6, 7, 8]),
         pgen.copy_rows([2, 3], [10, 11], pred_sel=PRED_CARRY)],
        reset_latches=False)
    record("stale-latch-boundary", leaky, STALE_LATCH)

    # 4. plan region overlap: mutate a good plan's accumulator into the
    # weight buffer rows
    plan = sched_mod.plan_gemv(k=6, n=4, w_bits=4, x_bits=4, acc_bits=10,
                               k_tile=3)
    bad_acc = ir.Operand(plan.buffers[0].rows[:10], "acc")
    broken = dataclasses.replace(plan, acc=bad_acc)
    record("region-overlap", verify_plan(broken), REGION_OVERLAP)

    # 5. double-buffer lag violation: a timeline that reuses the operand
    # buffer one tile too early
    class _BrokenSchedule(sched_mod.Schedule):
        def timeline(self):
            spans = super().timeline()
            fixed = []
            for s in spans:
                if s.tile == self.n_buffers and s.kind == "load":
                    s = dataclasses.replace(s, start=0,
                                            end=s.end - s.start)
                fixed.append(s)
            return fixed

    sched = _BrokenSchedule([(4, 9, 3)] * 4, name="mut-lag")
    record("buffer-lag", verify_schedule(sched), BUFFER_LAG)

    # 6. miscompile: a pass that grows the written-row footprint
    def rogue_writer(slots, live_out=None):
        extra = isa.Instr(dst_row=97, truth_table=isa.TT_ONE, wp1_en=1,
                          c_rst=1)
        return list(slots) + [(extra,)]

    src = pgen.add([2, 3], [4, 5], [6, 7, 8])
    try:
        src.optimize(passes=[rogue_writer], verify=True)
        record("pass-footprint", [], PASS_FOOTPRINT)
    except VerificationError as e:
        record("pass-footprint", e.diagnostics, PASS_FOOTPRINT)

    # 7. miscompile: a pass that silently flips a truth table
    def rogue_flipper(slots, live_out=None):
        out = list(slots)
        i = out[0][0]
        out[0] = (dataclasses.replace(i, truth_table=i.truth_table ^ 0b1111),)
        return out

    try:
        src.optimize(passes=[rogue_flipper], verify=True)
        record("pass-value", [], PASS_VALUE)
    except VerificationError as e:
        record("pass-value", e.diagnostics, PASS_VALUE)

    # 8. seam shift on an unchained multi-block context
    shifts = pgen.shift_lanes([2, 3], [4, 5])
    record("seam-shift", verify_program(shifts, n_blocks=2, chain=False),
           SEAM_SHIFT)

    # 9. symbolic slot reaching encode
    sym = pgen.fir_stream([2, 3], [10, 11, 12, 13], n_samples=1, x_bits=2)
    record("symbolic-slot", verify_program(sym), SYMBOLIC_SLOT)
    try:
        sym.encode()
        record("symbolic-encode", [], SYMBOLIC_SLOT)
    except VerificationError as e:
        record("symbolic-encode", e.diagnostics, SYMBOLIC_SLOT)
    return results


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.comefa.verify",
        description="Sweep every shipped CoMeFa program through the static "
                    "verifier and translation validator.")
    ap.add_argument("--all", action="store_true",
                    help="sweep + mutation self-tests (the CI profile)")
    ap.add_argument("--selftest", action="store_true",
                    help="run only the seeded hazard-injection self-tests")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed for hazard injection and random states")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    run_sweep = not args.selftest
    run_self = args.all or args.selftest

    failures: List[str] = []
    if run_sweep:
        print("verify: sweeping generator programs ...")
        failures += _sweep_generators(verbose=args.verbose)
        print("verify: sweeping planner tile programs ...")
        failures += _sweep_plans(verbose=args.verbose)
    if run_self:
        print("verify: mutation self-tests (seeded hazard injection) ...")
        for label, caught, detail in _selftests(seed=args.seed):
            status = "caught" if caught else "MISSED"
            if args.verbose or not caught:
                print(f"  {label:<24} {status}  ({detail})")
            if not caught:
                failures.append(f"selftest {label}: {detail}")
    if failures:
        print(f"verify: FAILED ({len(failures)} finding(s))",
              file=sys.stderr)
        for f in failures:
            print(f"  {f}", file=sys.stderr)
        return 1
    print("verify: OK — all programs clean, all injected hazards caught")
    return 0


if __name__ == "__main__":
    sys.exit(main())
