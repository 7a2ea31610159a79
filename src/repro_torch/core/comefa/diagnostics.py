"""Structured diagnostics for the CoMeFa IR toolchain.

Every raise site in the IR stack — the static verifier (`verify.py`),
the encoder, `specialize_streams`, `concat_programs` — reports problems
through one shape: a `Diagnostic` naming the *program*, the *slot*, the
*rows* involved, a stable machine-readable *code*, and a severity.
Errors surface as `VerificationError`, which subclasses `ValueError` so
callers (and tests) written against the old bare-string raises keep
working, while tooling can switch on `exc.diagnostics[i].code`.

This module is a leaf: it imports nothing from the package, so `ir.py`,
`verify.py`, `block.py` and `schedule.py` can all depend on it without
cycles.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# stable diagnostic codes (documented in docs/program_ir.md; tests pin them)
# ---------------------------------------------------------------------------

# dual-port hazards
PORT_RACE = "port-race"            # W1+W2 write the same row in one cycle
SLOT_STRUCTURE = "slot-structure"  # fused slot without a legal W2 rider side
# resource legality
RESERVED_WRITE = "reserved-write"  # write targets a reserved constant row
REGION_OVERLAP = "region-overlap"  # plan row regions intersect
REGION_RESERVED = "region-reserved"  # plan region includes a reserved row
BUFFER_LAG = "buffer-lag"          # schedule reuses a buffer before release
PHASE_ORDER = "phase-order"        # tile phases overlap/are out of order
SEAM_SHIFT = "seam-shift"          # lane shift on an unchained multi-block run
# latch / stream dataflow
STALE_LATCH = "stale-latch"        # latch read before any in-scope write
SYMBOLIC_SLOT = "symbolic-slot"    # StreamMac/StreamExt reached encode
STREAM_MISSING = "stream-missing"  # specialize: stream index has no value
STREAM_RANGE = "stream-range"      # specialize: value out of stream range
STREAM_DIGITS = "stream-digit-set"  # signed digits without neg scratch
STREAM_RECODE = "stream-recode"    # unknown recode mode
# translation validation
PASS_FOOTPRINT = "pass-footprint"  # a pass grew the written-row footprint
PASS_VALUE = "pass-value"          # live-out row values diverge after a pass
PASS_LATCH = "pass-latch"          # final carry/mask state diverges
PASS_STRUCTURE = "pass-structure"  # pass run on slots it cannot handle
# composition
CONCAT_INPUT = "concat-input"      # concat constituent is not an IR program

ERROR = "error"
WARNING = "warning"


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One verifier finding, locatable and machine-checkable."""
    code: str
    message: str
    severity: str = ERROR
    program: Optional[str] = None     # Program.name (or pass name)
    slot: Optional[int] = None        # slot index within the program
    rows: Tuple[int, ...] = ()        # rows implicated, sorted

    def __post_init__(self):
        object.__setattr__(self, "rows", tuple(sorted(self.rows)))

    @property
    def is_error(self) -> bool:
        return self.severity == ERROR

    def __str__(self):
        where = self.program if self.program is not None else "<program>"
        if self.slot is not None:
            where += f"[slot {self.slot}]"
        tail = f" (rows {list(self.rows)})" if self.rows else ""
        return f"{self.severity}:{self.code} {where}: {self.message}{tail}"


class VerificationError(ValueError):
    """A diagnostic-carrying error from the IR verifier or a raise site.

    Subclasses `ValueError` so existing `except ValueError` /
    `pytest.raises(ValueError, match=...)` call sites are unaffected;
    new code should inspect `.diagnostics` instead of the message.
    """

    def __init__(self, diagnostics: Sequence[Diagnostic]):
        if isinstance(diagnostics, Diagnostic):
            diagnostics = (diagnostics,)
        self.diagnostics: Tuple[Diagnostic, ...] = tuple(diagnostics)
        assert self.diagnostics, "VerificationError needs >= 1 diagnostic"
        super().__init__("\n".join(str(d) for d in self.diagnostics))

    @property
    def codes(self) -> Tuple[str, ...]:
        return tuple(d.code for d in self.diagnostics)


def raise_diag(code: str, message: str, *, program=None, slot=None,
               rows=()) -> None:
    """Shorthand for the single-diagnostic raise sites in `ir.py`."""
    raise VerificationError(Diagnostic(code=code, message=message,
                                       program=program, slot=slot,
                                       rows=tuple(rows)))
