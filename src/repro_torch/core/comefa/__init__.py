"""CoMeFa compute-in-memory RAM: ISA, IR, bit-level simulator, programs,
tiled LCU scheduling, timing, static verification."""
from . import (engine_packed, grid, ir, isa, layout, program, recode,
               schedule, timing, verify)
from .block import ComefaArray, get_engine
from .diagnostics import Diagnostic, VerificationError
from .grid import ComefaGrid
from .ir import (Operand, Program, RowAllocator, StreamedOperand,
                 specialize_streams)
from .isa import (Instr, N_COLS, N_ROWS, ROW_ONES, ROW_ZEROS, USABLE_ROWS,
                  WORD_BITS)
from .layout import ChainPlan, plan_chain
from .program import ProgramBuilder
from .schedule import (GemmPlan, GemvPlan, Schedule, cached_plan_gemv,
                       plan_gemm, plan_gemv)
from .verify import (validate_pass, verify_batch, verify_plan,
                     verify_program, verify_schedule)

__all__ = [
    "engine_packed", "grid", "ir", "isa", "layout", "program", "recode",
    "schedule", "timing", "verify", "get_engine",
    "ComefaArray", "ComefaGrid",
    "Instr", "Program", "ProgramBuilder", "RowAllocator", "Operand",
    "StreamedOperand", "specialize_streams",
    "ChainPlan", "plan_chain", "GemmPlan", "GemvPlan", "Schedule",
    "plan_gemm", "plan_gemv", "cached_plan_gemv",
    "N_COLS", "N_ROWS", "USABLE_ROWS",
    "WORD_BITS", "ROW_ONES", "ROW_ZEROS",
    "Diagnostic", "VerificationError", "verify_program", "verify_batch",
    "verify_plan", "verify_schedule", "validate_pass",
]
