"""Exact, value-driven recode selection for streamed GEMV chunks.

The paper's OOOR zero-skipping (Sec. III-I) makes a streamed MAC cost
one accumulator-segment add per *nonzero digit* of the recoded operand,
so the cheapest digit schedule depends on the operand's actual bit
statistics: naive binary wins sparse values, NAF/Booth win runs of ones,
and the value-independent broadcast mask program (the grid-wide
shared-FSM mode) wins nothing on compute but can still win a wave when
load traffic dominates the pipelined makespan.  Decode activations are
sparse and non-stationary, so a single global recode knob leaves cycles
on the table every token.

This module prices every candidate *exactly* from `GemvPlan` geometry:

  * `chunk_stream_cycles` - the unoptimized compute cycles of one
    specialized chunk, vectorized over the chunk via
    `timing.digit_patterns` (complement charges for the `reserve_neg`
    scratch region, per-digit ripple lengths, and the signed-mode
    accumulator-capacity truncation included).  Cycle-exact against
    `GemvPlan.tile_program(..., optimized=False)` - the same domain
    `timing.streamed_mac_cycles` is pinned in.
  * `select_chunk` - argmin over the legal candidates for one chunk
    (signed modes need the plan's complement scratch rows).
  * `select_wave` - the grid-wave decision: per-slot FSMs make *mixed*
    recodes across slots legal and the makespan is the max over slots,
    so each tile is priced at its most expensive slot's winning chunk
    and pipelined through the LCU `Schedule`; the broadcast alternative
    (whose `gemv_batched_k_tile` shrink and per-element x-row load
    traffic the quote carries) competes on its own geometry.

Selections land in the ``comefa.recode_selected{choice}`` counter and a
``recode.select_wave`` span, so serving sweeps show *what* was picked,
not just that it was fast.  Bit-exactness is untouched by construction:
every candidate already produces identical results.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from ...obs import metrics as obs_metrics
from ...obs import trace as obs_trace
from . import timing
from .isa import N_COLS
from .schedule import GemvPlan, GemvTile, Schedule

# per-chunk winners, labelled by choice ("broadcast" counts every
# slot-chunk of a wave the shared program serves, keeping the histogram
# comparable across modes)
_RECODE_SELECTED = obs_metrics.counter("comefa.recode_selected")

#: candidate digit schedules when the plan reserves complement scratch
#: rows (ties break left-to-right: prefer the cheaper specialization)
SIGNED_CANDIDATES = ("naive", "naf", "booth")
#: without ``reserve_neg`` rows only unsigned digits are legal
UNSIGNED_CANDIDATES = ("naive",)


def candidates_for(plan: GemvPlan) -> Tuple[str, ...]:
    """Digit schedules legal on this plan's geometry."""
    return SIGNED_CANDIDATES if plan.neg is not None else UNSIGNED_CANDIDATES


def chunk_stream_cycles(values, *, w_bits: int, x_bits: int, acc_bits: int,
                        recode: str = "naive",
                        zero_acc: bool = False) -> int:
    """Exact unoptimized compute cycles of one specialized streamed chunk.

    Vectorized restatement of ``sum(timing.streamed_mac_cycles(...))``
    over the chunk: each value with any negative digit pays the
    ``w_bits`` complement into the reserve_neg scratch, each processed
    nonzero digit at offset ``b`` pays ``acc_bits - b`` add/ripple
    cycles (+1 carry preset when negative), and signed modes stop at the
    first digit whose weight segment no longer fits the accumulator
    (the truncation cap below - note the complement is charged from the
    *full* digit set, exactly as the expansion does).  ``zero_acc`` adds
    the tile-0 accumulator zeroing.  Asserted cycle-exact against the
    generated programs in tests/test_recode.py.
    """
    x = np.asarray(values, dtype=np.int64).ravel()
    nz, neg = timing.digit_patterns(x, x_bits, recode)
    total = int(np.count_nonzero(neg)) * w_bits
    max_off = x_bits + (0 if recode == "naive" else 1)
    if recode != "naive":
        max_off = min(max_off, acc_bits - w_bits + 1)
    for off in range(max(0, max_off)):
        total += int(((nz >> off) & 1).sum()) * (acc_bits - off)
        total += int(((neg >> off) & 1).sum())
    return total + (acc_bits if zero_acc else 0)


@dataclasses.dataclass(frozen=True)
class ChunkChoice:
    """Winner of one chunk's candidate auction, with its exact price."""
    recode: str
    cycles: int


def select_chunk(values: Sequence[int], plan: GemvPlan, tile: GemvTile,
                 candidates: Optional[Sequence[str]] = None,
                 record: bool = True) -> ChunkChoice:
    """Cheapest digit schedule for ONE concrete activation chunk.

    Exact argmin - no estimates: every candidate is priced with
    `chunk_stream_cycles` on the plan's real geometry.  ``record=False``
    suppresses the selection counter (used by `select_wave`, which
    records only the decisions that actually execute).
    """
    cands = (tuple(candidates) if candidates is not None
             else candidates_for(plan))
    best = None
    for rc in cands:
        cyc = chunk_stream_cycles(values, w_bits=plan.w_bits,
                                  x_bits=plan.x_bits,
                                  acc_bits=plan.acc_bits, recode=rc,
                                  zero_acc=tile.index == 0)
        if best is None or cyc < best.cycles:
            best = ChunkChoice(rc, cyc)
    assert best is not None, "no candidates"
    if record:
        _RECODE_SELECTED.inc(choice=best.recode)
    return best


@dataclasses.dataclass(frozen=True)
class BroadcastQuote:
    """Priced broadcast-mode alternative for one grid wave.

    The value-independent mask program runs on a *different* geometry -
    `kernels.comefa_sim.gemv_batched_k_tile` shrinks the chunk so each
    element's x bits fit as broadcast rows - so the quote carries its own
    plan plus the actual (shape-cached) per-tile program lengths; the
    extra per-element ``x_bits`` row traffic is priced into the load
    phase here.  Built by the kernel layer (which owns the broadcast
    program) and handed down, keeping this core module kernel-agnostic.
    """
    plan: GemvPlan
    compute_cycles: Tuple[int, ...]        # per tile, program lengths

    def schedule(self) -> Schedule:
        tiles = self.plan.tiles()
        assert len(tiles) == len(self.compute_cycles)
        x_load = timing.load_store_cycles(N_COLS, self.plan.x_bits)
        costs = [(self.plan.load_cycles(t) + t.n_elems * x_load,
                  self.compute_cycles[t.index], self.plan.unload_cycles(t))
                 for t in tiles]
        return Schedule(costs, name=f"bcast_gemv_k{self.plan.k}")

    @property
    def total_cycles(self) -> int:
        return self.schedule().total_cycles


@dataclasses.dataclass(frozen=True)
class WaveSelection:
    """One grid wave's decision: execution mode + per-slot chunk winners."""
    mode: str                              # "per_slot" | "broadcast"
    choices: Tuple[Tuple[ChunkChoice, ...], ...]    # [slot][tile]
    per_slot_cycles: int                   # pipelined makespan (modeled)
    broadcast_cycles: Optional[int]        # None when broadcast has no room


def select_wave(plan: GemvPlan, x_batch,
                broadcast: Optional[BroadcastQuote] = None) -> WaveSelection:
    """Pick per-slot recodes AND broadcast-vs-per-slot for one wave.

    The per-slot quote prices each tile at the most expensive slot's
    *winning* chunk (the grid makespan is the max over slot FSMs) and
    pipelines the tiles through the plan's LCU `Schedule`; the broadcast
    quote, when the shrunk geometry fits at all, competes with its own
    pipelined makespan.  Whichever is shorter executes.  Ties go to
    per-slot (it never loses on compute and skips the x-row loads).
    """
    x = np.asarray(x_batch)
    assert x.ndim == 2 and x.shape[1] == plan.k, x.shape
    G = x.shape[0]
    tiles = plan.tiles()
    with obs_trace.span("recode.select_wave", slots=G,
                        tiles=len(tiles)) as sp:
        choices = tuple(
            tuple(select_chunk(x[g, t.k_start:t.k_end], plan, t,
                               record=False) for t in tiles)
            for g in range(G))
        costs = [(plan.load_cycles(t),
                  max(choices[g][t.index].cycles for g in range(G)),
                  plan.unload_cycles(t)) for t in tiles]
        ps_cycles = Schedule(costs,
                             name=f"perslot_gemv_k{plan.k}").total_cycles
        b_cycles = (broadcast.total_cycles
                    if broadcast is not None else None)
        if b_cycles is not None and b_cycles < ps_cycles:
            mode = "broadcast"
            _RECODE_SELECTED.inc(G * len(tiles), choice="broadcast")
        else:
            mode = "per_slot"
            for slot_choices in choices:
                for c in slot_choices:
                    _RECODE_SELECTED.inc(choice=c.recode)
        sp.set(mode=mode, per_slot_cycles=ps_cycles,
               broadcast_cycles=-1 if b_cycles is None else b_cycles)
    return WaveSelection(mode=mode, choices=choices,
                         per_slot_cycles=ps_cycles,
                         broadcast_cycles=b_cycles)
