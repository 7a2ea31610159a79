"""Simulator-backed CoMeFa kernels, driven by the program IR.

This module runs workloads through the bit-level `ComefaGrid` using
`ProgramBuilder`-assembled, IR-optimized programs: the validation backend
that ties the kernel layer to the hardware model.  Programs are built once
per shape and go through the simulator's encode cache.  Every kernel takes
``engine=`` and ``device=`` and threads them to the grid
(`core.comefa.block.get_engine`): on a CUDA device the grid runs the CUDA
step kernel unless another engine is named.

The port carries the batched GEMV that grid serving calls
(`serve.comefa_exec.GridLinearExecutor`): `comefa_gemv_batched` in its
broadcast, per-slot and ``recode="auto"`` modes.  It stages operands
straight into the grid's packed device state (`ComefaGrid.write_rows`):
per k-chunk, the chunk's weight rows (from `stage_weights`, built once
per weight matrix) and each slot's broadcast activation-bit rows, then
one dispatch; the accumulator rows come back once per call.  The state,
`cycles` and outputs are exactly those of placing every chunk through
host numpy (`layout.place` on slot views); only the grid's `host_syncs`
and `device_puts` are smaller (none and one per call).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.comefa import ComefaGrid, N_COLS, block, layout, schedule
from ..core.comefa import ir as ir_mod
from ..core.comefa import program
from ..core.comefa import recode as recode_mod
from ..core.comefa.ir import Program, RowAllocator
from ..core.comefa.isa import (Instr, N_ROWS, PRED_MASK, RESERVED_ROWS,
                               TT_COPY_A, USABLE_ROWS)
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace

# modelled compute cycles per kernel invocation; the registry-side home of
# the ``stats={"cycles": ...}`` side channel (which keeps working)
_KERNEL_CYCLES = obs_metrics.counter("comefa.kernel_cycles")

# shape-keyed cache of built + optimized programs with their encoded
# engine matrices (the expensive part is Python-side generation; keeping
# the matrix also spares every dispatch the encode cache's lookup, which
# hashes the program's whole instruction tuple)
_PROGRAMS: Dict[Tuple, Tuple[Program, np.ndarray]] = {}


@dataclasses.dataclass(frozen=True)
class StagedWeights:
    """Unsigned integer weights in the grid's transposed row layout.

    ``rows`` is int32 ``[K, w_bits, n_blocks, 5]`` (one weight matrix
    shared by every slot) or ``[G, K, w_bits, n_blocks, 5]`` (one per
    slot): `layout.to_row_words` of each weight row ``w[k, :]``, about
    one byte per 8-bit weight.  Built once per matrix by
    `stage_weights`, it feeds every chunk of every call.
    """
    rows: torch.Tensor
    k: int
    n: int
    w_bits: int

    @property
    def n_blocks(self) -> int:
        return int(self.rows.shape[-2])


def stage_weights(w, w_bits: int, device) -> StagedWeights:
    """Unsigned weights ``[(G,) K, N]`` -> `StagedWeights` on `device`."""
    if not isinstance(w, torch.Tensor):
        w = torch.tensor(np.asarray(w))
    w = w.to(device=device, dtype=torch.int64)
    k, n = int(w.shape[-2]), int(w.shape[-1])
    nb = max(1, -(-n // N_COLS))
    return StagedWeights(layout.to_row_words(w, w_bits, nb), k, n, w_bits)


def gemv_batched_k_tile(w_bits: int, x_bits: int, acc_bits: int) -> int:
    """Largest chunk fitting double-buffered weights + resident x bits."""
    return (USABLE_ROWS - acc_bits) // (2 * w_bits + x_bits)


def _gemv_batched_layout(plan: schedule.GemvPlan):
    """Per-chunk activation-bit rows, allocated beside the plan's regions.

    The batched GEMV keeps each slot's streamed activations *resident*
    (broadcast across all lanes of that slot) instead of encoding them
    into the instruction stream, so one value-independent program can
    drive every slot.  Rows come from whatever the `GemvPlan` left free.
    """
    used = set(plan.acc)
    for buf in plan.buffers:
        used |= set(buf.rows)
    free = sorted(set(range(N_ROWS)) - set(RESERVED_ROWS) - used)
    alloc = RowAllocator.from_rows(free)
    return [alloc.alloc(plan.x_bits, f"x{j}") for j in range(plan.k_tile)]


def _gemv_batched_chunk_program(plan: schedule.GemvPlan,
                                tile: schedule.GemvTile, x_rows,
                                optimized: bool
                                ) -> Tuple[Program, np.ndarray]:
    """Shared (value-independent) accumulate program for one k-chunk, and
    its (frozen) engine matrix.

    For each resident weight j and each activation bit b, the program
    loads the mask latch from the slot's broadcast x[j] bit-b row, then
    mask-predicates the `add_into` at offset b - the same predication
    pattern `program.mul` uses per multiplier bit.  Slots where the bit
    is 0 retire the adds as no-ops; the cycle count is value-independent
    (the price of sharing one FSM stream across the grid, vs the per-x
    OOOR zero-skipping of the per-slot modes).
    """
    key = ("gemv_batched", plan.w_bits, plan.x_bits, plan.acc_bits,
           plan.k_tile, tile.n_elems, tile.buffer, tile.index == 0,
           optimized)
    if key not in _PROGRAMS:
        buf = plan.buffers[tile.buffer]
        prog = Program(name=f"gemv_batched_chunk{tile.index}")
        if tile.index == 0:
            prog += program.zero_rows(plan.acc)
        for j in range(tile.n_elems):
            w = buf.weight_rows(j, plan.w_bits)
            for b in range(plan.x_bits):
                prog.append(Instr(src1_row=x_rows[j][b],
                                  truth_table=TT_COPY_A, m_en=1, c_rst=1))
                prog += program.add_into(plan.acc, w, b,
                                         pred_sel=PRED_MASK)
        prog = prog.with_live_out(set(plan.acc))
        if optimized:
            prog = prog.optimize()
        _PROGRAMS[key] = (prog, block.encoded(prog))
    return _PROGRAMS[key]


# per-shape cached broadcast quotes for the auto selector (the underlying
# plan and chunk programs are themselves shape-cached; this just skips
# re-walking the tiles per wave)
_BCAST_QUOTES: Dict[Tuple, Optional[recode_mod.BroadcastQuote]] = {}


def _broadcast_quote(k: int, n: int, w_bits: int, x_bits: int,
                     acc_bits: int,
                     optimized: bool) -> Optional[recode_mod.BroadcastQuote]:
    """Price the shared-FSM broadcast alternative for the auto selector.

    None when the shrunk broadcast chunk (`gemv_batched_k_tile`) has no
    room at all; otherwise a `recode.BroadcastQuote` carrying the
    broadcast-geometry plan and the actual mask-program length per tile
    - the selector prices the x-row load traffic on top.
    """
    key = (k, n, w_bits, x_bits, acc_bits, optimized)
    if key not in _BCAST_QUOTES:
        k_tile = gemv_batched_k_tile(w_bits, x_bits, acc_bits)
        if k_tile < 1:
            _BCAST_QUOTES[key] = None
        else:
            plan = schedule.cached_plan_gemv(k, n, w_bits, x_bits,
                                             acc_bits,
                                             k_tile=min(k, k_tile))
            x_rows = _gemv_batched_layout(plan)
            comp = tuple(
                _gemv_batched_chunk_program(plan, t, x_rows,
                                            optimized)[0].cycles
                for t in plan.tiles())
            _BCAST_QUOTES[key] = recode_mod.BroadcastQuote(
                plan=plan, compute_cycles=comp)
    return _BCAST_QUOTES[key]


def _stage_chunk_weights(grid: ComefaGrid, plan: schedule.GemvPlan,
                         tile: schedule.GemvTile, w: StagedWeights) -> None:
    """Write the chunk's weights into its buffer's rows of every slot.

    Weight j_local of the chunk occupies ``w_bits`` consecutive rows from
    ``buf.weight_rows(j_local).base``, so the chunk is one run of rows
    from the buffer's base - one device write.
    """
    base = plan.buffers[tile.buffer].rows.base
    m = tile.n_elems * plan.w_bits
    part = w.rows[..., tile.k_start:tile.k_end, :, :, :]
    part = part.reshape(*part.shape[:-4], m, plan.n_blocks, -1)
    grid.write_rows(range(base, base + m),
                    part.transpose(-3, -2))             # [(G,) nb, m, W]


def _read_acc(grid: ComefaGrid, plan: schedule.GemvPlan, n: int
              ) -> np.ndarray:
    """The accumulator of every slot, unsigned, ``[G, n]`` int64 - one
    device read of ``acc_bits`` rows and one copy to the host."""
    words = grid.read_rows(range(plan.acc.base,
                                 plan.acc.base + plan.acc_bits))
    vals = layout.from_row_words(words.transpose(-3, -2))   # [G, nb*160]
    return vals[:, :n].cpu().numpy()


def comefa_gemv_batched(w, x: np.ndarray, *, w_bits: int,
                        x_bits: int, acc_bits: int = 32,
                        optimized: bool = True,
                        recode: Optional[str] = None,
                        stats: Optional[Dict] = None,
                        engine=None, device="cuda") -> np.ndarray:
    """y[g] = w[g].T @ x[g] for G independent GEMVs on ONE grid dispatch.

    w: [G, k, n] unsigned ints (numpy or a tensor), or `StagedWeights`
    (shared by every slot or one per slot); x: [G, k] unsigned ints.
    Two execution modes:

      * ``recode=None`` (the shared-FSM broadcast): geometry from the
        same `schedule.plan_gemv` double-buffered chunking as the
        single-instance GEMV, with the k-chunk shrunk so each chunk's
        activation bits fit as broadcast rows (`gemv_batched_k_tile`) -
        every slot loads its own weights AND its own x bits, then all
        slots execute one shared mask-predicated accumulate program
        whose cycle count is value-independent (no zero-skipping: the
        trade for grid-wide SIMD).
      * ``recode="naive" | "booth" | "naf"`` (per-slot streams): one
        instruction FSM per grid slice.  The plan's *symbolic* chunk
        template is shared, each slot's activation chunk specializes it
        into its own digit stream (`ir.specialize_streams`), and
        `ComefaGrid.run_per_slot` dispatches the per-slot programs
        together - the grid sweep regains the OOOR zero-skipping (and
        Booth/NAF recoding) the broadcast mode gave up.
      * ``recode="auto"`` (adaptive): `recode.select_wave` prices every
        candidate - the broadcast mask program on its own shrunk
        geometry, naive/Booth/NAF per slot - against the wave's *actual*
        activation values and executes the cheapest pipelined makespan;
        per-slot FSMs make mixed recodes across slots (and across
        k-chunks) legal.

    A `stats` dict receives the grid's modelled compute ``cycles`` (the
    per-slot lockstep / makespan count) and the executed ``mode``
    ("broadcast" or "per_slot"); the same count also lands in the
    ``comefa.kernel_cycles`` counter (labels ``kernel="gemv_batched"``,
    ``mode``) of the `repro_torch.obs.metrics` registry.  Returns int64
    ``[G, n]`` on the host.
    """
    x = np.asarray(x)
    if not isinstance(w, StagedWeights):
        w = stage_weights(w, w_bits, device)
    assert w.w_bits == w_bits, (w.w_bits, w_bits)
    assert x.ndim == 2 and x.shape[1] == w.k
    assert w.rows.dim() == 4 or w.rows.shape[0] == x.shape[0]
    G, k, n = x.shape[0], w.k, w.n
    choices = None
    if recode == "auto":
        plan_ps = schedule.cached_plan_gemv(k, n, w_bits, x_bits, acc_bits,
                                            reserve_neg=True)
        sel = recode_mod.select_wave(
            plan_ps, x, broadcast=_broadcast_quote(k, n, w_bits, x_bits,
                                                   acc_bits, optimized))
        if sel.mode == "broadcast":
            recode = None            # the shared mask program won
        else:
            choices = sel.choices
    if recode is not None:
        return _comefa_gemv_per_slot(w, x, w_bits=w_bits, x_bits=x_bits,
                                     acc_bits=acc_bits, optimized=optimized,
                                     recode=recode, choices=choices,
                                     stats=stats, engine=engine,
                                     device=device)
    k_tile = gemv_batched_k_tile(w_bits, x_bits, acc_bits)
    if k_tile < 1:
        raise ValueError(
            f"no room for a double-buffered {w_bits}-bit weight plus "
            f"{x_bits} broadcast x rows beside a {acc_bits}-bit "
            f"accumulator ({USABLE_ROWS} usable rows)")
    plan = schedule.cached_plan_gemv(k, n, w_bits, x_bits, acc_bits,
                                     k_tile=min(k, k_tile))
    assert plan.n_blocks == w.n_blocks
    x_rows = _gemv_batched_layout(plan)
    grid = ComefaGrid(G, n_blocks=plan.n_blocks, engine=engine,
                      device=device)
    assert ((0 <= x) & (x < (1 << x_bits))).all()
    # every slot's activation bits as whole-row words: bit b of x[g, j]
    # fills all lanes of row x_rows[j][b] (all-ones or all-zeros)
    xt = torch.as_tensor(x.astype(np.int64), device=grid.device)
    shifts = torch.arange(x_bits, dtype=torch.int64, device=grid.device)
    xbits = -((xt[:, :, None] >> shifts) & 1).to(torch.int32)  # [G, k, xb]
    x_index = [r for rows in x_rows for r in rows]      # j-major, then bit
    costs = []
    with obs_trace.span("kernel.gemv_batched", slots=G, k=k, n=n,
                        mode="broadcast") as sp:
        for tile in plan.tiles():
            _stage_chunk_weights(grid, plan, tile, w)
            words = xbits[:, tile.k_start:tile.k_end].reshape(G, 1, -1, 1)
            grid.write_rows(x_index[:tile.n_elems * x_bits], words)
            prog, mat = _gemv_batched_chunk_program(plan, tile, x_rows,
                                                    optimized=optimized)
            grid.run(mat)
            if obs_trace.enabled():
                costs.append((plan.load_cycles(tile), prog.cycles,
                              plan.unload_cycles(tile)))
        sp.set(cycles=grid.cycles)
    _KERNEL_CYCLES.inc(grid.cycles, kernel="gemv_batched",
                       mode="broadcast")
    if costs:
        # the broadcast chunk program is shared by every slot, so one
        # timeline stands in for all G lockstep pipelines
        schedule.Schedule(costs, name=f"gemv_k{k}").emit_trace(
            name=f"broadcast_g{G}/gemv_k{k}")
    if stats is not None:
        stats["cycles"] = grid.cycles
        stats["mode"] = "broadcast"
    return _read_acc(grid, plan, n)


def _comefa_gemv_per_slot(w: StagedWeights, x: np.ndarray, *, w_bits: int,
                          x_bits: int, acc_bits: int, optimized: bool,
                          recode: str, choices=None,
                          stats: Optional[Dict] = None,
                          engine=None, device="cuda") -> np.ndarray:
    """Per-slot-stream batched GEMV (`comefa_gemv_batched(recode=...)`).

    Same `schedule.plan_gemv` geometry as the single-instance kernel (no
    broadcast x rows needed - activations live in the instruction
    streams), one shared symbolic chunk template, per-slot digit-stream
    specialization, `run_per_slot` dispatch.  With ``choices`` (the
    [slot][tile] winners from `recode.select_wave`) each slot's chunk
    runs its own pre-selected digit schedule - mixed recodes across
    slots are legal because every grid slice has its own FSM.
    """
    G, k, n = x.shape[0], w.k, w.n
    reserve = recode == "auto" or ir_mod.recode_is_signed(recode)
    plan = schedule.cached_plan_gemv(k, n, w_bits, x_bits, acc_bits,
                                     reserve_neg=reserve)
    assert plan.n_blocks == w.n_blocks
    grid = ComefaGrid(G, n_blocks=plan.n_blocks, engine=engine,
                      device=device)
    costs = [[] for _ in range(G)]
    with obs_trace.span("kernel.gemv_batched", slots=G, k=k, n=n,
                        mode="per_slot", recode=recode) as sp:
        for tile in plan.tiles():
            _stage_chunk_weights(grid, plan, tile, w)
            progs = [
                plan.tile_program(
                    tile, x[g, tile.k_start:tile.k_end],
                    optimized=optimized,
                    recode=(choices[g][tile.index].recode
                            if choices is not None else recode))
                for g in range(G)]
            grid.run_per_slot(progs)
            if obs_trace.enabled():
                for g in range(G):
                    costs[g].append((plan.load_cycles(tile),
                                     progs[g].cycles,
                                     plan.unload_cycles(tile)))
        sp.set(cycles=grid.cycles)
    _KERNEL_CYCLES.inc(grid.cycles, kernel="gemv_batched",
                       mode="per_slot")
    if obs_trace.enabled():
        # one model track per slot: Perfetto shows the G digit-stream
        # pipelines side by side, makespan = the slowest slot's timeline
        for g in range(G):
            schedule.Schedule(costs[g], name=f"gemv_k{k}").emit_trace(
                track=g, name=f"slot{g}/gemv_k{k}")
    if stats is not None:
        stats["cycles"] = grid.cycles
        stats["mode"] = "per_slot"
    return _read_acc(grid, plan, n)
