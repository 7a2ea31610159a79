"""Simulator-backed CoMeFa kernels, driven by the program IR.

This module runs the paper's workloads through the bit-level
`ComefaArray` / `ComefaGrid` using `ProgramBuilder`-assembled,
IR-optimized programs: the validation backend that ties the kernel layer
to the hardware model.  Programs are built once per shape and go through
the simulator's encode cache.  Every kernel takes ``engine=`` and
``device=`` and threads them to the simulator
(`core.comefa.block.get_engine`): on a CUDA device the array runs the
CUDA step kernel unless another engine is named.

Row budgets are bounded by one block's register file (`isa.USABLE_ROWS`:
the 128 wordlines minus the reserved all-zeros/all-ones constant rows);
lane budgets are not: `comefa_dot` and `comefa_fir` spread one logical
operand across ``n_blocks * 160`` lanes of a chain=True array (Sec. III-F
shift chaining) and reduce across the whole chain, and `comefa_gemm` /
`comefa_gemv` tile whole GEMM/GEMV problems through
`core.comefa.schedule`'s double-buffered LCU plans.  The single-array
kernels (all but the GEMMs) place operands and read results through host
numpy (`layout.place` / `layout.extract`), so on a device each placement
or read after a dispatch costs the array one state round trip; results
and ``cycles`` are those of the JAX package.

The grid kernels stage operands straight into the grid's packed
device state (`ComefaGrid.write_rows`) and read results back as packed
rows (`ComefaGrid.read_rows`): `comefa_gemm_batched` (and `comefa_gemm`,
its one-slot case) each tile's operand rows, `comefa_gemv_batched` -
which grid serving
(`serve.comefa_exec.GridLinearExecutor`) calls in its broadcast,
per-slot and ``recode="auto"`` modes - per k-chunk the chunk's weight
rows (from `stage_weights`, built once per weight matrix) and each
slot's broadcast activation-bit rows, then one dispatch, with the
accumulator rows back once per call.  The state, `cycles` and outputs
are exactly those of placing through host numpy (`layout.place` on slot
views); only the grid's `host_syncs` and `device_puts` are smaller (none
and one per call).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.comefa import (ComefaArray, ComefaGrid, N_COLS, block, layout,
                           schedule)
from ..core.comefa import ir as ir_mod
from ..core.comefa import program
from ..core.comefa import recode as recode_mod
from ..core.comefa.ir import Program, RowAllocator
from ..core.comefa.isa import (Instr, N_ROWS, PRED_MASK, RESERVED_ROWS,
                               TT_COPY_A, USABLE_ROWS, ceil_log2)
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace

# modelled compute cycles per kernel invocation; the registry-side home of
# the ``stats={"cycles": ...}`` side channel (which keeps working)
_KERNEL_CYCLES = obs_metrics.counter("comefa.kernel_cycles")

# shape-keyed cache of built + optimized programs (the expensive part is
# Python-side generation): the six array kernels keep each program with
# its operand rows, the batched GEMV with its encoded engine matrix (which
# spares every dispatch the encode cache's lookup, a hash of the
# program's whole instruction tuple)
_PROGRAMS: Dict[Tuple, Tuple[Program, object]] = {}

# FIR per-sample programs are keyed by the sample *value* (the schedule
# depends on exactly its set bits), so up to 2^x_bits entries can exist -
# bounded with FIFO eviction, mirroring block.py's encode cache
_FIR_CACHE: Dict[Tuple, Program] = {}
_FIR_CACHE_MAX = 1024
_LANE0 = np.array([0])


def _eltwise_mul_program(bits: int) -> Tuple[Program, tuple]:
    key = ("eltwise_mul", bits)
    if key not in _PROGRAMS:
        b = program.ProgramBuilder(f"eltwise_mul{bits}")
        x = b.input(bits, "x")
        y = b.input(bits, "y")
        prod = b.mul(x, y)
        _PROGRAMS[key] = (b.build(), (x, y, prod))
    return _PROGRAMS[key]


def comefa_eltwise_mul(a: np.ndarray, b: np.ndarray, *, bits: int,
                       optimized: bool = True, engine=None,
                       device="cuda") -> np.ndarray:
    """Unsigned elementwise multiply on the bit-level simulator.

    Tiles the flat inputs across blocks x 160 lanes, runs one cached
    co-issued program per array (all blocks execute it SIMD), and returns
    the 2*bits-bit products.
    """
    a = np.asarray(a).ravel()
    b = np.asarray(b).ravel()
    assert a.shape == b.shape
    prog, (rx, ry, rout) = _eltwise_mul_program(bits)
    if not optimized:
        key = ("eltwise_mul_raw", bits)
        if key not in _PROGRAMS:
            raw = program.mul(rx, ry, rout)
            _PROGRAMS[key] = (raw, (rx, ry, rout))
        prog = _PROGRAMS[key][0]
    n = a.shape[0]
    lanes = N_COLS
    n_blocks = max(1, -(-n // lanes))
    pad = n_blocks * lanes - n
    a2 = np.pad(a, (0, pad)).reshape(n_blocks, lanes)
    b2 = np.pad(b, (0, pad)).reshape(n_blocks, lanes)
    arr = ComefaArray(n_blocks=n_blocks, engine=engine, device=device)
    layout.place(arr, a2, rx.base, bits)
    layout.place(arr, b2, ry.base, bits)
    arr.run(prog)
    out = layout.extract(arr, rout.base, 2 * bits)
    return out.reshape(-1)[:n]


def comefa_gemv(w: np.ndarray, x: np.ndarray, *, w_bits: int,
                x_bits: int, acc_bits: int = 32,
                optimized: bool = True,
                recode: str = "naive", engine=None,
                device="cuda") -> np.ndarray:
    """y = w.T @ x with resident weights and a streamed vector (OOOR).

    w: [k, n] unsigned ints; x: [k] unsigned ints.  The k dimension is
    chunked through `schedule.GemvPlan`'s double-buffered weight regions
    (chunk t+1 would load while chunk t computes on hardware), so k is
    not capped by the one-shot row budget.  Chunk programs are the plan's
    shared *symbolic* templates specialized per x through
    `ir.specialize_streams` (the FSM inspecting the outside operand -
    Sec. III-I): ``recode`` picks the digit schedule - ``"naive"``
    zero-skips binary bits, ``"booth"`` / ``"naf"`` stream signed digits
    (the plan reserves a complement scratch region), ``"auto"`` lets
    `core.comefa.recode.select_chunk` pick the cheapest schedule per
    chunk from its exact digit statistics - and the result is bit-exact
    under every mode.  Partial sums accumulate in the shared
    accumulator; all n outputs extract after the last chunk.
    """
    w = np.asarray(w)
    x = np.asarray(x).ravel()
    k, n = w.shape
    assert x.shape[0] == k
    # "auto" may pick a signed schedule per chunk: plan for the worst case
    reserve = recode == "auto" or ir_mod.recode_is_signed(recode)
    plan = schedule.cached_plan_gemv(k, n, w_bits, x_bits, acc_bits,
                                     reserve_neg=reserve)
    nb, lanes = plan.n_blocks, N_COLS
    pad = nb * lanes - n
    arr = ComefaArray(n_blocks=nb, engine=engine, device=device)
    costs = []
    with obs_trace.span("kernel.gemv", k=k, n=n, recode=recode) as sp:
        for tile in plan.tiles():
            buf = plan.buffers[tile.buffer]
            for j_local, j in enumerate(range(tile.k_start, tile.k_end)):
                wj = np.pad(w[j], (0, pad)).reshape(nb, lanes)
                rows = buf.weight_rows(j_local, w_bits)
                layout.place(arr, wj, rows.base, w_bits)
            prog = plan.tile_program(tile, x[tile.k_start:tile.k_end],
                                     optimized=optimized, recode=recode)
            arr.run(prog)
            if obs_trace.enabled():
                costs.append((plan.load_cycles(tile), prog.cycles,
                              plan.unload_cycles(tile)))
        sp.set(cycles=arr.cycles)
    _KERNEL_CYCLES.inc(arr.cycles, kernel="gemv", mode=recode)
    if costs:
        schedule.Schedule(costs, name=f"gemv_k{k}").emit_trace()
    out = layout.extract(arr, plan.acc.base, acc_bits)
    return out.reshape(-1)[:n]


def comefa_gemm(a: np.ndarray, b: np.ndarray, *, bits: int,
                n_blocks: int = 1, optimized: bool = True,
                engine=None, device="cuda") -> np.ndarray:
    """C = a @ b on the bit-level simulator via the tiled LCU plan.

    a: [m, k], b: [k, n] unsigned ints below 2**bits.  `schedule.plan_gemm`
    packs `dots_per_tile` output dot products per tile across the
    ``n_blocks * 160``-lane chain (each in a ``2^ceil(log2(k))``-lane
    group); the tile program - a lane-wise multiply plus a
    `program.reduce_tree` group reduction - leaves every packed dot in
    its group-head lane.  Tiles alternate between the plan's two
    double-buffered row regions (the layout that lets load/unload overlap
    compute on hardware; the simulator executes them back-to-back) and
    results drain from the head lanes after each tile.  It runs as the
    one-slot case of `comefa_gemm_batched`: the same tile programs,
    dispatched in the same order.

    Bit-exact against ``np.matmul``; with ``optimized=False`` the total
    simulator cycles are exactly ``n_tiles`` times the closed-form tile
    compute cost priced inside `timing.gemm_cycles`.
    """
    a = np.asarray(a)
    b = np.asarray(b)
    assert a.ndim == 2 and b.ndim == 2 and a.shape[1] == b.shape[0]
    m, k = a.shape
    n = b.shape[1]
    with obs_trace.span("kernel.gemm", m=m, k=k, n=n, bits=bits) as sp:
        out, plan, grid = _gemm_on_grid(a[None], b[None], bits, n_blocks,
                                        optimized, engine, device)
        sp.set(cycles=grid.cycles)
    _KERNEL_CYCLES.inc(grid.cycles, kernel="gemm", mode="chained")
    if obs_trace.enabled():
        plan.schedule(optimized=optimized).emit_trace()
    return out[0]


def comefa_dot(a: np.ndarray, b: np.ndarray, *, bits: int,
               optimized: bool = True, engine=None, device="cuda") -> int:
    """Full dot product <a, b> reduced to ONE scalar across all blocks.

    Where `comefa_gemv` stops at per-lane partial sums, this kernel
    places the two vectors one element per lane across
    ``ceil(n / 160)`` chained blocks (`layout.plan_chain`), multiplies
    lane-wise, then runs the chained tree reduction
    (`program.reduce_to_scalar`): doubling-distance shift+add steps whose
    final hops cross block boundaries through the corner PEs
    (Sec. III-F).  The scalar lands in lane 0 of block 0.

    The unoptimized reduction segment costs exactly
    `timing.chained_reduction_cycles(2 * bits, n_blocks=...)` cycles.
    """
    a = np.asarray(a).ravel()
    b = np.asarray(b).ravel()
    assert a.shape == b.shape
    n = a.shape[0]
    plan = layout.plan_chain(n)
    nb = plan.n_blocks
    steps, chain_steps = program.full_reduce_steps(nb)
    acc_bits = 2 * bits + steps + chain_steps
    demand = 2 * bits + acc_bits + (acc_bits - 1)   # x, y, acc, scratch
    assert demand <= USABLE_ROWS, (
        f"operands need {demand} rows (2 x {bits}-bit inputs + "
        f"{acc_bits}-bit accumulator + reduction scratch), only "
        f"{USABLE_ROWS} usable rows per block")
    key = ("dot", bits, nb, optimized)
    if key not in _PROGRAMS:
        bld = program.ProgramBuilder(f"dot{bits}_nb{nb}")
        rx = bld.input(bits, "x")
        ry = bld.input(bits, "y")
        acc = bld.input(acc_bits, "acc")
        bld.emit(program.mul(rx, ry, acc[:2 * bits]))
        bld.emit(program.zero_rows(acc[2 * bits:]))
        bld.reduce_all(acc, 2 * bits, n_blocks=nb)
        _PROGRAMS[key] = (bld.build(optimize=optimized), (rx, ry, acc))
    prog, (rx, ry, acc) = _PROGRAMS[key]
    arr = ComefaArray(n_blocks=nb, chain=True, engine=engine, device=device)
    plan.place(arr, a, rx.base, bits)
    plan.place(arr, b, ry.base, bits)
    arr.run(prog)
    return int(layout.extract(arr, acc.base, acc_bits, block=0)[0])


def comefa_fir(taps: np.ndarray, x: np.ndarray, *, tap_bits: int,
               x_bits: int, acc_bits: Optional[int] = None,
               optimized: bool = True, recode: str = "naive",
               engine=None, device="cuda") -> np.ndarray:
    """y[t] = sum_j taps[j] * x[t-j]: resident taps, streamed samples.

    The paper's FIR benchmark (Sec. IV-C): taps live transposed one per
    lane across ``ceil(n_taps / 160)`` chained blocks, samples stream
    through the instruction generator (OOOR).  Each sample costs one
    accumulator add per *set* sample bit plus a chained left shift of the
    partial sums - the transposed-form delay line, with partials hopping
    block seams through the corner PEs.  y[t] drains from lane 0 of
    block 0 after each sample's accumulate phase.  Sample programs are
    specialized from the symbolic `program.fir_sample_stream` template;
    ``recode`` picks the digit schedule (signed Booth/NAF modes allocate
    a tap-complement scratch region beside the accumulator).

    With ``optimized=False`` (and the default naive recoding) the total
    simulator cycles equal
    `timing.fir_cycles(len(x), x_bits, acc_bits, x_values=x)` exactly.
    """
    taps = np.asarray(taps).ravel()
    x = np.asarray(x).ravel()
    n_taps = taps.shape[0]
    plan = layout.plan_chain(n_taps)
    nb = plan.n_blocks
    if acc_bits is None:
        acc_bits = tap_bits + x_bits + ceil_log2(max(2, n_taps))
    signed = ir_mod.recode_is_signed(recode)
    demand = tap_bits + acc_bits + (tap_bits if signed else 0)
    assert demand <= USABLE_ROWS, (
        f"taps + accumulator{' + complement scratch' if signed else ''} "
        f"need {demand} rows, only {USABLE_ROWS} usable rows per block")
    alloc = RowAllocator()
    tap_rows = alloc.alloc(tap_bits, "taps")
    acc = alloc.alloc(acc_bits, "acc")
    neg = alloc.alloc(tap_bits, "neg") if signed else None
    arr = ComefaArray(n_blocks=nb, chain=True, engine=engine, device=device)
    plan.place(arr, taps, tap_rows.base, tap_bits)

    # per-phase programs are cached: repeated samples skip both
    # Python-side generation and the IR pass pipeline
    def cached(key_tail, build):
        key = (tap_bits, x_bits, acc_bits, optimized) + key_tail + (recode,)
        prog = _FIR_CACHE.get(key)
        if prog is None:
            prog = build()
            if optimized:
                prog = prog.optimize()
            if len(_FIR_CACHE) >= _FIR_CACHE_MAX:
                _FIR_CACHE.pop(next(iter(_FIR_CACHE)))   # FIFO eviction
            _FIR_CACHE[key] = prog
        return prog

    arr.run(cached(("init",), lambda: program.zero_rows(acc)))
    shift = cached(("shift",),
                   lambda: program.shift_lanes(acc, acc, left=True))
    y = np.empty(x.shape[0], dtype=np.int64)
    for t, x_t in enumerate(x):
        arr.run(cached((int(x_t),),
                       lambda: program.fir_sample(tap_rows, acc, int(x_t),
                                                  x_bits, shift=False,
                                                  recode=recode,
                                                  neg_scratch=neg)))
        # y[t] sits in lane 0 of block 0 between accumulate and shift
        y[t] = layout.extract(arr, acc.base, acc_bits, lanes=_LANE0,
                              block=0)[0]
        arr.run(shift)
    return y


# ---------------------------------------------------------------------------
# grid sweeps: G independent problem instances, one shared program stream
# (ComefaGrid: Sec. III-D shared-FSM broadcast at array-of-arrays scale)
# ---------------------------------------------------------------------------

def comefa_gemm_batched(a: np.ndarray, b: np.ndarray, *, bits: int,
                        n_blocks: int = 1, optimized: bool = True,
                        engine=None, device="cuda") -> np.ndarray:
    """C[g] = a[g] @ b[g] for G independent same-shape GEMMs on ONE grid.

    a: [G, m, k], b: [G, k, n] unsigned ints below 2**bits.  Every grid
    slot owns one problem instance; the `schedule.plan_gemm` tile
    programs depend only on the shape, so all G slots execute the same
    instruction stream per tile (one grid dispatch instead of a Python
    loop of G `ComefaArray.run` calls) and the per-slot results are
    bit-identical to G separate `comefa_gemm` calls.
    """
    a = np.asarray(a)
    b = np.asarray(b)
    assert a.ndim == 3 and b.ndim == 3 and a.shape[0] == b.shape[0]
    assert a.shape[2] == b.shape[1]
    return _gemm_on_grid(a, b, bits, n_blocks, optimized, engine,
                         device)[0]


def _gemm_on_grid(a, b, bits, n_blocks, optimized, engine, device):
    """The tiled GEMM of `comefa_gemm` in every slot of one grid.

    Each tile's operands span every lane of the chain
    (`GemmPlan.tile_operands`), so they are staged as whole packed rows
    straight into the grid's device state (`ComefaGrid.write_rows`) and
    the dot products come back from one device read of the accumulator
    rows: the state and `cycles` are exactly those of placing and
    extracting slot by slot through host numpy, without a host sync.
    Returns ``(C [G, m, n], plan, grid)``.
    """
    G, m, k = a.shape
    n = b.shape[2]
    plan = schedule.plan_gemm(m, k, n, bits, n_blocks=n_blocks)
    nb = plan.n_blocks
    assert plan.lane_span == nb * N_COLS
    grid = ComefaGrid(G, n_blocks=nb, chain=True, engine=engine,
                      device=device)
    out = np.empty((G, plan.n_outputs), dtype=np.int64)
    for tile in plan.tiles():
        buf = plan.buffers[tile.buffer]
        ops = [plan.tile_operands(tile, a[g], b[g]) for g in range(G)]
        for rows, vals in ((buf.x, [x for x, _ in ops]),
                           (buf.y, [y for _, y in ops])):
            words = layout.to_row_words(
                torch.as_tensor(np.stack(vals), device=grid.device), bits,
                nb)                                     # [G, bits, nb, W]
            grid.write_rows(range(rows.base, rows.base + bits),
                            words.transpose(-3, -2))
        grid.run(plan.compute_program(tile.buffer, optimized=optimized))
        out[:, tile.out_start:tile.out_end] = _read_lanes(
            grid, buf.acc.base, plan.acc_bits, plan.head_lanes(tile))
    return out.reshape(G, m, n), plan, grid


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
    w = w.to(device=block.resolve_device(device), dtype=torch.int64)
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


def _read_lanes(grid: ComefaGrid, base: int, n_bits: int, lanes
                ) -> np.ndarray:
    """The unsigned ``n_bits``-bit values at rows ``base...`` of the given
    global lanes (a slice or an index array) of every slot, ``[G, len]``
    int64 - one device read of the rows and one copy to the host."""
    words = grid.read_rows(range(base, base + n_bits))
    vals = layout.from_row_words(words.transpose(-3, -2))   # [G, nb*160]
    if not isinstance(lanes, slice):
        lanes = torch.as_tensor(lanes, device=vals.device)
    return vals[:, lanes].cpu().numpy()


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
    return _read_lanes(grid, plan.acc.base, plan.acc_bits, slice(0, n))


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
    return _read_lanes(grid, plan.acc.base, plan.acc_bits, slice(0, n))
