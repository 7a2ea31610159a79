"""Tiled GEMM/GEMV scheduling with load-compute-unload overlap (Sec. IV-A).

The paper's DL speedups come from keeping CoMeFa arrays *busy*: while one
tile computes bit-serially inside the RAM, the dual read/write ports
stream the next tile's operands in and the previous tile's results out -
the load-compute-unload (LCU) pipeline.  This module is the planning
layer that turns a GEMM (or a streamed GEMV) into such a tile schedule:

  * ``GemmPlan`` / ``plan_gemm`` - packs many dot products per chained
    row.  Each output element ``C[i, j]`` of an ``m x k @ k x n`` GEMM
    occupies one ``group = 2^ceil(log2(k))``-lane slice of the
    ``n_blocks * 160``-lane chain (`layout.ChainPlan` placement): a
    lane-wise multiply followed by a `program.reduce_tree` group
    reduction computes every packed dot product in parallel, leaving
    each sum in its group-head lane.  Row regions are *double-buffered*
    so the load of tile t+1 and the unload of tile t-1 can overlap tile
    t's compute; one reduction scratch region is shared (only compute
    touches it).
  * ``GemvPlan`` / ``plan_gemv`` - the streamed mapping used by
    `kernels.comefa_sim.comefa_gemv`: each lane owns one output, weights
    stay resident ``k_tile`` elements at a time (double-buffered weight
    regions lift the old one-shot row-budget cap on k), activations
    stream through the instruction generator (OOOR, Sec. III-I), and
    partial sums accumulate in a single shared accumulator across
    chunks; only the last tile unloads.
  * ``Schedule`` - the pipelined timeline.  Per-tile (load, compute,
    unload) phase costs are threaded through a three-stage pipeline with
    a buffer-reuse lag: in steady state a tile costs
    ``max(load, compute, unload)`` instead of the serial sum.

Cycle accounting: loads/unloads move 40-bit port words through each
block's own ports (blocks proceed in parallel), priced with
`timing.load_store_cycles`; compute phases are the generated IR
programs' lengths.  `timing.gemm_cycles` re-derives the GemmPlan
timeline from closed forms and the tests assert cycle-exact agreement;
`kernels/comefa_sim.comefa_gemm` executes the plan tile-by-tile on the
bit-level simulator and is bit-exact against ``np.matmul``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...obs import metrics as obs_metrics
from ...obs import trace as obs_trace
from . import ir, layout, program, timing
from .ir import Operand, Program, RowAllocator
from .isa import COL_MUX, N_COLS, USABLE_ROWS, ceil_log2

# ---------------------------------------------------------------------------
# the pipelined LCU timeline
# ---------------------------------------------------------------------------

PHASES = ("load", "compute", "unload")


@dataclasses.dataclass(frozen=True)
class PhaseSpan:
    """One phase of one tile placed on the cycle timeline."""
    tile: int
    kind: str                  # "load" | "compute" | "unload"
    start: int
    end: int

    @property
    def cycles(self) -> int:
        return self.end - self.start


class Schedule:
    """Per-tile (load, compute, unload) costs -> a pipelined timeline.

    The three phases of *different* tiles overlap: loads ride the write
    port, unloads the read port, compute owns the PEs.  Two constraints
    serialise the pipeline:

      * each engine (load port / PE / unload port) runs one tile at a
        time, in tile order;
      * row regions are reused with lag ``n_buffers`` (double buffering
        by default): tile t's load must wait for tile t-2's compute to
        release the operand buffer, and tile t's compute for tile t-2's
        unload to release the result buffer.

    With uniform tiles the steady-state cost per tile is therefore
    ``max(load, compute, unload)`` - the LCU overlap of Sec. IV-A -
    against ``load + compute + unload`` for the serial schedule.
    """

    def __init__(self, tile_costs: Sequence[Tuple[int, int, int]],
                 name: str = "lcu", n_buffers: int = 2):
        self.tile_costs = [tuple(int(c) for c in t) for t in tile_costs]
        assert all(len(t) == 3 for t in self.tile_costs)
        self.name = name
        self.n_buffers = n_buffers

    @property
    def n_tiles(self) -> int:
        return len(self.tile_costs)

    def timeline(self) -> List[PhaseSpan]:
        """Phase spans of every tile under the pipelined (LCU) schedule."""
        lag = self.n_buffers
        end_l: List[int] = []
        end_c: List[int] = []
        end_u: List[int] = []
        spans: List[PhaseSpan] = []
        for t, (load, compute, unload) in enumerate(self.tile_costs):
            sl = max(end_l[t - 1] if t >= 1 else 0,
                     end_c[t - lag] if t >= lag else 0)
            end_l.append(sl + load)
            sc = max(end_l[t],
                     end_c[t - 1] if t >= 1 else 0,
                     end_u[t - lag] if t >= lag else 0)
            end_c.append(sc + compute)
            su = max(end_c[t], end_u[t - 1] if t >= 1 else 0)
            end_u.append(su + unload)
            spans.append(PhaseSpan(t, "load", sl, end_l[t]))
            spans.append(PhaseSpan(t, "compute", sc, end_c[t]))
            spans.append(PhaseSpan(t, "unload", su, end_u[t]))
        return spans

    @property
    def total_cycles(self) -> int:
        """Makespan of the pipelined timeline."""
        if not self.tile_costs:
            return 0
        return max(s.end for s in self.timeline())

    @property
    def serial_cycles(self) -> int:
        """The unpipelined sum: every phase of every tile back-to-back."""
        return sum(sum(t) for t in self.tile_costs)

    @property
    def steady_state_cycles(self) -> int:
        """Per-tile cost once the pipeline is full: the bottleneck phase."""
        if not self.tile_costs:
            return 0
        return max(max(t) for t in self.tile_costs)

    @property
    def serial_tile_cycles(self) -> int:
        """Per-tile cost of the serial schedule (worst tile)."""
        if not self.tile_costs:
            return 0
        return max(sum(t) for t in self.tile_costs)

    def verify(self) -> list:
        """Re-check this timeline against the pipeline invariants.

        Delegates to `verify.verify_schedule`: per-tile phase ordering,
        one-tile-at-a-time engine serialization, and the ``n_buffers``
        double-buffer reuse lag.  Returns the `Diagnostic` list (empty
        when the schedule is legal).
        """
        from . import verify as _verify   # deferred: verify imports ir
        return _verify.verify_schedule(self)

    def emit_trace(self, track: int = 0, base_cycle: int = 0,
                   name: Optional[str] = None) -> int:
        """Emit this timeline onto the tracer's modeled-cycles track.

        Every nonzero phase span becomes one `obs.trace.model_span`
        (ts/dur in cycles, offset by ``base_cycle``) named
        ``<name>/<phase>``, tagged with its tile index.  ``track``
        separates concurrent timelines - per-slot grid schedules pass
        their slot index so Perfetto renders the G pipelines side by
        side, load/compute/unload overlap visible per tile.  No-op when
        tracing is disabled; returns the number of spans emitted.
        """
        if not obs_trace.enabled():
            return 0
        label = name if name is not None else self.name
        emitted = 0
        for s in self.timeline():
            if s.cycles == 0:
                continue
            obs_trace.model_span(f"{label}/{s.kind}", base_cycle + s.start,
                                 s.cycles, track_id=track, tile=s.tile,
                                 phase=s.kind)
            emitted += 1
        return emitted

    def __repr__(self):
        return (f"Schedule({self.name!r}: {self.n_tiles} tiles, "
                f"{self.total_cycles} cycles pipelined / "
                f"{self.serial_cycles} serial)")


# ---------------------------------------------------------------------------
# GEMM: many dot products packed per chain, tree-reduced per group
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GemmBuffer:
    """Row regions of one double-buffer slot (x, y operands + accumulator)."""
    index: int
    x: Operand
    y: Operand
    acc: Operand


@dataclasses.dataclass(frozen=True)
class GemmTile:
    """One tile: a contiguous range of flattened output indices."""
    index: int
    out_start: int
    out_end: int
    buffer: int                # which GemmBuffer the tile occupies

    @property
    def n_dots(self) -> int:
        return self.out_end - self.out_start


# shape-keyed cache of tile compute programs (two per plan shape - one per
# double-buffer slot; the row map is deterministic in (bits, steps, slot))
_TILE_PROGRAMS: Dict[Tuple, Program] = {}

# digit-stream-keyed cache of *specialized* (and optimized) GEMV chunk
# programs: decode sweeps re-stream the same small activation chunks
# constantly (zeros and tiny values dominate), and the digit stream is a
# pure function of (values, recode), so the concrete expansion - and its
# pass-pipeline output - can be reused verbatim.  FIFO-bounded like the
# kernel-layer FIR cache; hit/miss counts land in the `repro_torch.obs`
# registry (surfaced as a derived rate by `obs.export.metrics_summary`).
_SPEC_PROGRAMS: Dict[Tuple, Program] = {}
_SPEC_PROGRAMS_MAX = 4096
_SPEC_CACHE = obs_metrics.counter("comefa.spec_cache")


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """Tiling of ``m x k @ k x n`` onto an ``n_blocks``-block chained array.

    Output element ``C[i, j]`` (flattened index ``i * n + j``) number p of
    a tile occupies lanes ``[p * group, p * group + k)`` of the
    ``n_blocks * 160``-lane chain: A's row i in the x rows, B's column j
    in the y rows, unused lanes zero-padded.  The tile program multiplies
    lane-wise into the accumulator's low half, zeroes the `steps` guard
    rows, and runs `program.reduce_tree` so each group head ends with its
    dot product; groups may straddle block seams (the corner-PE chaining
    of Sec. III-F carries the partial sums across).
    """
    m: int
    k: int
    n: int
    bits: int
    n_blocks: int
    group: int                 # lanes per packed dot product (2^steps)
    steps: int                 # reduction tree depth = ceil(log2(k))
    acc_bits: int              # 2 * bits + steps
    dots_per_tile: int
    n_tiles: int
    buffers: Tuple[GemmBuffer, GemmBuffer]
    scratch: Operand

    # -- geometry ----------------------------------------------------------
    @property
    def lane_span(self) -> int:
        return self.n_blocks * N_COLS

    @property
    def n_outputs(self) -> int:
        return self.m * self.n

    def lane_plan(self) -> layout.ChainPlan:
        """Full-span linear placement (element j -> global lane j)."""
        return layout.ChainPlan(n_elems=self.lane_span,
                                n_blocks=self.n_blocks)

    def tiles(self) -> List[GemmTile]:
        d = self.dots_per_tile
        return [GemmTile(t, t * d, min((t + 1) * d, self.n_outputs), t % 2)
                for t in range(self.n_tiles)]

    def head_lanes(self, tile: GemmTile) -> np.ndarray:
        """Global lanes holding the tile's dot products after reduction."""
        return np.arange(tile.n_dots) * self.group

    def tile_operands(self, tile: GemmTile, a: np.ndarray,
                      b: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Lane-major operand vectors for one tile (zero-padded).

        Padding is part of the load: stale lanes from the previous tile
        in this buffer would otherwise pollute the group sums.
        """
        a = np.asarray(a)
        b = np.asarray(b)
        xv = np.zeros(self.lane_span, dtype=np.int64)
        yv = np.zeros(self.lane_span, dtype=np.int64)
        for p, o in enumerate(range(tile.out_start, tile.out_end)):
            i, j = divmod(o, self.n)
            xv[p * self.group:p * self.group + self.k] = a[i]
            yv[p * self.group:p * self.group + self.k] = b[:, j]
        return xv, yv

    # -- per-phase cycle costs --------------------------------------------
    @property
    def load_cycles(self) -> int:
        """Port cycles to stream one tile's x and y rows in.

        Each block loads through its own write port in parallel, so the
        cost is one block's traffic: the full 160-lane span of both
        operands (ragged tiles still write the zero padding - stale
        lanes must be cleared), one bit-slice word per 40 lanes per row.
        """
        return 2 * timing.load_store_cycles(N_COLS, self.bits)

    def unload_cycles(self, tile: GemmTile) -> int:
        """Port cycles to drain the tile's group-head accumulators.

        A 40-bit port word covers the 40 lanes of one column-mux phase;
        heads land at multiples of `group`, so per block only the words
        of the phases that actually hold heads are read.  Blocks drain
        in parallel - the cost is the busiest block's traffic.
        """
        per_block: Dict[int, set] = {}
        for lane in self.head_lanes(tile):
            per_block.setdefault(int(lane) // N_COLS,
                                 set()).add(int(lane) % COL_MUX)
        if not per_block:
            return 0
        return self.acc_bits * max(len(p) for p in per_block.values())

    def compute_program(self, buffer: int, optimized: bool = True) -> Program:
        """The tile compute program for one double-buffer slot (cached)."""
        key = ("gemm", self.bits, self.steps, buffer, optimized)
        prog = _TILE_PROGRAMS.get(key)
        if prog is None:
            buf = self.buffers[buffer]
            low = 2 * self.bits
            prog = program.mul(buf.x, buf.y, buf.acc[:low])
            prog += program.zero_rows(buf.acc[low:])
            in_block = min(self.steps, ceil_log2(N_COLS))
            prog += program.reduce_tree(
                buf.acc, self.scratch, low, in_block,
                chain_steps=self.steps - in_block)
            prog = prog.with_live_out(set(buf.acc))
            prog.name = f"gemm_tile_b{self.bits}_s{self.steps}_buf{buffer}"
            if optimized:
                prog = prog.optimize()
            _TILE_PROGRAMS[key] = prog
        return prog

    def compute_cycles(self, optimized: bool = True) -> int:
        return self.compute_program(0, optimized=optimized).cycles

    # -- the schedule ------------------------------------------------------
    def schedule(self, optimized: bool = True) -> Schedule:
        c = self.compute_cycles(optimized=optimized)
        costs = [(self.load_cycles, c, self.unload_cycles(t))
                 for t in self.tiles()]
        return Schedule(costs, name=f"gemm{self.m}x{self.k}x{self.n}")

    def verify(self) -> list:
        """Row-region legality diagnostics (`verify.verify_plan`)."""
        from . import verify as _verify   # deferred: verify imports ir
        return _verify.verify_plan(
            self, name=f"gemm{self.m}x{self.k}x{self.n}")


def plan_gemm(m: int, k: int, n: int, bits: int,
              n_blocks: int = 1) -> GemmPlan:
    """Tile an ``m x k @ k x n`` unsigned GEMM onto `n_blocks` chained RAMs.

    Raises ``ValueError`` when a single dot product cannot fit the chain
    (``2^ceil(log2(k)) > n_blocks * 160`` lanes) or the double-buffered
    row regions exceed the block's usable wordlines.
    """
    assert m >= 1 and k >= 1 and n >= 1 and bits >= 1
    steps = ceil_log2(k)
    group = 1 << steps
    span = n_blocks * N_COLS
    if group > span:
        raise ValueError(
            f"k={k} needs a {group}-lane reduction group; {n_blocks} "
            f"block(s) give only {span} lanes - raise n_blocks")
    acc_bits = 2 * bits + steps
    demand = 2 * (2 * bits + acc_bits) + max(1, acc_bits - 1)
    if demand > USABLE_ROWS:
        raise ValueError(
            f"double-buffered tiles need {demand} rows (2 x ({bits}-bit "
            f"x + {bits}-bit y + {acc_bits}-bit acc) + shared reduction "
            f"scratch), only {USABLE_ROWS} usable rows per block")
    alloc = RowAllocator()
    buffers = []
    for i in range(2):
        buffers.append(GemmBuffer(
            index=i,
            x=alloc.alloc(bits, f"x{i}"),
            y=alloc.alloc(bits, f"y{i}"),
            acc=alloc.alloc(acc_bits, f"acc{i}")))
    scratch = alloc.alloc(max(1, acc_bits - 1), "scratch")
    dots = span // group
    n_tiles = -(-(m * n) // dots)
    return GemmPlan(m=m, k=k, n=n, bits=bits, n_blocks=n_blocks,
                    group=group, steps=steps, acc_bits=acc_bits,
                    dots_per_tile=dots, n_tiles=n_tiles,
                    buffers=(buffers[0], buffers[1]), scratch=scratch)


# ---------------------------------------------------------------------------
# GEMV: outputs resident one per lane, activations streamed (OOOR),
# weights chunked through double-buffered row regions
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GemvBuffer:
    """One double-buffer slot holding `k_tile` resident weight operands."""
    index: int
    rows: Operand              # k_tile * w_bits contiguous rows

    def weight_rows(self, j: int, w_bits: int) -> Operand:
        return Operand(self.rows[j * w_bits:(j + 1) * w_bits], f"w{j}")


@dataclasses.dataclass(frozen=True)
class GemvTile:
    """One chunk of the k dimension."""
    index: int
    k_start: int
    k_end: int
    buffer: int

    @property
    def n_elems(self) -> int:
        return self.k_end - self.k_start


@dataclasses.dataclass(frozen=True)
class GemvPlan:
    """k-chunked streamed GEMV: ``y = w.T @ x`` with lanes owning outputs.

    Chunk t's weights load into buffer ``t % 2`` while chunk t-1
    computes; every chunk's OOOR program accumulates into the one shared
    accumulator (so only the final tile pays an unload).  This lifts the
    old `comefa_gemv` cap of ``k * w_bits + acc_bits <= USABLE_ROWS`` -
    any k now schedules as ``ceil(k / k_tile)`` tiles.

    Chunk programs are emitted *symbolically* (`program.ooor_dot_stream`
    templates shared across every x) and specialized per activation
    vector through `ir.specialize_streams`; planning with
    ``reserve_neg=True`` additionally sets aside a `neg` scratch region
    so signed recodings (Booth/NAF) can complement a weight in place.
    """
    k: int
    n: int
    w_bits: int
    x_bits: int
    acc_bits: int
    n_blocks: int
    k_tile: int
    n_tiles: int
    buffers: Tuple[GemvBuffer, GemvBuffer]
    acc: Operand
    neg: Optional[Operand] = None

    def tiles(self) -> List[GemvTile]:
        return [GemvTile(t, t * self.k_tile,
                         min((t + 1) * self.k_tile, self.k), t % 2)
                for t in range(self.n_tiles)]

    # -- per-phase cycle costs --------------------------------------------
    def load_cycles(self, tile: GemvTile) -> int:
        """Per-block port cycles to stream one chunk's weight rows in."""
        return tile.n_elems * timing.load_store_cycles(N_COLS, self.w_bits)

    def unload_cycles(self, tile: GemvTile) -> int:
        """Only the last tile drains the accumulator (every lane holds an
        output, so all `COL_MUX` phases of every acc row are read)."""
        if tile.index != self.n_tiles - 1:
            return 0
        return self.acc_bits * COL_MUX

    def symbolic_chunk_program(self, tile: GemvTile) -> Program:
        """The shared, value-independent chunk template (cached per shape).

        One `StreamMac` per resident weight: stream index j names element
        j of the chunk's activation slice.  Tile 0 zeroes the accumulator
        first; later chunks add on top.  Every x-vector's concrete chunk
        program - and every recoding of it - is a specialization of this
        one object, which is what lets the batched grid sweep share the
        template across slots while each slot streams its own digits.
        """
        key = ("gemv_sym", self.w_bits, self.x_bits, self.acc_bits,
               self.k_tile, tile.n_elems, tile.buffer, tile.index == 0,
               self.neg is not None)
        prog = _TILE_PROGRAMS.get(key)
        if prog is None:
            buf = self.buffers[tile.buffer]
            weights = [buf.weight_rows(j, self.w_bits)
                       for j in range(tile.n_elems)]
            prog = program.ooor_dot_stream(
                weights, self.x_bits, self.acc, neg_scratch=self.neg,
                zero_acc=tile.index == 0)
            prog.name = f"gemv_chunk{tile.index}"
            prog.live_out = frozenset(self.acc)
            _TILE_PROGRAMS[key] = prog
        return prog

    def tile_program(self, tile: GemvTile, x_chunk: Sequence[int],
                     optimized: bool = True,
                     recode: str = "naive") -> Program:
        """OOOR accumulate of one streamed chunk (value-dependent).

        `ir.specialize_streams` binds the chunk's activation slice to the
        shared symbolic template: only *nonzero digits* of each recoded
        activation cost adds (the zero-bit skipping of Sec. III-I;
        ``recode`` in {"naive", "booth", "naf"} picks the digit set -
        signed modes need a plan built with ``reserve_neg=True`` - and
        ``"auto"`` lets `recode.select_chunk` pick the cheapest legal
        schedule for this chunk's exact digit statistics).

        Specialized programs are cached on their digit stream: the
        template's shape key plus ``(recode, values)``, which the digits
        are a pure function of.  Repeated activation chunks - the common
        decode case - skip both re-specialization and the pass pipeline.
        """
        assert len(x_chunk) == tile.n_elems
        values = tuple(int(v) for v in x_chunk)
        if recode == "auto":
            from . import recode as recode_mod   # deferred: imports us
            recode = recode_mod.select_chunk(values, self, tile).recode
        if not isinstance(recode, str):          # custom recoder callable
            prog = ir.specialize_streams(self.symbolic_chunk_program(tile),
                                         list(values), recode=recode)
            return prog.optimize() if optimized else prog
        key = ("gemv_spec", self.w_bits, self.x_bits, self.acc_bits,
               self.k_tile, tile.n_elems, tile.buffer, tile.index == 0,
               self.neg is not None, optimized, recode, values)
        prog = _SPEC_PROGRAMS.get(key)
        if prog is None:
            _SPEC_CACHE.inc(event="misses")
            prog = ir.specialize_streams(self.symbolic_chunk_program(tile),
                                         list(values), recode=recode)
            prog.name = f"gemv_chunk{tile.index}@{recode}"
            if optimized:
                prog = prog.optimize()
            if len(_SPEC_PROGRAMS) >= _SPEC_PROGRAMS_MAX:
                _SPEC_PROGRAMS.pop(next(iter(_SPEC_PROGRAMS)))  # FIFO
            _SPEC_PROGRAMS[key] = prog
        else:
            _SPEC_CACHE.inc(event="hits")
        return prog

    def schedule(self, x: Sequence[int], optimized: bool = True,
                 recode: str = "naive") -> Schedule:
        x = [int(v) for v in x]
        assert len(x) == self.k
        costs = []
        for t in self.tiles():
            prog = self.tile_program(t, x[t.k_start:t.k_end],
                                     optimized=optimized, recode=recode)
            costs.append((self.load_cycles(t), prog.cycles,
                          self.unload_cycles(t)))
        return Schedule(costs, name=f"gemv_k{self.k}")

    def verify(self) -> list:
        """Row-region legality diagnostics (`verify.verify_plan`)."""
        from . import verify as _verify   # deferred: verify imports ir
        return _verify.verify_plan(self, name=f"gemv_k{self.k}")


def gemv_k_tile(w_bits: int, acc_bits: int,
                reserve_neg: bool = False) -> int:
    """Largest weight chunk fitting two buffers beside the accumulator.

    With ``reserve_neg`` a `w_bits`-row complement scratch region is
    carved out too (signed Booth/NAF digit streams subtract through it).
    """
    return (USABLE_ROWS - acc_bits
            - (w_bits if reserve_neg else 0)) // (2 * w_bits)


def plan_gemv(k: int, n: int, w_bits: int, x_bits: int,
              acc_bits: int = 32, k_tile: Optional[int] = None,
              reserve_neg: bool = False) -> GemvPlan:
    """Chunk a length-k streamed GEMV over ``ceil(n / 160)`` SIMD blocks.

    No chaining is needed: every lane owns one independent output, and
    all blocks execute the same chunk program (Sec. III-D shared FSM).
    ``reserve_neg`` sets aside the complement scratch rows signed
    recodings (Booth/NAF digit streams) subtract through; the default
    keeps the naive-OOOR geometry unchanged.
    """
    assert k >= 1 and n >= 1
    max_tile = gemv_k_tile(w_bits, acc_bits, reserve_neg=reserve_neg)
    if max_tile < 1:
        raise ValueError(
            f"no room for even one double-buffered {w_bits}-bit weight "
            f"beside a {acc_bits}-bit accumulator"
            f"{' and a complement scratch' if reserve_neg else ''} "
            f"({USABLE_ROWS} usable rows)")
    if k_tile is None:
        k_tile = min(k, max_tile)
    if not 1 <= k_tile <= max_tile:
        raise ValueError(f"k_tile={k_tile} outside [1, {max_tile}]")
    alloc = RowAllocator()
    buffers = tuple(GemvBuffer(i, alloc.alloc(k_tile * w_bits, f"wbuf{i}"))
                    for i in range(2))
    acc = alloc.alloc(acc_bits, "acc")
    neg = alloc.alloc(w_bits, "neg") if reserve_neg else None
    n_blocks = max(1, -(-n // N_COLS))
    n_tiles = -(-k // k_tile)
    return GemvPlan(k=k, n=n, w_bits=w_bits, x_bits=x_bits,
                    acc_bits=acc_bits, n_blocks=n_blocks, k_tile=k_tile,
                    n_tiles=n_tiles, buffers=buffers, acc=acc, neg=neg)


# shape-keyed memoized GEMV plans: a decode sweep re-plans the identical
# projection geometry on every wave of every token; `GemvPlan` is a frozen
# dataclass the kernels use read-only, so one instance per shape is safe
# to share.  Bounded FIFO (shape diversity is tiny in practice); hit/miss
# counts land in the `repro_torch.obs` registry.
_PLAN_CACHE: Dict[Tuple, GemvPlan] = {}
_PLAN_CACHE_MAX = 256
_PLAN_STATS = obs_metrics.counter("comefa.plan_cache")


def cached_plan_gemv(k: int, n: int, w_bits: int, x_bits: int,
                     acc_bits: int = 32, k_tile: Optional[int] = None,
                     reserve_neg: bool = False) -> GemvPlan:
    """Memoizing front end to `plan_gemv` (same arguments and errors).

    The returned plan is shared across callers - treat it as immutable
    (it already is: a frozen dataclass whose operands are fixed row
    ranges).
    """
    key = (k, n, w_bits, x_bits, acc_bits, k_tile, reserve_neg)
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        _PLAN_STATS.inc(event="misses")
        plan = plan_gemv(k, n, w_bits, x_bits, acc_bits=acc_bits,
                         k_tile=k_tile, reserve_neg=reserve_neg)
        if len(_PLAN_CACHE) >= _PLAN_CACHE_MAX:
            _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))     # FIFO
        _PLAN_CACHE[key] = plan
    else:
        _PLAN_STATS.inc(event="hits")
    return plan
