"""Batched multi-array simulation: a fleet of CoMeFa arrays as ONE dispatch.

The paper's system-level speedups come from driving *many* CoMeFa RAMs in
parallel from shared instruction-generation FSMs (Sec. III-D): every RAM
executes the same instruction each cycle on its own data.  `ComefaArray`
already models that SIMD broadcast across the blocks of one array;
`ComefaGrid` lifts it one level up, to a *grid* of G independent arrays:

  * state is stacked - ``mem[G, n_blocks, 128, 160]`` plus carry/mask
    ``[G, n_blocks, 160]`` - instead of G separate python objects;
  * one shared program executes across all G slots in a single dispatch
    over the stacked state (every engine's step is rank-polymorphic, and
    the CUDA kernel runs one CTA per slot), so a fleet-scale sweep costs
    one dispatch rather than G python-loop dispatches;
  * programs go through the same keyed encode cache as `ComefaArray`
    (`block.encoded`), so sweeps re-running structurally equal programs
    never re-encode;
  * whole packed rows can be written into and read out of the device
    state (`write_rows` / `read_rows`) without a host round trip - how
    `kernels.comefa_sim` stages weights and activation bits.

Semantics contract (pinned by the tests): slot g of ``ComefaGrid.run(p)``
is bit-identical - mem, carry, mask, and cycle counts - to an independent
``ComefaArray.run(p)`` on the same initial state, including ``chain=True``
corner-PE threading and ``run_programs`` latch-reset boundaries.  The grid
never chains *across* slots: slots are independent arrays, each with its
own (optionally chained) block row.

Given a `torch.distributed` `DeviceMesh` (`grid_mesh`), the slot axis is
sharded over its ranks through the ``"grid"`` rule of
`parallel.sharding` (`grid_shardings`): the device state is three
`DTensor`s, each rank holds and runs its own slots (the engine runs on
its shard through `local_map`, on a card the CUDA step kernel: nothing
is swapped), host reads gather and writes reach the rank that holds the
slot.  Every rank runs the same calls, as under SPMD, and the counters
(`cycles`, `dispatches`, `io_words`) count as an unsharded grid's do.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import local_map

from ...obs import trace as obs_trace
from ...parallel import sharding as shd
from . import block, engine_packed, isa, verify
from .block import (ComefaArray, encoded, read_port_word, write_port_word)
from .isa import N_COLS, N_ROWS, ROW_ONES


# per-slot program matrices are padded up to a multiple of this quantum so
# the number of distinct program lengths stays bounded across a sweep of
# value-dependent program lengths
_SLOT_PAD_QUANTUM = 32


class _Slot:
    """Per-slot view of grid state, duck-typed like a `ComefaArray`.

    `layout.place` / `layout.extract` / `ChainPlan` only touch ``.mem``
    and ``.n_blocks``, so a numpy view over one grid slot lets every
    existing placement helper address the grid slot-by-slot; hybrid-mode
    port words account their traffic to the owning grid.
    """

    def __init__(self, grid: "ComefaGrid", g: int):
        self._grid = grid
        self.index = g
        self.n_blocks = grid.n_blocks
        self.chain = grid.chain

    @property
    def mem(self) -> np.ndarray:
        return self._grid.mem[self.index]

    @property
    def carry(self) -> np.ndarray:
        return self._grid.carry[self.index]

    @property
    def mask(self) -> np.ndarray:
        return self._grid.mask[self.index]

    def write_word(self, blk: int, addr: int, word: int) -> None:
        write_port_word(self.mem, blk, addr, word)
        self._grid.io_words += 1

    def read_word(self, blk: int, addr: int) -> int:
        word = read_port_word(self.mem, blk, addr)
        self._grid.io_words += 1  # a rejected address counts no traffic
        return word


def _row_index(rows: Sequence[int]):
    """Row numbers -> a slice when they are consecutive, else a list."""
    if isinstance(rows, range) and rows.step == 1:
        return slice(rows.start, rows.stop)
    rows = [int(r) for r in rows]
    if rows and rows == list(range(rows[0], rows[0] + len(rows))):
        return slice(rows[0], rows[0] + len(rows))
    return rows


class ComefaGrid:
    """G independent CoMeFa arrays executing one shared program per dispatch.

    Models a fleet of arrays whose instruction FSMs broadcast the same
    stream (the paper's array-of-arrays evaluation scale): state is G
    stacked `ComefaArray` states on `device`, and `run`/`run_programs`
    execute across every slot in a single dispatch.  The engine follows
    the device unless one is named (`block.get_engine`).  Pass a
    `DeviceMesh` (`grid_mesh`) to shard the slot axis over its ranks
    (`rules` override the ``"grid"`` rule; a grid that the ranks do not
    divide is replicated).
    """

    def __init__(self, g: int, n_blocks: int = 1, chain: bool = False,
                 mesh=None, rules=None, engine=None, device="cuda"):
        assert g >= 1
        self.g = g
        self.n_blocks = n_blocks
        self.chain = chain
        self.device = block.resolve_device(device)
        self.engine = block.get_engine(engine, self.device)
        self.mesh = mesh
        self._where = None
        if mesh is not None:
            if mesh.device_type != self.device.type:
                raise ValueError(f"the mesh lies on {mesh.device_type}, "
                                 f"the grid on {self.device}")
            self._where = grid_shardings(mesh, g, n_blocks, rules)
        self.cycles = 0           # per-slot compute cycles (slots run in lockstep)
        self.io_words = 0         # port words moved across ALL slots
        self.reset()

    # -- state ------------------------------------------------------------
    def reset(self) -> None:
        mem = np.zeros((self.g, self.n_blocks, N_ROWS, N_COLS),
                       dtype=np.uint8)
        mem[:, :, ROW_ONES, :] = 1
        self._mem = mem
        self._carry = np.zeros((self.g, self.n_blocks, N_COLS),
                               dtype=np.uint8)
        self._mask = np.zeros((self.g, self.n_blocks, N_COLS),
                              dtype=np.uint8)
        self._dev = None          # engine-format device state, when ahead
        self.cycles = 0
        self.io_words = 0
        self.host_syncs = 0       # device->host state materializations
        self.device_puts = 0      # host->device state uploads
        self.dispatches = 0       # engine runs (kernel launches on "cuda")

    # same lazy host/device state contract as `ComefaArray`: device
    # buffers chain between dispatches; any host access materializes
    # writable numpy (dropping the device copy, since callers mutate the
    # result in place via slot views / placements)
    def _sync_host(self) -> None:
        if self._dev is not None:
            with obs_trace.span("grid.host_sync", engine=self.engine.name,
                                slots=self.g):
                dev = self._dev
                if self.mesh is not None:          # gather every slot
                    dev = tuple(x.full_tensor() for x in dev)
                self._mem, self._carry, self._mask = self.engine.to_host(
                    dev)
            self._dev = None
            self.host_syncs += 1
            block._HOST_SYNCS.inc(kind="grid")

    @property
    def mem(self) -> np.ndarray:
        self._sync_host()
        return self._mem

    @mem.setter
    def mem(self, value):
        self._sync_host()         # keep carry/mask coherent before replacing
        self._mem = np.asarray(value)

    @property
    def carry(self) -> np.ndarray:
        self._sync_host()
        return self._carry

    @carry.setter
    def carry(self, value):
        self._sync_host()
        self._carry = np.asarray(value)

    @property
    def mask(self) -> np.ndarray:
        self._sync_host()
        return self._mask

    @mask.setter
    def mask(self, value):
        self._sync_host()
        self._mask = np.asarray(value)

    def slot(self, g: int) -> _Slot:
        """Array-like view of slot g (usable with `layout` helpers)."""
        assert 0 <= g < self.g
        return _Slot(self, g)

    def slots(self) -> List[_Slot]:
        return [self.slot(g) for g in range(self.g)]

    # -- packed rows on the device -----------------------------------------
    def write_rows(self, rows: Sequence[int], words: torch.Tensor) -> None:
        """Overwrite whole rows of every slot's device state.

        ``words`` holds packed lane words (`engine_packed.pack_bits`
        layout, int32) broadcastable to ``[G, n_blocks, len(rows), 5]``.
        The state stays on the device: no host sync, and an upload only
        if the host copy was ahead.
        """
        self._ensure_device()
        shape = (self.g, self.n_blocks, len(rows), engine_packed.N_WORDS)
        index, engine = _row_index(rows), self.engine
        words = words.expand(shape)
        if self.mesh is None:
            self._dev = engine.write_rows(self._dev, index, words)
            return
        # every rank holds the same words; each keeps its slots' (a local
        # cut of a replicated tensor, no collective)
        words = DTensor.from_local(words, self.mesh,
                                   [Replicate()] * self.mesh.ndim,
                                   run_check=False)
        mem_at, latch_at, _ = self._where
        self._dev = local_map(
            lambda m, c, k, w: engine.write_rows((m, c, k), index, w),
            out_placements=(mem_at, latch_at, latch_at),
            in_placements=(mem_at, latch_at, latch_at, mem_at),
            device_mesh=self.mesh, redistribute_inputs=True)(
                *self._dev, words)

    def read_rows(self, rows: Sequence[int]) -> torch.Tensor:
        """Packed words ``[G, n_blocks, len(rows), 5]`` int32 of the given
        rows of every slot, read on the device (no host sync; on a mesh
        every rank gathers every slot's)."""
        self._ensure_device()
        index, engine = _row_index(rows), self.engine
        if self.mesh is None:
            return engine.read_rows(self._dev, index)
        mem_at, latch_at, _ = self._where
        return local_map(
            lambda m, c, k: engine.read_rows((m, c, k), index),
            out_placements=list(mem_at),      # a list: one output
            in_placements=(mem_at, latch_at, latch_at),
            device_mesh=self.mesh)(*self._dev).full_tensor()

    @classmethod
    def from_arrays(cls, arrays: Sequence[ComefaArray], mesh=None,
                    rules=None) -> "ComefaGrid":
        """Stack G equal-shape arrays (state is copied) into one grid.

        Accounting carries over where it is well-defined: `io_words`
        sums across the sources, and `cycles` is inherited when every
        source agrees (the lockstep invariant) - arrays with divergent
        histories restart the grid's lockstep count at 0.
        """
        assert arrays
        nb = arrays[0].n_blocks
        chain = arrays[0].chain
        assert all(a.n_blocks == nb and a.chain == chain for a in arrays), \
            "grid slots must agree on n_blocks and chain"
        grid = cls(len(arrays), n_blocks=nb, chain=chain, mesh=mesh,
                   rules=rules, engine=arrays[0].engine,
                   device=arrays[0].device)
        for g, a in enumerate(arrays):
            grid.mem[g] = a.mem
            grid.carry[g] = a.carry
            grid.mask[g] = a.mask
        if len({a.cycles for a in arrays}) == 1:
            grid.cycles = arrays[0].cycles
        grid.io_words = sum(a.io_words for a in arrays)
        return grid

    def to_arrays(self) -> List[ComefaArray]:
        """Split back into G independent arrays (state is copied).

        Each array inherits the grid's lockstep `cycles`; `io_words`
        was accounted grid-wide and cannot be attributed per slot, so
        the split arrays restart it at 0.
        """
        out = []
        for g in range(self.g):
            a = ComefaArray(n_blocks=self.n_blocks, chain=self.chain,
                            engine=self.engine, device=self.device)
            a.mem = self.mem[g].copy()
            a.carry = self.carry[g].copy()
            a.mask = self.mask[g].copy()
            a.cycles = self.cycles
            out.append(a)
        return out

    # -- execution ---------------------------------------------------------
    def run(self, program) -> int:
        """Execute one shared program on every slot.  Returns the per-slot
        processing cycles (identical across slots - one FSM, one stream).
        """
        with obs_trace.span("grid.run", program=block._prog_label(program),
                            slots=self.g) as sp:
            cycles = self._dispatch(encoded(program))
            sp.set(cycles=cycles)
        return cycles

    def run_programs(self, programs, reset_latches: bool = True) -> List[int]:
        """Back-to-back programs in ONE dispatch, across all slots.

        Same contract as `ComefaArray.run_programs`: with `reset_latches`
        a one-cycle `isa.latch_clear` is inserted at every boundary
        (charged to the following program), so no program's carry/mask
        latches leak into the next.  Returns per-program cycle counts.
        """
        programs = list(programs)
        with obs_trace.span("grid.run_programs", n=len(programs),
                            slots=self.g) as sp:
            verify.maybe_verify_batch(programs, reset_latches)
            mats = [encoded(p) for p in programs]
            if not mats:
                return []
            mat, counts = block._concat_encoded(mats, reset_latches)
            sp.set(cycles=self._dispatch(mat))
        return counts

    def run_per_slot(self, programs: Sequence) -> List[int]:
        """Execute a DIFFERENT program on every slot, in one dispatch.

        `programs[g]` runs on slot g - the per-slice-FSM configuration:
        each slice of the fleet streams its own operand digits (the
        per-slot stream specialization of `ir.specialize_streams`),
        instead of every slice executing one broadcast stream.  Shorter
        programs pad with no-op cycles (all control fields idle) up to
        the longest slot rounded up to `_SLOT_PAD_QUANTUM`, so slots stay
        independent and bit-identical to isolated `ComefaArray.run`
        calls; padding is simulator bookkeeping only - `cycles` advances
        by the *longest real* program (the dispatch makespan: slices run
        concurrently, the slowest bounds the wall-clock) and the returned
        list gives every slot's own cycle count.
        """
        assert len(programs) == self.g, (len(programs), self.g)
        with obs_trace.span("grid.run_per_slot", slots=self.g) as sp:
            mats = [encoded(p) for p in programs]
            counts = [int(m.shape[0]) for m in mats]
            longest = max(counts, default=0)
            if longest == 0:
                return counts
            t_pad = -(-longest // _SLOT_PAD_QUANTUM) * _SLOT_PAD_QUANTUM
            stack = np.zeros((self.g, t_pad, isa.N_ENGINE_FIELDS),
                             dtype=np.int32)   # zero fields == idle cycle
            for g, m in enumerate(mats):
                stack[g, :m.shape[0]] = m
            engine = self.engine
            # makespan = the longest real program: slices run concurrently,
            # the slowest bounds the dispatch
            sp.set(engine=engine.name, makespan=longest,
                   min_slot_cycles=min(counts), padded_to=t_pad)
            self._ensure_device()
            if self.mesh is None:
                self._dev = engine.run_per_slot(self._dev, stack,
                                                self.chain)
            else:
                # each rank runs its own slots' programs
                lo, n = self._local_slots()
                mine = np.ascontiguousarray(stack[lo:lo + n])
                self._on_shards(lambda st: engine.run_per_slot(
                    st, mine, self.chain))
            self.cycles += longest
            self.dispatches += 1
            block._DISPATCHES.inc(kind="grid", engine=engine.name)
            block._DISPATCH_CYCLES.inc(longest, kind="grid",
                                       engine=engine.name)
        return counts

    def _ensure_device(self) -> None:
        if self._dev is not None:
            return
        dev = self.engine.to_device(self._mem, self._carry, self._mask,
                                    self.device)
        if self.mesh is not None:
            # every rank holds the same host state and keeps its slots (a
            # local cut, no collective)
            mem_at, latch_at, _ = self._where
            dev = tuple(shd.place(x, self.mesh, at) for x, at in
                        zip(dev, (mem_at, latch_at, latch_at)))
        self._dev = dev
        self.device_puts += 1
        block._DEVICE_PUTS.inc(kind="grid")

    def _local_slots(self) -> Tuple[int, int]:
        """(first slot, slot count) that this rank holds."""
        shape, offset = compute_local_shape_and_global_offset(
            (self.g, self.n_blocks, N_ROWS, engine_packed.N_WORDS),
            self.mesh, self._where[0])
        return int(offset[0]), int(shape[0])

    def _on_shards(self, fn) -> None:
        """``fn(state)`` (an engine call that updates the state in place)
        on each rank's own slots, through `local_map`."""
        mem_at, latch_at, _ = self._where
        self._dev = local_map(
            lambda m, c, k: tuple(fn((m, c, k))),
            out_placements=(mem_at, latch_at, latch_at),
            in_placements=(mem_at, latch_at, latch_at),
            device_mesh=self.mesh)(*self._dev)

    def _dispatch(self, mat: np.ndarray) -> int:
        if mat.shape[0] == 0:
            return 0
        engine = self.engine
        with obs_trace.span("grid.dispatch", engine=engine.name,
                            slots=self.g, cycles=int(mat.shape[0])):
            self._ensure_device()
            if self.mesh is None:
                self._dev = engine.run(self._dev, mat, self.chain)
            else:
                self._on_shards(lambda st: engine.run(st, mat, self.chain))
        self.cycles += int(mat.shape[0])
        self.dispatches += 1
        block._DISPATCHES.inc(kind="grid", engine=engine.name)
        block._DISPATCH_CYCLES.inc(int(mat.shape[0]), kind="grid",
                                   engine=engine.name)
        return int(mat.shape[0])

    def __repr__(self):
        return (f"ComefaGrid({self.g} slots x {self.n_blocks} blocks, "
                f"chain={self.chain}, {self.cycles} cycles)")


# ---------------------------------------------------------------------------
# sharding the grid axis (parallel/sharding.py rule machinery)
# ---------------------------------------------------------------------------

def grid_mesh(devices=None, device="cuda") -> DeviceMesh:
    """A 1-D ``("data",)`` mesh for grid-axis sharding over `devices`
    (ranks of the running group; all of them by default), on `device`'s
    type.  Without a running group it starts a one-rank one (NCCL on a
    card, gloo on the CPU), as `launch.mesh.make_host_mesh` does."""
    from ...launch import mesh as mesh_mod      # launch imports kernels
    dev = block.resolve_device(device)
    mesh_mod._ensure_group(dev)
    if devices is None:
        return init_device_mesh(dev.type, (dist.get_world_size(),),
                                mesh_dim_names=("data",))
    return DeviceMesh(dev.type, [int(r) for r in devices],
                      mesh_dim_names=("data",))


def grid_shardings(mesh: DeviceMesh, g: int, n_blocks: int,
                   rules=None) -> Tuple:
    """(mem, latch, program) `DTensor` placements for the packed grid
    state: mem ``[g, n_blocks, 128, 5]``, carry and mask ``[g, n_blocks,
    5]``, and the program matrix.

    The grid axis carries the logical name ``"grid"`` and resolves
    through the same rules table the model layers use
    (`parallel.sharding.spec_for`, restricted to this mesh's axes); all
    other dims replicate, and the program is fully replicated (every
    rank's FSM broadcasts the same stream).  Dimension-aware pruning
    (`shardings_pruned`) degrades a grid that doesn't divide the rank
    count to replication, like every other ragged axis in the codebase.
    """
    grid_part = tuple(shd.spec_for(("grid",), rules,
                                   mesh_axes=mesh.mesh_dim_names))
    specs = [grid_part + (None,) * 3, grid_part + (None,) * 2]
    structs = [
        torch.empty((g, n_blocks, N_ROWS, engine_packed.N_WORDS),
                    dtype=torch.int32, device="meta"),
        torch.empty((g, n_blocks, engine_packed.N_WORDS),
                    dtype=torch.int32, device="meta"),
    ]
    mem_at, latch_at = shd.shardings_pruned(mesh, specs, structs)
    return (mem_at, latch_at, (Replicate(),) * mesh.ndim)
