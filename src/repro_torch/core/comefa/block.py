"""Bit-level functional model of CoMeFa RAM blocks (paper Figs. 1-4).

Models the CoMeFa-D datapath exactly: each "cycle" reads one row per port
(true dual-port), evaluates the PE (TR truth-table mux, X xor gate, CGEN
carry gates, carry latch C, mask latch M, predication mux P, write muxes
W1/W2) in all 160 columns, and writes one row back.  CoMeFa-A is
functionally identical (same ISA, same per-extended-cycle parallelism of
160 lanes); it differs only in clock period and area, which the timing /
area models capture (`timing.py`).

The engine is vectorized over *blocks*: `mem` has shape
``[n_blocks, 128, 160]`` (uint8 bit per cell) and every block executes the
same instruction each cycle - exactly how the paper drives many CoMeFa RAMs
from one shared instruction-generation FSM (Sec. III-D).  Left/right shift
chaining between adjacent blocks (Sec. III-F, Fig 6b) is modelled by
treating the blocks of one array as one 160*n_blocks-lane row when
``chain=True``.

Semantics fixed here (paper leaves them implicit):
  * predication (mux P) sees the *latched* values of mask/carry from the
    previous cycle - "the carry ... can be used in the following cycle's
    computation";
  * the carry latch input is CGEN(A, B, c_in) = A&B | c_in&(A^B) with
    c_in = 0 when c_rst else the latched carry; c_en=0 holds the old value.
    c_rst gates the carry *input* path (making gate X transparent, as the
    paper describes) without destroying the latched value - predication can
    therefore still see a previously stored carry;
  * W2's "carry" source is the latched (pre-update) carry, so an add's
    final carry-out is stored by a following instruction with c_en=0;
  * each cycle retires one write per *port*: W1 to `dst_row`, W2 to
    `dst2_row` (== dst_row for plain instructions; the IR co-issue pass
    packs an independent Port-B write into an otherwise W2-idle cycle,
    exploiting the true-dual-port concurrency).

Programs are executed through a keyed encode cache: `run()` accepts an
`ir.Program` (which caches its own engine matrix), a raw `list[Instr]`, or
a pre-encoded matrix, and repeated invocations of structurally equal
programs skip re-encoding entirely.  `run_programs()` concatenates several
programs into a single dispatch.

Execution is pluggable (`ComefaArray(engine=...)`): the uint8 torch scan
below stays the bit-for-bit reference; `engine_packed` provides the
int32 bit-packed engines - ``"packed"``, the word-parallel torch scan, and
``"cuda"``, the hand-written CUDA step kernel - pinned identical to it by
the tests.  Arrays and grids take an explicit ``device`` (default
``"cuda"``; the CPU only when asked for); with no engine named they run
``"cuda"`` on a CUDA device and ``"reference"`` on the CPU, and nothing
falls back from one engine to another.  State lives on the device between
dispatches and materializes to numpy lazily, only when a port read / lane
access / `layout` placement needs host memory.
"""
from __future__ import annotations

from collections.abc import MutableMapping
from typing import List, Optional, Sequence

import numpy as np
import torch

from ...obs import metrics as obs_metrics
from ...obs import trace as obs_trace
from . import engine_packed, ir, isa, verify
from .isa import (COL_MUX, N_COLS, N_ROWS, ROW_ONES, WORD_BITS,
                  encode_program)

# field indices in the encoded program matrix
_F = {name: i for i, name in enumerate(isa.ENGINE_FIELD_NAMES)}

# telemetry handles (repro_torch.obs default registry).  Label schemas:
#   comefa.encode_cache{event=hits|misses|device_hits|device_misses}
#     (device_*: kernels/comefa_step.decoded's cache of decoded programs)
#   comefa.host_syncs / comefa.device_puts {kind=array|grid}
#   comefa.dispatches / comefa.dispatch_cycles {kind=..., engine=...}
#   comefa.engine_select{engine=...}
_ENCODE_EVENTS = obs_metrics.counter("comefa.encode_cache")
_HOST_SYNCS = obs_metrics.counter("comefa.host_syncs")
_DEVICE_PUTS = obs_metrics.counter("comefa.device_puts")
_DISPATCHES = obs_metrics.counter("comefa.dispatches")
_DISPATCH_CYCLES = obs_metrics.counter("comefa.dispatch_cycles")
_ENGINE_SELECT = obs_metrics.counter("comefa.engine_select")


def _prog_label(program) -> str:
    """Short span label for any program form (IR, Instr list, matrix)."""
    name = getattr(program, "name", None)
    if name:
        return str(name)
    if isinstance(program, np.ndarray):
        return f"matrix[{program.shape[0]}]"
    return type(program).__name__

# encoded one-cycle latch reset, inserted at `run_programs` boundaries
_LATCH_CLEAR_MAT = np.array([isa.latch_clear().engine_vector()],
                            dtype=np.int32)


def _concat_encoded(mats, reset_latches: bool):
    """Concatenate encoded programs for one batched dispatch.

    Returns ``(matrix, per_program_counts)``; with `reset_latches` a
    one-cycle `isa.latch_clear` row is inserted at every boundary and
    charged to the *following* program's count.  Shared by
    `ComefaArray.run_programs` and `grid.ComefaGrid.run_programs` so the
    boundary semantics cannot drift apart.
    """
    if reset_latches and len(mats) > 1:
        parts, counts = [mats[0]], [int(mats[0].shape[0])]
        for m in mats[1:]:
            parts += [_LATCH_CLEAR_MAT, m]
            counts.append(int(m.shape[0]) + 1)
    else:
        parts, counts = list(mats), [int(m.shape[0]) for m in mats]
    return np.concatenate(parts, axis=0), counts


def _port_word_cols(addr: int) -> np.ndarray:
    """Columns of the 40-bit hybrid-mode word at logical address `addr`."""
    phase = addr & (COL_MUX - 1)
    return np.arange(WORD_BITS) * COL_MUX + phase


def write_port_word(mem: np.ndarray, block: int, addr: int,
                    word: int) -> None:
    """Memory-mode style write of one 40-bit word into `mem[block]`.

    Shared by `ComefaArray.write_word` and grid slot views - one home
    for the address guard and the bit packing.
    """
    assert 0 <= addr < N_ROWS * COL_MUX and addr != isa.INSTR_ADDR
    row, cols = addr // COL_MUX, _port_word_cols(addr)
    bits = (word >> np.arange(WORD_BITS)) & 1
    mem[block, row, cols] = bits.astype(np.uint8)


def read_port_word(mem: np.ndarray, block: int, addr: int) -> int:
    # mirror write_port_word's checks: an out-of-range read would
    # otherwise index garbage rows instead of failing loudly
    assert 0 <= addr < N_ROWS * COL_MUX and addr != isa.INSTR_ADDR
    row, cols = addr // COL_MUX, _port_word_cols(addr)
    bits = mem[block, row, cols].astype(np.int64)
    return int((bits << np.arange(WORD_BITS)).sum())


def _step(chain: bool, state, f: Sequence[int]):
    """One CoMeFa cycle, in place. state = (mem[..., R, C], carry[..., C],
    mask[..., C]) uint8; ``f`` is one instruction's engine fields.

    Rank-polymorphic over leading axes: a single array runs with
    ``mem[nb, R, C]``; `grid.ComefaGrid` stacks G arrays as
    ``mem[G, nb, R, C]`` and reuses this exact step for its whole-grid
    dispatch.  With ``chain=True`` the shift network flattens only the
    trailing ``(nb, C)`` axes, so RAM-to-RAM chaining never crosses grid
    slots.  Returns the new (carry, mask); ``mem`` is updated in place.
    """
    mem, carry, mask = state

    src1 = f[_F["src1_row"]]
    src2 = f[_F["src2_row"]]
    dst = f[_F["dst_row"]]
    tt = f[_F["truth_table"]]
    pred_sel = f[_F["pred_sel"]]
    w1_sel = f[_F["w1_sel"]]
    w2_sel = f[_F["w2_sel"]]
    wp1 = f[_F["wp1_en"]]
    wp2 = f[_F["wp2_en"]]
    c_en = f[_F["c_en"]]
    c_rst = f[_F["c_rst"]]
    m_en = f[_F["m_en"]]
    ext_bit = f[_F["ext_bit"]]
    b_ext = f[_F["b_ext"]]
    dst2 = f[_F["dst2_row"]]
    pred2_sel = f[_F["pred2_sel"]]

    # ---- phase 1: read (one row per port) -------------------------------
    a = mem[..., src1, :]                                # [..., C]
    b_read = mem[..., src2, :]
    b = torch.full_like(b_read, ext_bit) if b_ext == 1 else b_read

    # ---- phase 2: compute ----------------------------------------------
    idx = (a << 1) | b                                   # (A<<1)|B in 0..3
    tr = (torch.full_like(idx, tt) >> idx) & 1           # mux TR
    c_in = torch.zeros_like(carry) if c_rst == 1 else carry
    s = tr ^ c_in                                        # gate X
    cgen = (a & b) | (c_in & (a ^ b))                    # CGEN
    carry_next = cgen if c_en == 1 else carry
    mask_next = tr if m_en == 1 else mask

    # predication uses the *latched* (previous-cycle) mask / carry; each
    # write port has its own predicate select (identical unless co-issued)
    def _pred(sel):
        if sel == isa.PRED_ALWAYS:
            return torch.ones_like(mask)
        if sel == isa.PRED_MASK:
            return mask
        if sel == isa.PRED_CARRY:
            return carry
        if sel == isa.PRED_NOT_CARRY:
            return 1 - carry
        return torch.zeros_like(mask)

    pred = _pred(pred_sel)
    pred2 = _pred(pred2_sel)

    # ---- phase 3: write-back -------------------------------------------
    # neighbour S values for shifts; chain=True threads corner PEs of
    # adjacent blocks together (RAM-to-RAM chaining, Fig 6b) - flattening
    # only the trailing (nb, C) axes, so any leading grid axis stays a
    # hard seam between independent slots.
    if chain:
        lead = s.shape[:-2]
        s_flat = s.reshape(lead + (-1,))
        z1 = torch.zeros(lead + (1,), dtype=s.dtype, device=s.device)
        from_right = torch.cat([s_flat[..., 1:], z1], dim=-1)
        from_left = torch.cat([z1, s_flat[..., :-1]], dim=-1)
        from_right = from_right.reshape(s.shape)
        from_left = from_left.reshape(s.shape)
    else:
        zcol = torch.zeros_like(s[..., :1])
        from_right = torch.cat([s[..., 1:], zcol], dim=-1)
        from_left = torch.cat([zcol, s[..., :-1]], dim=-1)

    # d_in is handled off-line: W1_DIN / W2_DIN (and W2_ZERO) drive 0
    val1 = {isa.W1_S: s, isa.W1_RIGHT: from_right}.get(
        w1_sel, torch.zeros_like(s))
    # W2 carry source is the raw latch (pre-update)
    val2 = {isa.W2_CARRY: carry, isa.W2_LEFT: from_left}.get(
        w2_sel, torch.zeros_like(s))

    we1 = pred & wp1
    we2 = pred2 & wp2
    old1 = mem[..., dst, :]
    mem[..., dst, :] = torch.where(we1 == 1, val1, old1)
    old2 = mem[..., dst2, :]
    mem[..., dst2, :] = torch.where(we2 == 1, val2, old2)
    return carry_next, mask_next


def _run(mem, carry, mask, prog, chain: bool):
    """Scan the host program matrix ``prog [T, F]`` over the state, in
    place; returns the state."""
    c, m = carry, mask
    for f in np.asarray(prog).tolist():
        c, m = _step(chain, (mem, c, m), f)
    carry.copy_(c)
    mask.copy_(m)
    return mem, carry, mask


def _run_slotwise(mem, carry, mask, progs, chain: bool):
    """Per-slot program dispatch: slot g scans its OWN ``progs[g]``.

    Models one instruction FSM *per grid slice* instead of the shared
    broadcast (`grid.ComefaGrid.run_per_slot`).
    """
    for g in range(mem.shape[0]):
        _run(mem[g], carry[g], mask[g], progs[g], chain)
    return mem, carry, mask


# ---------------------------------------------------------------------------
# execution engines: the strategy ComefaArray/ComefaGrid dispatch through
# ---------------------------------------------------------------------------

class _ReferenceEngine:
    """The uint8 one-lane-per-bit torch scan above - the semantic ground
    truth.

    Engine protocol (shared with `engine_packed`): `to_device` lifts host
    uint8 state into the engine's representation on a device, `run` /
    `run_per_slot` advance it in place from a host program matrix (no
    state crosses to the host), `to_host` materializes writable numpy
    uint8 state back, and `write_rows` / `read_rows` move whole packed
    rows (int32 words, `engine_packed.pack_bits` layout) of a grid's
    ``[G, nb, R, ...]`` state without a host round trip.
    """

    name = "reference"

    def to_device(self, mem, carry, mask, device):
        return tuple(torch.as_tensor(np.array(v, np.uint8), device=device)
                     for v in (mem, carry, mask))

    def to_host(self, state):
        # np.array (not asarray): callers mutate the result in place (port
        # writes, `layout` placements between runs)
        return tuple(np.array(v.cpu().numpy()) for v in state)

    def run(self, state, mat: np.ndarray, chain: bool):
        return _run(*state, mat, chain)

    def run_per_slot(self, state, mats: np.ndarray, chain: bool):
        return _run_slotwise(*state, mats, chain)

    def write_rows(self, state, rows, words: torch.Tensor):
        state[0][:, :, rows, :] = engine_packed.unpack_bits(words)
        return state

    def read_rows(self, state, rows) -> torch.Tensor:
        return engine_packed.pack_bits(state[0][:, :, rows, :])


_REFERENCE_ENGINE = _ReferenceEngine()


def resolve_device(device) -> torch.device:
    """A device name -> `torch.device`; CUDA where there is none raises
    (the simulator never moves to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but "
                           "torch.cuda.is_available() is False")
    return dev


def get_engine(name=None, device="cuda"):
    """Resolve an engine spec to an engine object.

    ``None`` picks by device: ``"cuda"`` (the CUDA step kernel) on a CUDA
    device, ``"reference"`` (the uint8 scan) on the CPU.  A string picks
    ``reference`` here or defers to `engine_packed.get_engine` for
    ``packed`` / ``cuda``; an engine object passes through (so arrays can
    share one).  ``"cuda"`` for a CPU device raises.
    """
    dev = resolve_device(device)
    if name is None:
        name = "cuda" if dev.type == "cuda" else "reference"
    if not isinstance(name, str):
        engine = name
    elif name == "reference":
        engine = _REFERENCE_ENGINE
    else:
        engine = engine_packed.get_engine(name)
    if engine.name == "cuda" and dev.type != "cuda":
        raise RuntimeError(f"engine 'cuda' needs a CUDA device, not {dev}")
    _ENGINE_SELECT.inc(engine=engine.name)
    return engine


# ---------------------------------------------------------------------------
# keyed encode cache: structurally-equal programs encode once
# ---------------------------------------------------------------------------

_ENCODE_CACHE: dict = {}
_ENCODE_CACHE_MAX = 512


class _EncodeCacheStats(MutableMapping):
    """Legacy dict facade over the ``comefa.encode_cache`` counter.

    The module-level ``ENCODE_CACHE_STATS`` dict predates the telemetry
    registry and leaked across tests (no reset path).  The counts now
    live in `repro_torch.obs.metrics` (series keyed by ``event=``) where
    ``obs.metrics.reset()`` zeroes them; this view keeps every existing
    reader/writer working - ``stats["hits"]``, ``.update(hits=0)``,
    ``stats == {...}`` - while new code should read the registry.
    """

    _KEYS = ("hits", "misses", "device_hits", "device_misses")

    def __getitem__(self, key):
        if key not in self._KEYS:
            raise KeyError(key)
        return int(_ENCODE_EVENTS.value(event=key))

    def __setitem__(self, key, value):
        if key not in self._KEYS:
            raise KeyError(key)
        _ENCODE_EVENTS.set(int(value), event=key)

    def __delitem__(self, key):
        raise TypeError("encode-cache stats keys are fixed")

    def __iter__(self):
        return iter(self._KEYS)

    def __len__(self):
        return len(self._KEYS)

    def __eq__(self, other):
        if isinstance(other, (dict, MutableMapping)):
            return dict(self) == dict(other)
        return NotImplemented

    def __repr__(self):
        return f"ENCODE_CACHE_STATS({dict(self)!r})"


ENCODE_CACHE_STATS = _EncodeCacheStats()


def _encode_cached(key, producer) -> np.ndarray:
    mat = _ENCODE_CACHE.get(key)
    if mat is not None:
        _ENCODE_EVENTS.inc(event="hits")
        return mat
    _ENCODE_EVENTS.inc(event="misses")
    with obs_trace.span("comefa.encode"):
        mat = producer()
    # Freeze before caching: the matrix is shared with every later caller,
    # so an in-place edit by one would silently corrupt all future runs of
    # the same program.  Mutation now raises instead.
    mat.setflags(write=False)
    if len(_ENCODE_CACHE) >= _ENCODE_CACHE_MAX:
        _ENCODE_CACHE.pop(next(iter(_ENCODE_CACHE)))   # FIFO eviction
    _ENCODE_CACHE[key] = mat
    return mat


def _widen_legacy(mat: np.ndarray) -> np.ndarray:
    """Legacy [T, N_FIELDS] matrix -> engine width, same semantics.

    Mirrors `Instr.engine_vector`: dst2/pred2 mirror dst/pred, and a
    W2_CARRY write with c_rst=1 (which historically wrote the gated
    carry input, i.e. 0) becomes W2_ZERO under the raw-latch source.
    """
    mat = mat.copy()
    legacy_zero = ((mat[:, _F["wp2_en"]] == 1)
                   & (mat[:, _F["w2_sel"]] == isa.W2_CARRY)
                   & (mat[:, _F["c_rst"]] == 1))
    mat[legacy_zero, _F["w2_sel"]] = isa.W2_ZERO
    dst = mat[:, _F["dst_row"]:_F["dst_row"] + 1]
    pred = mat[:, _F["pred_sel"]:_F["pred_sel"] + 1]
    return np.concatenate([mat, dst, pred], axis=1)


def encoded(program) -> np.ndarray:
    """Engine field matrix for any program form, through the keyed cache.

    Accepts an `ir.Program` (fingerprinted by its slot structure), a raw
    `Instr` sequence (fingerprinted by the instruction tuple), or an
    already-encoded int32 matrix (returned as-is; a legacy
    ``[T, N_FIELDS]`` matrix is widened with dst2/pred2 columns).

    This is the single encode funnel for every execution path
    (`ComefaArray.run`/`run_programs`, the `ComefaGrid` dispatches), so
    it is also where the ``REPRO_TORCH_COMEFA_VERIFY`` pre-encode hook lives:
    with the env flag set, every `ir.Program` headed for an engine is
    statically verified (dual-port races, reserved-row writes - see
    `verify.maybe_verify`) and a hazard raises `VerificationError`
    before any instruction executes.  Raw instruction lists and
    pre-encoded matrices bypass the hook by design: they sit below the
    IR contract the verifier checks.
    """
    if isinstance(program, np.ndarray):
        if program.shape[0] and program.shape[1] == isa.N_FIELDS:
            return _widen_legacy(program)
        if program.shape[0] == 0:
            return np.zeros((0, isa.N_ENGINE_FIELDS), np.int32)
        return program
    if isinstance(program, ir.Program):
        verify.maybe_verify(program)
        return _encode_cached(program.key, program.encode)
    instrs = tuple(program)
    return _encode_cached(instrs, lambda: encode_program(instrs))


class ComefaArray:
    """An array of CoMeFa RAM blocks driven by one instruction stream.

    `engine` selects the execution engine (`get_engine`): the uint8
    reference scan, the word-parallel ``"packed"`` torch scan or the
    ``"cuda"`` step kernel; with none named it follows `device` (``cuda``
    on a CUDA device, ``reference`` on the CPU).  State stays on the
    device between dispatches: `run(); run()` chains device buffers with
    no host round-trip, and the numpy ``mem``/``carry``/``mask`` views
    materialize lazily on first host access (port words, lane helpers,
    `layout` placements).  `host_syncs` / `device_puts` count those
    boundary crossings - the regression tests pin them - and `dispatches`
    counts engine runs.
    """

    def __init__(self, n_blocks: int = 1, chain: bool = False, engine=None,
                 device="cuda"):
        self.n_blocks = n_blocks
        self.chain = chain
        self.device = resolve_device(device)
        self.engine = get_engine(engine, self.device)
        self.cycles = 0           # cycles spent in compute (hybrid) mode
        self.io_words = 0         # 40-bit words moved through the ports
        self.reset()

    # -- state ------------------------------------------------------------
    def reset(self):
        mem = np.zeros((self.n_blocks, N_ROWS, N_COLS), dtype=np.uint8)
        mem[:, ROW_ONES, :] = 1
        self._mem = mem
        self._carry = np.zeros((self.n_blocks, N_COLS), dtype=np.uint8)
        self._mask = np.zeros((self.n_blocks, N_COLS), dtype=np.uint8)
        self._dev = None          # engine-format device state, when ahead
        self.cycles = 0
        self.io_words = 0
        self.host_syncs = 0       # device->host state materializations
        self.device_puts = 0      # host->device state uploads
        self.dispatches = 0       # engine runs

    def _sync_host(self):
        """Materialize device state to numpy (and drop the device copy).

        Dropping is deliberate: every host access hands out a *writable*
        array that callers mutate in place (port writes, placements), so
        a retained device copy could silently go stale.  Repeated host
        accesses after one sync are free; the next dispatch re-uploads.
        """
        if self._dev is not None:
            with obs_trace.span("array.host_sync", engine=self.engine.name):
                self._mem, self._carry, self._mask = self.engine.to_host(
                    self._dev)
            self._dev = None
            self.host_syncs += 1
            _HOST_SYNCS.inc(kind="array")

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

    # -- hybrid-mode logical port access (512 x 40, column mux 4) ---------
    def write_word(self, block: int, addr: int, word: int):
        """Memory-mode style write of one 40-bit word (hybrid max-width)."""
        write_port_word(self.mem, block, addr, word)
        self.io_words += 1

    def read_word(self, block: int, addr: int) -> int:
        word = read_port_word(self.mem, block, addr)
        self.io_words += 1        # a rejected address counts no traffic
        return word

    # -- lane-level helpers (tests / data loading via layout.py) ----------
    def set_lanes(self, rows: Sequence[int], values: np.ndarray,
                  block: Optional[int] = None):
        """values: uint bit matrix [len(rows), lanes(, blocks)]."""
        sel = slice(None) if block is None else block
        mem = self.mem            # one lazy host sync for the whole batch
        for r, v in zip(rows, values):
            mem[sel, r, :] = v

    def get_lanes(self, rows: Sequence[int], block: Optional[int] = None):
        sel = slice(None) if block is None else block
        mem = self.mem
        return np.stack([mem[sel, r, :] for r in rows])

    # -- execution ---------------------------------------------------------
    def run(self, program) -> int:
        """Execute a program. Returns processing cycles.

        Accepts an `ir.Program`, a `list[Instr]`, or an encoded matrix;
        encoding goes through the keyed cache, so repeated kernel
        invocations of structurally equal programs skip re-encoding.
        """
        with obs_trace.span("array.run",
                            program=_prog_label(program)) as sp:
            cycles = self._dispatch(encoded(program))
            sp.set(cycles=cycles)
        return cycles

    def run_programs(self, programs, reset_latches: bool = True) -> List[int]:
        """Execute several programs back-to-back in ONE dispatch.

        The encoded matrices are concatenated so the engine dispatches
        once for the whole batch.  Returns per-program cycle counts.

        Carry/mask latch state survives a program's last cycle by design,
        so naive concatenation leaks program i's latches into program i+1
        - silently wrong for any program that predicates on a latch before
        setting it.  With `reset_latches` (the default) a one-cycle
        `isa.latch_clear` instruction is inserted at every boundary and
        charged to the following program's cycle count; pass False only
        when the programs deliberately thread latch state (then the batch
        is cycle-for-cycle identical to sequential `run()` calls).
        """
        programs = list(programs)
        with obs_trace.span("array.run_programs", n=len(programs)) as sp:
            verify.maybe_verify_batch(programs, reset_latches)
            mats = [encoded(p) for p in programs]
            if not mats:
                return []
            mat, counts = _concat_encoded(mats, reset_latches)
            sp.set(cycles=self._dispatch(mat))
        return counts

    def _dispatch(self, mat: np.ndarray) -> int:
        if mat.shape[0] == 0:
            return 0
        engine = self.engine
        with obs_trace.span("array.dispatch", engine=engine.name,
                            cycles=int(mat.shape[0])):
            if self._dev is None:
                self._dev = engine.to_device(self._mem, self._carry,
                                             self._mask, self.device)
                self.device_puts += 1
                _DEVICE_PUTS.inc(kind="array")
            self._dev = engine.run(self._dev, mat, self.chain)
        self.cycles += int(mat.shape[0])
        self.dispatches += 1
        _DISPATCHES.inc(kind="array", engine=engine.name)
        _DISPATCH_CYCLES.inc(int(mat.shape[0]), kind="array",
                             engine=engine.name)
        return int(mat.shape[0])
