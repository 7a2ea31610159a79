"""Transposed data layout + swizzle model (paper Sec. III-E / III-H, Fig 7).

Compute mode stores data *transposed*: one element per column (lane), its
bits spread across consecutive rows (LSB at the lowest row by our
convention).  The swizzle module (soft-logic ping-pong FIFO in the paper)
converts between the element-major stream coming from DRAM and the
bit-slice words written through the 40-bit port.

The host functions are pure numpy; they model *layout*, not timing - the
cycle cost of loading/unloading is `timing.load_store_cycles`.
`to_row_words` / `from_row_words` are their device-side counterparts for
whole rows of packed state (`grid.ComefaGrid.write_rows` / `read_rows`),
so a kernel can stage operands without materialising the grid on the
host.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .engine_packed import pack_bits, unpack_bits
from .isa import COL_MUX, N_COLS, WORD_BITS


def to_bits(values: np.ndarray, n_bits: int) -> np.ndarray:
    """Integers [N] -> bit matrix [n_bits, N] (LSB first, two's complement)."""
    v = np.asarray(values).astype(np.int64)
    return ((v[None, :] >> np.arange(n_bits)[:, None]) & 1).astype(np.uint8)


def from_bits(bits: np.ndarray, signed: bool = False) -> np.ndarray:
    """Bit matrix [n_bits, N] (LSB first) -> integers [N]."""
    n = bits.shape[0]
    acc = (bits.astype(np.int64) << np.arange(n)[:, None]).sum(axis=0)
    if signed:
        acc = acc - ((bits[-1].astype(np.int64)) << n)
    return acc


def place(arr, values: np.ndarray, base_row: int, n_bits: int,
          lanes=None, block=None):
    """Store integer elements transposed into a ComefaArray.

    values: [n_elems] (one block) or [n_blocks, n_elems].
    """
    values = np.asarray(values)
    if values.ndim == 1:
        bits = to_bits(values, n_bits)                  # [n_bits, N]
        if lanes is None:
            lanes = np.arange(bits.shape[1])
        sel = slice(None) if block is None else block
        for i in range(n_bits):
            arr.mem[sel, base_row + i, lanes] = bits[i]
    else:
        for b in range(values.shape[0]):
            place(arr, values[b], base_row, n_bits, lanes=lanes, block=b)


def extract(arr, base_row: int, n_bits: int, lanes=None, block=None,
            signed: bool = False) -> np.ndarray:
    """Read transposed elements back out. Returns [n_elems] or [nb, n_elems]."""
    if lanes is None:
        lanes = np.arange(N_COLS)
    if block is None:
        return np.stack([
            extract(arr, base_row, n_bits, lanes, b, signed)
            for b in range(arr.n_blocks)])
    bits = np.stack([arr.mem[block, base_row + i, lanes]
                     for i in range(n_bits)])
    return from_bits(bits, signed=signed)


def to_row_words(values: torch.Tensor, n_bits: int,
                 n_blocks: int) -> torch.Tensor:
    """Integers ``[..., n]`` -> transposed packed rows, on their device.

    Returns int32 ``[..., n_bits, n_blocks, 5]``: element c (zero-padded
    up to ``n_blocks * 160`` lanes) sits in lane ``c % 160`` of block
    ``c // 160``, its bit i (two's complement) in row i, the lanes packed
    32 to a word as `engine_packed.pack_bits` packs them - the words
    `place` would leave in those rows, for whole rows.
    """
    v = torch.as_tensor(values).to(torch.int64)
    n, lanes = v.shape[-1], n_blocks * N_COLS
    assert n <= lanes, (n, lanes)
    v = torch.nn.functional.pad(v, (0, lanes - n))
    shifts = torch.arange(n_bits, dtype=torch.int64, device=v.device)
    bits = (v[..., None, :] >> shifts[:, None]) & 1     # [..., n_bits, lanes]
    return pack_bits(bits.reshape(*bits.shape[:-1], n_blocks, N_COLS))


def from_row_words(words: torch.Tensor, signed: bool = False
                   ) -> torch.Tensor:
    """Inverse of `to_row_words` over all lanes, on the words' device.

    ``words [..., n_bits, n_blocks, 5]`` -> int64 ``[..., n_blocks *
    160]`` - what `extract` reads from those rows, block after block.
    """
    n_bits = words.shape[-3]
    bits = unpack_bits(words).to(torch.int64)           # [..., n_bits, nb, C]
    shifts = torch.arange(n_bits, dtype=torch.int64, device=bits.device)
    acc = (bits << shifts[:, None, None]).sum(dim=-3)
    if signed:
        acc = acc - (bits[..., -1, :, :] << n_bits)
    return acc.reshape(*acc.shape[:-2], -1)


# ---------------------------------------------------------------------------
# Swizzle: element-major DRAM stream <-> bit-slice port words (Fig 7, N=40)
# ---------------------------------------------------------------------------

def swizzle(elements: np.ndarray, n_bits: int) -> np.ndarray:
    """Model of the swizzle FIFO: 40 untransposed elements -> n_bits words.

    Word i carries bit i of each of the 40 elements (element j -> word
    bit j), i.e. one bit-slice per output word, ready to be written to
    consecutive row addresses of one column-mux phase.
    Returns uint64 words [n_bits].
    """
    assert elements.shape[0] == WORD_BITS, "swizzle operates on 40 elements"
    bits = to_bits(elements, n_bits)                     # [n_bits, 40]
    weights = (np.uint64(1) << np.arange(WORD_BITS, dtype=np.uint64))
    return (bits.astype(np.uint64) * weights[None, :]).sum(axis=1)


def unswizzle(words: np.ndarray, n_bits: int) -> np.ndarray:
    """Inverse of `swizzle`: n_bits bit-slice words -> 40 elements."""
    words = np.asarray(words, dtype=np.uint64)
    bits = ((words[:, None] >> np.arange(WORD_BITS, dtype=np.uint64)[None, :])
            & np.uint64(1)).astype(np.uint8)            # [n_bits, 40]
    return from_bits(bits)


def load_transposed(arr, block: int, values: np.ndarray, base_row: int,
                    n_bits: int):
    """Full load path: swizzle an element stream and write port words.

    Elements land in lanes grouped by column-mux phase: element j of chunk c
    (40 elements per chunk, COL_MUX chunks per row span) occupies lane
    ``COL_MUX * j + c``.  Uses the hybrid-mode port (so `io_words` counts
    the real port traffic) rather than poking `mem` directly.
    """
    values = np.asarray(values)
    assert values.shape[0] <= WORD_BITS * COL_MUX
    for c in range(int(np.ceil(values.shape[0] / WORD_BITS))):
        chunk = values[c * WORD_BITS:(c + 1) * WORD_BITS]
        if chunk.shape[0] < WORD_BITS:
            chunk = np.pad(chunk, (0, WORD_BITS - chunk.shape[0]))
        for i, w in enumerate(swizzle(chunk, n_bits)):
            addr = ((base_row + i) << 2) | c
            arr.write_word(block, addr, int(w))


def lane_of(element_index: int) -> int:
    """Lane occupied by element j after `load_transposed`."""
    c, j = divmod(element_index, WORD_BITS)
    return COL_MUX * j + c


# ---------------------------------------------------------------------------
# Block-aware placement planner for chained operands (Sec. III-F, Fig 6b)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ChainPlan:
    """Placement of ONE logical operand across `n_blocks * 160` lanes.

    Shift chaining treats the blocks of an array as one flat
    ``n_blocks * N_COLS``-lane row (global lane = block * 160 + column),
    so a chained program only sees elements in the intended order when
    the placement maps logical index j to the right *global* lane:

      * ``order="linear"``: element j -> global lane j.  Adjacent
        elements occupy adjacent lanes across block seams - required by
        anything that shifts data between neighbours (chained reductions,
        the FIR delay line).
      * ``order="port"``: the phase-correct hybrid-port mapping of
        `load_transposed` - within each block, element e lands in lane
        ``COL_MUX * (e % 40) + e // 40`` (bit-slice words interleave the
        4 column-mux phases, Fig 7).  Matches what real port loads
        produce; lane-order-insensitive programs (element-wise ops,
        order-free accumulations) can use it and skip re-shuffling.

    `place`/`extract` hide the mapping either way, so kernels address
    operands purely by logical element index.
    """
    n_elems: int
    n_blocks: int
    order: str = "linear"

    def __post_init__(self):
        assert self.order in ("linear", "port"), self.order
        assert self.n_elems <= self.n_blocks * N_COLS, \
            (f"{self.n_elems} elements exceed {self.n_blocks} blocks x "
             f"{N_COLS} lanes")

    @property
    def total_lanes(self) -> int:
        return self.n_blocks * N_COLS

    def lanes(self) -> np.ndarray:
        """[n_elems] global lane of each logical element."""
        j = np.arange(self.n_elems)
        blk, e = j // N_COLS, j % N_COLS
        if self.order == "port":
            lane = COL_MUX * (e % WORD_BITS) + e // WORD_BITS
        else:
            lane = e
        return blk * N_COLS + lane

    def place(self, arr, values: np.ndarray, base_row: int, n_bits: int):
        """Store values[j] transposed at the lane the plan assigns to j."""
        values = np.asarray(values).ravel()
        assert values.shape[0] == self.n_elems
        g = self.lanes()
        for b in range(self.n_blocks):
            sel = (g // N_COLS) == b
            if sel.any():
                place(arr, values[sel], base_row, n_bits,
                      lanes=g[sel] % N_COLS, block=b)

    def extract(self, arr, base_row: int, n_bits: int,
                signed: bool = False) -> np.ndarray:
        """Read the operand back in logical element order ([n_elems])."""
        g = self.lanes()
        out = np.empty(self.n_elems, dtype=np.int64)
        for b in range(self.n_blocks):
            sel = (g // N_COLS) == b
            if sel.any():
                out[sel] = extract(arr, base_row, n_bits,
                                   lanes=g[sel] % N_COLS, block=b,
                                   signed=signed)
        return out


def plan_chain(n_elems: int, order: str = "linear",
               max_blocks: int = 0) -> ChainPlan:
    """Spread `n_elems` elements across the fewest whole blocks.

    Returns a `ChainPlan` with ``ceil(n_elems / 160)`` blocks; the caller
    builds a matching ``ComefaArray(n_blocks, chain=True)`` when the plan
    spans more than one block.  `max_blocks` (0 = unlimited) bounds the
    spread and raises when the operand cannot fit.
    """
    assert n_elems >= 1
    n_blocks = -(-n_elems // N_COLS)
    if max_blocks and n_blocks > max_blocks:
        raise ValueError(
            f"{n_elems} elements need {n_blocks} blocks "
            f"({N_COLS} lanes each), limit is {max_blocks}")
    return ChainPlan(n_elems=n_elems, n_blocks=n_blocks, order=order)
