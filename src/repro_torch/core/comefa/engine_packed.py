"""Bit-packed execution engines for the CoMeFa simulator step.

The reference engine (`block._step`) stores every one-bit cell as its own
uint8 lane: ``mem[..., 128, 160]``.  The PE datapath, however, is pure
bitwise logic - TR mux, XOR, CGEN, predication - which packs into machine
words, 32 lanes to a word:

  * ``mem[..., nb, 128, 160]`` uint8  ->  ``mem[..., nb, 128, 5]`` int32
    (lane ``c`` lives in word ``c // 32``, bit ``c % 32``, LSB first; the
    words hold the JAX package's uint32 bits in int32, since torch on the
    CPU has no unsigned 32-bit shift);
    carry/mask ``[..., nb, 160]``     ->  ``[..., nb, 5]`` int32;
  * the TR mux, CGEN/X, predication and the write enables are bitwise ops
    on packed words, and the W1_RIGHT / W2_LEFT shift network (including
    ``chain=True`` cross-block threading) becomes funnel shifts with
    cross-word / cross-block boundary words.  Every right shift is masked
    so that it is logical;
  * every instruction-dependent word mask comes from `prepare_fields`, so
    the per-cycle step is and/or/xor/shift on packed words plus two row
    updates;
  * packing/unpacking happens only at the host boundary
    (`ComefaArray`/`ComefaGrid` sync state lazily).

Two runners share this state layout:

  * the word-parallel torch scan (`_run_packed` / `_run_slotwise_packed`),
    engine ``"packed"``, on any device - it is the plain version of the
    CUDA step kernel;
  * the hand-written CUDA kernel in `repro_torch.kernels.comefa_step`
    (`csrc/comefa_step.cu`), engine ``"cuda"``, one launch per dispatch.

The scan evaluates `datapath` with each instruction's masks as Python
integers (0 or all-ones), so the terms an instruction switches off cost
no tensor op; with tensor fields the same function evaluates every term
(the tests hold the two equal).  Engine selection lives in
`block.get_engine`; the uint8 scan stays the reference engine and the
tests pin every packed path bit-identical to it.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from . import isa

# field indices in the encoded program matrix (same layout as block._F)
_F = {name: i for i, name in enumerate(isa.ENGINE_FIELD_NAMES)}

PACK = 32                        # lanes per packed word
N_WORDS = isa.N_COLS // PACK     # 5 words per 160-lane row
assert isa.N_COLS % PACK == 0

_ALL = -1                        # all-ones int32 word
_LOW31 = 0x7FFFFFFF              # masks an arithmetic >> 1 to a logical one


# ---------------------------------------------------------------------------
# host-boundary pack / unpack
# ---------------------------------------------------------------------------

def _as_tensor(a) -> torch.Tensor:
    if isinstance(a, np.ndarray) and a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.as_tensor(a)


def pack_bits(bits) -> torch.Tensor:
    """{0,1} ``[..., C]`` (C % 32 == 0) -> int32 ``[..., C // 32]``.

    Lane ``c`` -> word ``c // 32``, bit ``c % 32`` (LSB first) - the one
    layout every engine and the CUDA kernel agree on.  Takes a numpy array
    or a tensor; a tensor's words stay on its device.
    """
    bits = _as_tensor(bits)
    assert bits.shape[-1] % PACK == 0, tuple(bits.shape)
    b = bits.to(torch.int64).reshape(*bits.shape[:-1], -1, PACK)
    shifts = torch.arange(PACK, dtype=torch.int64, device=b.device)
    # disjoint bit positions: the sum IS the bitwise OR
    w = (b << shifts).sum(dim=-1)
    return (w - ((w >> 31) << 32)).to(torch.int32)


def unpack_bits(words) -> torch.Tensor:
    """Inverse of `pack_bits`: int32 ``[..., W]`` -> uint8 ``[..., W*32]``."""
    words = _as_tensor(words).to(torch.int32)
    shifts = torch.arange(PACK, dtype=torch.int32, device=words.device)
    bits = ((words[..., None] >> shifts) & 1).to(torch.uint8)
    return bits.reshape(*words.shape[:-1], -1)


# ---------------------------------------------------------------------------
# word-mask algebra: a value is a tensor of words, or the Python int 0
# (all lanes 0) or -1 (all lanes 1), which fold away without a tensor op
# ---------------------------------------------------------------------------

def _is_const(v) -> bool:
    return type(v) is int


def _and(*vs):
    out = _ALL
    for v in vs:
        if type(v) is int:
            if v == 0:
                return 0
            continue
        out = v if type(out) is int else out & v
    return out


def _or(*vs):
    out = 0
    for v in vs:
        if type(v) is int:
            if v == _ALL:
                return _ALL
            continue
        out = v if type(out) is int else out | v
    return out


def _xor(u, v):
    if _is_const(u) and _is_const(v):
        return u ^ v
    if _is_const(u):
        u, v = v, u
    if _is_const(v):
        return u if v == 0 else ~u
    return u ^ v


def _not(v):
    return ~v


def _tensor(v, like: torch.Tensor) -> torch.Tensor:
    return torch.full_like(like, v) if _is_const(v) else v


def _mask(cond):
    """Condition -> word mask: -1 where true, 0 where false."""
    if type(cond) is bool:
        return _ALL if cond else 0
    return torch.where(cond, _ALL, 0).to(torch.int32)


# TR mux for a known truth table: tt[(A << 1) | B] as one expression
_TR = {
    0b0000: lambda a, b: 0,
    0b0001: lambda a, b: ~(a | b),
    0b0010: lambda a, b: ~a & b,
    0b0011: lambda a, b: ~a,
    0b0100: lambda a, b: a & ~b,
    0b0101: lambda a, b: ~b,
    0b0110: lambda a, b: a ^ b,
    0b0111: lambda a, b: ~(a & b),
    0b1000: lambda a, b: a & b,
    0b1001: lambda a, b: ~(a ^ b),
    0b1010: lambda a, b: b,
    0b1011: lambda a, b: ~a | b,
    0b1100: lambda a, b: a,
    0b1101: lambda a, b: a | ~b,
    0b1110: lambda a, b: a | b,
    0b1111: lambda a, b: _ALL,
}


# ---------------------------------------------------------------------------
# the word-parallel PE datapath (the CUDA kernel computes the same words)
# ---------------------------------------------------------------------------

def prepare_fields(get):
    """Engine fields -> the packed datapath's operand bundle.

    ``get(name)`` returns the raw int field value: a Python int (the
    masks are then Python ints, 0 or -1, and fold away in `datapath`), or
    an integer tensor that broadcasts against the state (the masks are
    then int32 tensors and every term is evaluated).  All multi-way
    selects collapse here into per-option all-ones/all-zeros word masks,
    so the datapath is pure and/or/xor/shift.
    """
    def flag(name):
        return _mask(get(name) == 1)

    def sel(name, val):
        return _mask(get(name) == val)

    tt = get("truth_table")
    b_ext = flag("b_ext")
    wp1, wp2 = flag("wp1_en"), flag("wp2_en")
    ce, me = flag("c_en"), flag("m_en")
    return dict(
        src1=get("src1_row"), src2=get("src2_row"),
        dst=get("dst_row"), dst2=get("dst2_row"), tt=tt,
        # TR truth-table bits as minterm masks: tt[i] selects (A<<1)|B == i
        tt0=_mask(((tt >> 0) & 1) == 1), tt1=_mask(((tt >> 1) & 1) == 1),
        tt2=_mask(((tt >> 2) & 1) == 1), tt3=_mask(((tt >> 3) & 1) == 1),
        # operand-B substitution (OOOR): b = (b_read & keep_b) | ext_and
        keep_b=_not(b_ext), ext_and=_and(flag("ext_bit"), b_ext),
        # latch control
        crst_keep=_not(flag("c_rst")), ce=ce, nce=_not(ce), me=me,
        nme=_not(me),
        # per-port write enables, wp folded in:
        # we = pa | (mask & pm) | (carry & pc) | (~carry & pn)
        p1a=_and(sel("pred_sel", isa.PRED_ALWAYS), wp1),
        p1m=_and(sel("pred_sel", isa.PRED_MASK), wp1),
        p1c=_and(sel("pred_sel", isa.PRED_CARRY), wp1),
        p1n=_and(sel("pred_sel", isa.PRED_NOT_CARRY), wp1),
        p2a=_and(sel("pred2_sel", isa.PRED_ALWAYS), wp2),
        p2m=_and(sel("pred2_sel", isa.PRED_MASK), wp2),
        p2c=_and(sel("pred2_sel", isa.PRED_CARRY), wp2),
        p2n=_and(sel("pred2_sel", isa.PRED_NOT_CARRY), wp2),
        # write-mux one-hots (W1_DIN / W2_DIN / W2_ZERO all drive 0)
        v1s=sel("w1_sel", isa.W1_S), v1r=sel("w1_sel", isa.W1_RIGHT),
        v2c=sel("w2_sel", isa.W2_CARRY), v2l=sel("w2_sel", isa.W2_LEFT),
    )


def _shifted(s: torch.Tensor, chain: bool):
    """(from_right, from_left): lane c+1 -> c and lane c-1 -> c.

    Funnel shifts over ``[..., nb, W]`` words: from_right crosses words
    via word w+1's bit 0, from_left via word w-1's bit 31.  chain=True
    threads corner PEs: block k's high boundary word is block k+1's word 0
    (bit 0 used), its low boundary block k-1's word W-1 (bit 31); leading
    axes (grid slots) are never crossed.
    """
    zero = torch.zeros_like(s[..., :1, :1])
    if chain:
        hi = torch.cat([s[..., 1:, :1], zero], dim=-2)
        lo = torch.cat([zero, s[..., :-1, -1:]], dim=-2)
    else:
        hi = torch.zeros_like(s[..., :1])
        lo = hi
    s_hi = torch.cat([s[..., 1:], hi], dim=-1)          # word w+1
    s_lo = torch.cat([lo, s[..., :-1]], dim=-1)         # word w-1
    from_right = ((s >> 1) & _LOW31) | (s_hi << (PACK - 1))
    from_left = (s << 1) | ((s_lo >> (PACK - 1)) & 1)
    return from_right, from_left


def datapath(a, b_read, carry, mask, x, chain: bool):
    """One PE cycle on packed words; returns the write-back bundle.

    ``a`` / ``b_read`` are the packed Port-A/Port-B row reads
    (``[..., nb, W]`` int32), ``carry`` / ``mask`` the packed latches,
    ``x`` one instruction's `prepare_fields` bundle.  Returns
    ``(carry_next, mask_next, val1, we1, val2, we2)``, each a tensor or a
    constant word (0 / -1) - the caller owns the two read-modify-write
    row updates (their order, port 1 then port 2, matters when both
    target the same row).
    """
    b = _or(_and(b_read, x["keep_b"]), x["ext_and"])
    b_t = _tensor(b, a)

    # ---- compute: TR mux (one expression for a known truth table, else
    # the 4-minterm word expansion) ---------------------------------------
    if _is_const(x["tt"]):
        tr = _TR[x["tt"] & 0xF](a, b_t)
    else:
        na, nb_ = ~a, ~b_t
        tr = _or(_and(x["tt0"], na, nb_), _and(x["tt1"], na, b_t),
                 _and(x["tt2"], a, nb_), _and(x["tt3"], a, b_t))
    c_in = _and(carry, x["crst_keep"])                  # gated carry input
    s = _xor(tr, c_in)                                  # gate X
    if _is_const(x["ce"]) and x["ce"] == 0:
        carry_next = carry
    else:
        cgen = _or(_and(a, b_t), _and(c_in, _xor(a, b_t)))   # CGEN
        carry_next = _or(_and(cgen, x["ce"]), _and(carry, x["nce"]))
    mask_next = _or(_and(tr, x["me"]), _and(mask, x["nme"]))

    # ---- predicated write enables on the *latched* values ---------------
    ncarry = _not(carry)
    we1 = _or(x["p1a"], _and(mask, x["p1m"]), _and(carry, x["p1c"]),
              _and(ncarry, x["p1n"]))
    we2 = _or(x["p2a"], _and(mask, x["p2m"]), _and(carry, x["p2c"]),
              _and(ncarry, x["p2n"]))

    # ---- shift network, only where a write takes it ---------------------
    from_right = from_left = 0
    need_r = not (_is_const(x["v1r"]) and x["v1r"] == 0) and \
        not (_is_const(we1) and we1 == 0)
    need_l = not (_is_const(x["v2l"]) and x["v2l"] == 0) and \
        not (_is_const(we2) and we2 == 0)
    if need_r or need_l:
        from_right, from_left = _shifted(_tensor(s, a), chain)

    # W2 carry source is the raw latch (pre-update)
    val1 = _or(_and(s, x["v1s"]), _and(from_right, x["v1r"]))
    val2 = _or(_and(carry, x["v2c"]), _and(from_left, x["v2l"]))
    return carry_next, mask_next, val1, we1, val2, we2


def _merge(old: torch.Tensor, val, we):
    """Row after a predicated write: ``(old & ~we) | (val & we)``."""
    if _is_const(we):
        return old if we == 0 else _tensor(val, old)
    return _or(_and(old, _not(we)), _and(val, we))


# ---------------------------------------------------------------------------
# the scan runners (the CUDA kernel's plain version)
# ---------------------------------------------------------------------------

def _prepare_rows(rows: Sequence[Sequence[int]]) -> List[dict]:
    return [prepare_fields(lambda name, f=f: f[_F[name]]) for f in rows]


# prepared field bundles of frozen (encode-cache) matrices, keyed by the
# matrix's id and holding it: a hot chunk program is prepared once, not
# per run
_PREPARED: dict = {}
_PREPARED_MAX = 512


def _prepared(prog) -> List[dict]:
    """A program matrix (numpy or tensor) -> one bundle per instruction."""
    if isinstance(prog, torch.Tensor):
        return _prepare_rows(prog.tolist())
    prog = np.asarray(prog)
    if prog.flags.writeable:
        return _prepare_rows(prog.tolist())
    entry = _PREPARED.get(id(prog))
    if entry is None:
        if len(_PREPARED) >= _PREPARED_MAX:
            _PREPARED.pop(next(iter(_PREPARED)))
        entry = _PREPARED[id(prog)] = (prog, _prepare_rows(prog.tolist()))
    return entry[1]


def _scan(mem: torch.Tensor, carry: torch.Tensor, mask: torch.Tensor,
          bundles: Sequence[dict], chain: bool):
    """Run the prepared instructions on packed state, in place.

    ``mem [..., nb, R, W]`` is held as a list of row tensors while the
    scan runs (a write replaces a list entry, a read is a list lookup, so
    no row is ever aliased), then copied back.  Returns (carry, mask).
    """
    if not bundles:
        return carry, mask
    state = list(mem.unbind(dim=-2))
    c, m = carry, mask
    for x in bundles:
        c_next, m_next, val1, we1, val2, we2 = datapath(
            state[x["src1"]], state[x["src2"]], c, m, x, chain)
        # port 1 writes first; port 2 reads the updated row (matters when
        # a co-issued pair degenerates to dst2 == dst)
        state[x["dst"]] = _merge(state[x["dst"]], val1, we1)
        state[x["dst2"]] = _merge(state[x["dst2"]], val2, we2)
        c, m = _tensor(c_next, carry), _tensor(m_next, mask)
    # c and m may be views of rows of mem: copy them out before mem
    out = torch.stack(state, dim=-2)
    carry.copy_(c)
    mask.copy_(m)
    mem.copy_(out)
    return carry, mask


def _run_packed(mem, carry, mask, prog, chain: bool):
    """One shared program on packed state ``[..., nb, R, W]``, in place."""
    _scan(mem, carry, mask, _prepared(prog), chain)
    return mem, carry, mask


def _run_slotwise_packed(mem, carry, mask, progs, chain: bool):
    """Per-slot programs ``progs[g]`` on slot g of ``[G, nb, R, W]``."""
    for g in range(mem.shape[0]):
        _scan(mem[g], carry[g], mask[g], _prepared(progs[g]), chain)
    return mem, carry, mask


# ---------------------------------------------------------------------------
# engine objects (the strategy `ComefaArray`/`ComefaGrid` dispatch through)
# ---------------------------------------------------------------------------

class PackedEngine:
    """Packed int32 state, word-parallel torch scan - on any device.

    Same protocol as `block._ReferenceEngine`.  ``run``/``run_per_slot``
    take the host program matrix and update the state in place;
    ``write_rows``/``read_rows`` move whole packed rows of a grid's
    ``[G, nb, R, W]`` state without materialising it on the host.
    """

    name = "packed"

    def to_device(self, mem, carry, mask, device):
        return tuple(pack_bits(np.ascontiguousarray(v)).to(device)
                     for v in (mem, carry, mask))

    def to_host(self, state):
        return tuple(np.array(unpack_bits(v).cpu().numpy())
                     for v in state)

    def run(self, state, mat: np.ndarray, chain: bool):
        return _run_packed(*state, mat, chain)

    def run_per_slot(self, state, mats: np.ndarray, chain: bool):
        return _run_slotwise_packed(*state, mats, chain)

    def write_rows(self, state, rows, words: torch.Tensor):
        state[0][:, :, rows, :] = words
        return state

    def read_rows(self, state, rows) -> torch.Tensor:
        return state[0][:, :, rows, :].clone()


class CudaEngine(PackedEngine):
    """Packed state driven by the hand-written CUDA step kernel.

    Same packed layout as `PackedEngine` (so ``to_device``/``to_host`` and
    the row staging are inherited); each dispatch is ONE kernel launch
    (`repro_torch.kernels.comefa_step.run_packed`) on the program decoded
    by `comefa_step.decoded` (once for a frozen matrix).  The state must live
    on a CUDA device: anything else raises, nothing falls back.
    """

    name = "cuda"

    @staticmethod
    def _kernel():
        from ...kernels import comefa_step     # kernels import this module
        return comefa_step

    def _prog(self, mat: np.ndarray, device) -> torch.Tensor:
        # the kernel's decoded program: cached for a frozen matrix
        return self._kernel().decoded(mat, device)

    def run(self, state, mat: np.ndarray, chain: bool):
        mem, carry, mask = state
        _require_cuda(mem)
        prog = self._prog(mat, mem.device)
        ks = self._kernel()
        if mem.dim() == 3:     # single array: add the slot axis the grid has
            ks.run_packed(mem[None], carry[None], mask[None], prog,
                          chain=chain, per_slot=False)
            return state
        ks.run_packed(mem, carry, mask, prog, chain=chain, per_slot=False)
        return state

    def run_per_slot(self, state, mats: np.ndarray, chain: bool):
        _require_cuda(state[0])
        self._kernel().run_packed(*state, self._prog(mats, state[0].device),
                                  chain=chain, per_slot=True)
        return state


def _require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise RuntimeError(f"engine 'cuda' runs on a CUDA device; this "
                           f"state lies on {t.device}")


_PACKED = PackedEngine()
_CUDA = CudaEngine()


def get_engine(name: str):
    """Packed-engine registry half of `block.get_engine`.

    ``"packed"`` is the torch scan, ``"cuda"`` the CUDA kernel; there is
    no automatic choice between them and no fallback.
    """
    if name == "packed":
        return _PACKED
    if name == "cuda":
        return _CUDA
    raise ValueError(f"unknown CoMeFa engine {name!r} "
                     "(expected reference|packed|cuda)")
