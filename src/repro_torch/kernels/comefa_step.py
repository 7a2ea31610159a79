"""CoMeFa simulator step: T encoded instructions on packed state, on Hopper.

This is the port of the Pallas kernel `repro.kernels.comefa_step`
(`run_packed`), which runs the bit-packed engine's datapath
(`core.comefa.engine_packed.datapath`) for a whole instruction stream in
one call.  The CUDA kernel is `csrc/comefa_step.cu`; its header says what
bounds it on the card (the dependent chain of T instructions, not bytes)
and how its design answers that.

The kernel reads a *decoded* program: `decode` turns the ``[..., T, 16]``
engine field matrix into ``[..., T, 24]`` int32 words with the folding of
`engine_packed.prepare_fields` (row offsets packed into two words, every
select an all-ones/all-zeros mask), on the matrix's device.  `decoded`
does it for the grid's ``"cuda"`` engine: a frozen (encode-cache) matrix
is decoded once and cached by its id and device; a writable one (a
per-slot stack) is decoded afresh on every call.

`run_packed` is the wrapper, behind the grid's ``"cuda"`` engine.  It
takes the field matrix or its decoded form (told apart by the last axis,
16 or 24).  A tensor on the CPU takes a plain PyTorch version: the
word-parallel torch scan of the ``"packed"`` engine (`run_packed_plain`)
for fields, `run_decoded_plain` (the kernel's arithmetic on the decoded
words) for a decoded program; a CUDA tensor launches the kernel or
raises.  All update ``mem``, ``carry`` and ``mask`` in place and return
them.  The module-level `launches` counts kernel launches, so a run can
show that its path went through the kernel.

On the card a chained slot holds at most `MAX_CHAIN_BLOCKS` blocks (a
cluster of eight CTAs, each holding 78 blocks in shared memory);
`check_launch` refuses a longer chain before the launch, and a slot count
beyond the C interface's int.  The CPU versions run any size.

The kernel is compiled by `nvcc` for ``sm_90a`` at first use, from the
source in this package (`nvcc.build`), and called through its plain C
function with `ctypes`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from ..core.comefa import block, isa
from ..core.comefa.engine_packed import (_F, N_WORDS, _run_packed,
                                         _run_slotwise_packed, _shifted,
                                         prepare_fields)
from . import nvcc

SOURCE = Path(__file__).with_name("csrc") / "comefa_step.cu"
# the decoded program's words after `srcs`, `dsts` and `same`, in the
# kernel's order (csrc/comefa_step.cu); each is a prepare_fields mask
MASKS = ("tt0", "tt1", "tt2", "tt3", "keep_b", "ext_and", "crst_keep", "ce",
         "me", "p1a", "p1m", "p1c", "p1n", "p2a", "p2m", "p2c", "p2n", "v1s",
         "v1r", "v2c", "v2l")
DECODED_WORDS = 3 + len(MASKS)          # 24: six 16-byte loads a step
TILE = 64                               # instructions a staged tile (kTile)
_ROW_MASK = isa.N_ROWS - 1
ROW_BYTES = 128                         # a row of a warp's state: 32 words
BLOCKS_PER_WARP, MAX_WARPS, MAX_CLUSTER = 6, 13, 8   # csrc/comefa_step.cu
MAX_CHAIN_BLOCKS = BLOCKS_PER_WARP * MAX_WARPS * MAX_CLUSTER      # 624
MAX_SLOTS = 2 ** 31 - 1                 # an int of the C interface

launches = 0          # kernel launches since the last reset (set it to 0)
_lib = None


def build() -> Path:
    """Compile the kernel into a shared library, once per source hash
    (`nvcc.build`).  Returns the library's path."""
    return nvcc.build(SOURCE)[0]


def _library():
    global _lib
    if _lib is None:
        _lib = nvcc.load(SOURCE, {
            "comefa_step_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
            + [ctypes.c_void_p],
            "comefa_step_max_clusters": [ctypes.c_int] * 2
            + [ctypes.c_void_p]})
    return _lib


def ctas_per_slot(nb: int, chain: bool) -> int:
    """CTAs the kernel gives one slot of `nb` blocks: one a warp of six
    blocks unchained; chained, one CTA up to 13 warps, else a cluster of
    2, 4 or 8 CTAs."""
    groups = -(-nb // BLOCKS_PER_WARP)
    if not chain:
        return groups
    ctas = 1
    while ctas * MAX_WARPS < groups:
        ctas *= 2
    return ctas


def check_launch(slots: int, nb: int, chain: bool) -> None:
    """Raise ValueError, naming the limit, for a launch the kernel cannot
    run: a chained slot of more than `MAX_CHAIN_BLOCKS` blocks, or more
    than `MAX_SLOTS` slots."""
    if chain and nb > MAX_CHAIN_BLOCKS:
        raise ValueError(f"a chained slot holds at most {MAX_CHAIN_BLOCKS} "
                         f"blocks on the cuda engine (got nb={nb}); the "
                         f"packed and reference engines run any nb")
    if slots > MAX_SLOTS:
        raise ValueError(f"a launch holds at most {MAX_SLOTS} slots on the "
                         f"cuda engine (got {slots})")


def max_active_clusters(nb: int) -> tuple:
    """(CTAs a cluster, warps a CTA, clusters the card holds at once) for
    a chained slot of `nb` blocks (more than 78, so a cluster), from
    cudaOccupancyMaxActiveClusters."""
    ctas = ctas_per_slot(nb, True)
    groups = -(-nb // BLOCKS_PER_WARP)
    warps = -(-groups // ctas)
    out = ctypes.c_int(0)
    err = _library().comefa_step_max_clusters(ctas, warps,
                                              ctypes.byref(out))
    if err:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: "
                           f"cudaError {err}")
    return ctas, warps, out.value


def decode(prog: torch.Tensor) -> torch.Tensor:
    """Engine field matrix ``[..., T, 16]`` -> decoded ``[..., T, 24]``
    int32, on the matrix's device (torch ops, no host round trip).

    Words 0 and 1 hold the rows as byte offsets into a lane's column of
    the kernel's state (``row * ROW_BYTES``): ``src1 | src2 << 16`` with
    bit 0 set when a write takes a shifted value (the kernel then moves
    seams), and ``dst | dst2 << 16``.  Word 2 is all-ones when ``dst2 ==
    dst``; words 3-23 are the masks of `prepare_fields` named in `MASKS`.
    """
    f = prog.to(torch.int32)
    x = prepare_fields(lambda name: f[..., _F[name]])

    def off(name):
        return (x[name] & _ROW_MASK) * ROW_BYTES

    writes1 = x["p1a"] | x["p1m"] | x["p1c"] | x["p1n"]
    writes2 = x["p2a"] | x["p2m"] | x["p2c"] | x["p2n"]
    shift = ((x["v1r"] & writes1) | (x["v2l"] & writes2)) & 1
    srcs = off("src1") | (off("src2") << 16) | shift
    dsts = off("dst") | (off("dst2") << 16)
    same = -(off("dst") == off("dst2")).to(torch.int32)
    words = [srcs, dsts, same] + [x[k] for k in MASKS]
    return torch.stack([w.to(torch.int32) for w in words], dim=-1) \
        .contiguous()


# decoded device programs of frozen (encode-cache) matrices: a hot chunk
# program is decoded once, not per run
_DECODED: dict = {}
_DECODED_MAX = 512


def decoded(mat: np.ndarray, device) -> torch.Tensor:
    """The decoded program of an encoded matrix, on `device`.

    A frozen matrix decodes once: the entry keys on ``(id(mat), device)``
    and holds the matrix, so its id cannot be recycled under it; FIFO
    eviction bounds the cache, and its hits and misses count as the
    encode cache's ``device_hits`` / ``device_misses``.  A writable matrix
    (a per-slot stack) may change after this call, so it is uploaded and
    decoded on the device every time.
    """
    device = torch.device(device)
    if mat.flags.writeable:
        return decode(torch.tensor(mat, dtype=torch.int32, device=device))
    key = (id(mat), str(device))
    entry = _DECODED.get(key)
    block._ENCODE_EVENTS.inc(event="device_misses" if entry is None
                             else "device_hits")
    if entry is None:
        if len(_DECODED) >= _DECODED_MAX:
            _DECODED.pop(next(iter(_DECODED)))
        entry = _DECODED[key] = (mat, decode(torch.tensor(
            mat, dtype=torch.int32, device=device)))
    return entry[1]


def _check(mem: torch.Tensor, carry: torch.Tensor, mask: torch.Tensor,
           prog: torch.Tensor, per_slot: bool) -> None:
    if mem.dim() != 4 or mem.shape[2:] != (isa.N_ROWS, N_WORDS):
        raise ValueError(f"mem must be [S, nb, {isa.N_ROWS}, {N_WORDS}], "
                         f"got {tuple(mem.shape)}")
    s, nb = mem.shape[:2]
    for name, t in (("carry", carry), ("mask", mask)):
        if tuple(t.shape) != (s, nb, N_WORDS):
            raise ValueError(f"{name} must be [{s}, {nb}, {N_WORDS}], got "
                             f"{tuple(t.shape)}")
    lead = (s,) if per_slot else ()
    if prog.dim() != len(lead) + 2 or tuple(prog.shape[:-2]) != lead or \
            prog.shape[-1] not in (isa.N_ENGINE_FIELDS, DECODED_WORDS):
        want = "[S, T, F]" if per_slot else "[T, F]"
        raise ValueError(f"prog must be {want} with F = "
                         f"{isa.N_ENGINE_FIELDS} (fields) or "
                         f"{DECODED_WORDS} (decoded), got "
                         f"{tuple(prog.shape)}")
    for name, t in (("mem", mem), ("carry", carry), ("mask", mask),
                    ("prog", prog)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != mem.device:
            raise ValueError(f"tensors on different devices: mem "
                             f"{mem.device}, {name} {t.device}")


def _is_decoded(prog: torch.Tensor) -> bool:
    return prog.shape[-1] == DECODED_WORDS


def run_packed_plain(mem: torch.Tensor, carry: torch.Tensor,
                     mask: torch.Tensor, prog: torch.Tensor, *,
                     chain: bool, per_slot: bool):
    """The kernel's function in plain PyTorch: the packed engine's scan
    on the field matrix ``[..., T, 16]``."""
    _check(mem, carry, mask, prog, per_slot)
    if _is_decoded(prog):
        raise ValueError("run_packed_plain takes the field matrix; "
                         "run_decoded_plain takes a decoded program")
    run = _run_slotwise_packed if per_slot else _run_packed
    return run(mem, carry, mask, prog, chain)


def _rows(w):
    """(src1, src2, dst, dst2) of a decoded instruction's words."""
    return tuple(((v >> k) & 0xFFFF) // ROW_BYTES for v in w[:2]
                 for k in (0, 16))


def _scan_decoded(mem, carry, mask, words, chain: bool) -> None:
    """The kernel's arithmetic on packed state ``[..., nb, 128, 5]``, in
    place: decoded instructions (24 Python ints each) in tiles of `TILE`;
    inside a tile the next instruction's four rows are read before this
    one writes, and the rows it writes are forwarded into them."""
    state = list(mem.unbind(dim=-2))
    c, m = carry, mask
    for t0 in range(0, len(words), TILE):
        tile = words[t0:t0 + TILE]
        ahead = [state[r] for r in _rows(tile[0])]
        for i, w in enumerate(tile):
            nrows = _rows(tile[min(i + 1, len(tile) - 1)])
            read = [state[r] for r in nrows]
            a, b_read, old1, old2 = ahead
            shift, same = w[0] & 1, w[2]
            x = dict(zip(MASKS, w[3:]))
            _, _, dst, dst2 = _rows(w)
            b = (b_read & x["keep_b"]) | x["ext_and"]
            tr = (a & ((b & x["tt3"]) | (~b & x["tt2"]))) | \
                (~a & ((b & x["tt1"]) | (~b & x["tt0"])))
            c_in = c & x["crst_keep"]
            s = tr ^ c_in
            cgen = (a & b) | (c_in & (a ^ b))
            we1 = x["p1a"] | (m & x["p1m"]) | (c & x["p1c"]) | \
                (~c & x["p1n"])
            we2 = x["p2a"] | (m & x["p2m"]) | (c & x["p2c"]) | \
                (~c & x["p2n"])
            from_right = from_left = 0
            if shift:
                from_right, from_left = _shifted(s, chain)
            val1 = (s & x["v1s"]) | (from_right & x["v1r"])
            val2 = (c & x["v2c"]) | (from_left & x["v2l"])
            new1 = (old1 & ~we1) | (val1 & we1)
            state[dst] = new1
            base2 = (new1 & same) | (old2 & ~same)
            new2 = (base2 & ~we2) | (val2 & we2)
            state[dst2] = new2
            c = (cgen & x["ce"]) | (c & ~x["ce"])
            m = (tr & x["me"]) | (m & ~x["me"])
            # port 2 wrote last: dst2 wins over dst
            ahead = [new2 if r == dst2 else new1 if r == dst else v
                     for r, v in zip(nrows, read)]
    out = torch.stack(state, dim=-2)
    carry.copy_(c)
    mask.copy_(m)
    mem.copy_(out)


def run_decoded_plain(mem: torch.Tensor, carry: torch.Tensor,
                      mask: torch.Tensor, prog: torch.Tensor, *,
                      chain: bool, per_slot: bool):
    """What the kernel computes from a decoded program ``[..., T, 24]``
    (`decode`), in plain PyTorch: no field is read, only the decoded
    words, in the kernel's order - rows read one instruction ahead inside
    a tile and forwarded from the instruction that writes them."""
    _check(mem, carry, mask, prog, per_slot)
    if not _is_decoded(prog):
        raise ValueError(f"run_decoded_plain takes a decoded program "
                         f"[..., T, {DECODED_WORDS}]")
    if per_slot:
        for g in range(mem.shape[0]):
            _scan_decoded(mem[g], carry[g], mask[g], prog[g].tolist(), chain)
    else:
        _scan_decoded(mem, carry, mask, prog.tolist(), chain)
    return mem, carry, mask


def run_packed(mem: torch.Tensor, carry: torch.Tensor, mask: torch.Tensor,
               prog: torch.Tensor, *, chain: bool, per_slot: bool):
    """Execute a packed program matrix on every slot, in place.

    mem ``[S, nb, 128, 5]`` int32, carry/mask ``[S, nb, 5]`` int32; prog
    int32 ``[T, F]`` (shared) or ``[S, T, F]`` (``per_slot=True``).
    Returns ``(mem, carry, mask)``.  CPU tensors take `run_packed_plain`;
    CUDA tensors launch the kernel on the current stream (no
    synchronisation) and raise if the launch fails, or before it, a
    ValueError for a launch beyond the kernel's limits (`check_launch`).
    """
    global launches
    _check(mem, carry, mask, prog, per_slot)
    if mem.device.type == "cpu":
        plain = run_decoded_plain if _is_decoded(prog) else run_packed_plain
        return plain(mem, carry, mask, prog, chain=chain, per_slot=per_slot)
    if mem.device.type != "cuda":
        raise ValueError(f"no CoMeFa step kernel for device {mem.device}")
    s, nb = mem.shape[:2]
    check_launch(s, nb, chain)
    t = prog.shape[-2]
    if t == 0:
        return mem, carry, mask
    if not _is_decoded(prog):
        prog = decode(prog)
    if prog.data_ptr() % 16:
        raise ValueError("prog must be 16-byte aligned")
    launch = _library().comefa_step_launch
    stream = torch.cuda.current_stream(mem.device).cuda_stream
    err = launch(mem.data_ptr(), carry.data_ptr(), mask.data_ptr(),
                 prog.data_ptr(), s, nb, t, int(chain), int(per_slot),
                 stream)
    if err:
        raise RuntimeError(f"comefa_step kernel launch failed: cudaError "
                           f"{err} (S={s}, nb={nb}, T={t}, chain={chain}, "
                           f"per_slot={per_slot})")
    launches += 1
    return mem, carry, mask
