"""The port's CoMeFa simulator engines held to the JAX package's.

The contract: the port's ``reference`` (uint8 torch scan) and ``packed``
(word-parallel torch scan, the CUDA step kernel's plain version) engines
leave mem, carry and mask bit-identical to the JAX ``reference`` and
``packed-xla`` engines, with equal cycle counts, for random instruction
streams (every select, predication on stale latches, co-issued port-2
writes), chained and unchained multi-block arrays, `run_programs` latch
resets both ways, and grid shared / per-slot dispatch.  The JAX ``pallas``
engine is not used: it does not run on this JAX.  Everything here runs on
the CPU; the ``cuda`` engine must refuse a CPU device.
"""
import numpy as np
import pytest
import torch

from repro.core.comefa import ComefaArray as JaxArray
from repro.core.comefa import ComefaGrid as JaxGrid
from repro.core.comefa import engine_packed as jax_packed
from repro_torch.core.comefa import (ComefaArray, ComefaGrid, engine_packed,
                                     isa, layout)
from repro_torch.core.comefa.isa import ROW_ONES, ROW_ZEROS
from repro_torch.kernels import comefa_step

PROG_LEN = 16          # as tests/test_engines.py: JAX's CPU scans are slow
JAX_ENGINES = ["reference", "packed-xla"]
ENGINES = ["reference", "packed"]


def _random_instr(rng) -> isa.Instr:
    return isa.Instr(
        src1_row=int(rng.integers(0, isa.N_ROWS)),
        src2_row=int(rng.integers(0, isa.N_ROWS)),
        dst_row=int(rng.integers(0, isa.N_ROWS)),
        truth_table=int(rng.integers(0, 16)),
        pred_sel=int(rng.integers(0, 4)),
        w1_sel=int(rng.choice([isa.W1_S, isa.W1_DIN, isa.W1_RIGHT])),
        w2_sel=int(rng.choice([isa.W2_CARRY, isa.W2_DIN, isa.W2_LEFT,
                               isa.W2_ZERO])),
        wp1_en=int(rng.integers(0, 2)),
        wp2_en=int(rng.integers(0, 2)),
        c_en=int(rng.integers(0, 2)),
        c_rst=int(rng.integers(0, 2)),
        m_en=int(rng.integers(0, 2)),
        ext_bit=int(rng.integers(0, 2)),
        b_ext=int(rng.integers(0, 2)))


def _random_matrix(rng, length: int = PROG_LEN) -> np.ndarray:
    """Encoded rows with independent dst2/pred2 (co-issued port-2 writes,
    including dst2 == dst), which `Instr` alone never produces."""
    mat = isa.encode_program([_random_instr(rng) for _ in range(length)])
    mat[:, -2] = np.where(rng.integers(0, 3, length) == 0, mat[:, 2],
                          rng.integers(0, isa.N_ROWS - 2, length))
    mat[:, -1] = rng.integers(0, 4, length)
    return mat


def _random_state(rng, shape_lead):
    mem = rng.integers(0, 2, size=shape_lead + (isa.N_ROWS, isa.N_COLS),
                       dtype=np.uint8)
    mem[..., ROW_ZEROS, :] = 0
    mem[..., ROW_ONES, :] = 1
    carry = rng.integers(0, 2, size=shape_lead + (isa.N_COLS,),
                         dtype=np.uint8)
    mask = rng.integers(0, 2, size=shape_lead + (isa.N_COLS,),
                        dtype=np.uint8)
    return mem, carry, mask


def _load(arr, state):
    arr.mem, arr.carry, arr.mask = (s.copy() for s in state)
    return arr


def _assert_same(a, b, label):
    np.testing.assert_array_equal(a.mem, b.mem, err_msg=f"{label} mem")
    np.testing.assert_array_equal(a.carry, b.carry, err_msg=f"{label} carry")
    np.testing.assert_array_equal(a.mask, b.mask, err_msg=f"{label} mask")
    assert a.cycles == b.cycles, f"{label} cycles"


# ---------------------------------------------------------------------------
# packing layout
# ---------------------------------------------------------------------------

def test_pack_bits_round_trip_and_equal_to_jax():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, size=(3, 7, isa.N_COLS), dtype=np.uint8)
    words = engine_packed.pack_bits(bits)
    assert words.dtype == torch.int32
    assert tuple(words.shape) == (3, 7, engine_packed.N_WORDS)
    np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                  jax_packed.pack_bits(bits))
    np.testing.assert_array_equal(engine_packed.unpack_bits(words).numpy(),
                                  bits)
    np.testing.assert_array_equal(
        engine_packed.unpack_bits(jax_packed.pack_bits(bits)).numpy(), bits)
    one = np.zeros(isa.N_COLS, dtype=np.uint8)
    for lane in (0, 1, 31, 32, 95, 159):
        one[:] = 0
        one[lane] = 1
        w = engine_packed.pack_bits(one).numpy().view(np.uint32)
        assert w[lane // 32] == np.uint32(1) << (lane % 32), lane
        assert (w != 0).sum() == 1


def test_row_words_match_place_and_extract():
    """`layout.to_row_words` / `from_row_words` are `place` / `extract`
    for whole rows of packed state."""
    rng = np.random.default_rng(1)
    nb, n_bits, n = 2, 6, 250
    vals = rng.integers(0, 1 << n_bits, size=n)
    arr = ComefaArray(n_blocks=nb, device="cpu")
    padded = np.pad(vals, (0, nb * isa.N_COLS - n)).reshape(nb, isa.N_COLS)
    layout.place(arr, padded, 10, n_bits)
    words = layout.to_row_words(torch.as_tensor(vals), n_bits, nb)
    assert tuple(words.shape) == (n_bits, nb, engine_packed.N_WORDS)
    want = engine_packed.pack_bits(arr.mem[:, 10:10 + n_bits])
    assert torch.equal(words, want.transpose(0, 1))
    back = layout.from_row_words(words)
    np.testing.assert_array_equal(back.numpy()[:n], vals)
    np.testing.assert_array_equal(
        back.numpy().reshape(nb, -1),
        layout.extract(arr, 10, n_bits))
    signed = layout.from_row_words(words, signed=True).numpy()[:n]
    np.testing.assert_array_equal(
        signed, np.where(vals >= 1 << (n_bits - 1), vals - (1 << n_bits),
                         vals))


# ---------------------------------------------------------------------------
# the core bit-identity property against the JAX engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jax_engine", JAX_ENGINES)
@pytest.mark.parametrize("n_blocks", [1, 2, 4])
@pytest.mark.parametrize("chain", [False, True])
def test_engines_bit_identical_to_jax_on_random_streams(jax_engine,
                                                        n_blocks, chain):
    rng = np.random.default_rng(100 * n_blocks + 10 * chain +
                                len(jax_engine))
    mat = _random_matrix(rng)
    state = _random_state(rng, (n_blocks,))
    want = _load(JaxArray(n_blocks=n_blocks, chain=chain,
                          engine=jax_engine), state)
    assert want.run(mat) == PROG_LEN
    for eng in ENGINES:
        got = _load(ComefaArray(n_blocks=n_blocks, chain=chain, engine=eng,
                                device="cpu"), state)
        assert got.run(mat) == PROG_LEN
        _assert_same(got, want, f"{eng} vs jax {jax_engine}")


@pytest.mark.parametrize("reset", [False, True])
@pytest.mark.parametrize("n_blocks", [1, 2])
def test_run_programs_boundaries_match_jax(reset, n_blocks):
    rng = np.random.default_rng(7 + reset + 2 * n_blocks)
    progs = [[_random_instr(rng) for _ in range(8)] for _ in range(3)]
    state = _random_state(rng, (n_blocks,))
    want = _load(JaxArray(n_blocks=n_blocks, engine="packed-xla"), state)
    counts = want.run_programs(progs, reset_latches=reset)
    for eng in ENGINES:
        got = _load(ComefaArray(n_blocks=n_blocks, engine=eng,
                                device="cpu"), state)
        assert got.run_programs(progs, reset_latches=reset) == counts
        _assert_same(got, want, eng)


def test_chain_shift_heavy_streams_match_jax():
    """Cross-word AND cross-block funnel-shift seams, shift-only streams."""
    rng = np.random.default_rng(3)
    prog = [isa.Instr(src1_row=int(rng.integers(0, isa.N_ROWS)),
                      src2_row=int(rng.integers(0, isa.N_ROWS)),
                      dst_row=int(rng.integers(0, isa.N_ROWS)),
                      truth_table=int(rng.integers(0, 16)),
                      w1_sel=isa.W1_RIGHT, w2_sel=isa.W2_LEFT,
                      wp1_en=1, wp2_en=int(rng.integers(0, 2)),
                      c_en=1, m_en=1)
            for _ in range(PROG_LEN)]
    state = _random_state(rng, (3,))
    want = _load(JaxArray(n_blocks=3, chain=True), state)
    want.run(prog)
    for eng in ENGINES:
        got = _load(ComefaArray(n_blocks=3, chain=True, engine=eng,
                                device="cpu"), state)
        got.run(prog)
        _assert_same(got, want, eng)


@pytest.mark.parametrize("eng", ENGINES)
def test_predication_reads_stale_latches(eng):
    """Predication sees the *previous* cycle's latches, not this one's."""
    prog = [
        isa.Instr(src1_row=ROW_ZEROS, src2_row=ROW_ZEROS,
                  truth_table=isa.TT_AND, c_en=1, c_rst=1, m_en=1),
        isa.Instr(src1_row=ROW_ONES, src2_row=ROW_ONES,
                  truth_table=isa.TT_AND, dst_row=0, wp1_en=1,
                  pred_sel=isa.PRED_CARRY, c_en=1, c_rst=1, m_en=1),
        isa.Instr(src1_row=ROW_ONES, src2_row=ROW_ONES,
                  truth_table=isa.TT_AND, dst_row=1, wp1_en=1,
                  pred_sel=isa.PRED_MASK, c_rst=1),
    ]
    arr = ComefaArray(n_blocks=1, engine=eng, device="cpu")
    arr.run(prog)
    assert (arr.mem[:, 0, :] == 0).all()
    assert (arr.mem[:, 1, :] == 1).all()


# ---------------------------------------------------------------------------
# grid dispatch: shared and per-slot, against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("chain", [False, True])
def test_grid_per_slot_dispatch_matches_jax(g, chain):
    rng = np.random.default_rng(11 * g + chain)
    mats = [_random_matrix(rng, int(rng.integers(4, 12))) for _ in range(g)]
    state = _random_state(rng, (g, 2))
    want = _load(JaxGrid(g, n_blocks=2, chain=chain, engine="packed-xla"),
                 state)
    counts = want.run_per_slot(mats)
    for eng in ENGINES:
        got = _load(ComefaGrid(g, n_blocks=2, chain=chain, engine=eng,
                               device="cpu"), state)
        assert got.run_per_slot(mats) == counts
        _assert_same(got, want, eng)
        assert got.dispatches == 1


@pytest.mark.parametrize("chain", [False, True])
def test_grid_shared_program_matches_jax(chain):
    rng = np.random.default_rng(21 + chain)
    mat = _random_matrix(rng)
    state = _random_state(rng, (4, 2))
    want = _load(JaxGrid(4, n_blocks=2, chain=chain), state)
    want.run(mat)
    for eng in ENGINES:
        got = _load(ComefaGrid(4, n_blocks=2, chain=chain, engine=eng,
                               device="cpu"), state)
        got.run(mat)
        _assert_same(got, want, eng)


def test_grid_chain_never_crosses_slots():
    """A shift on a chained multi-slot grid equals each slot run alone."""
    rng = np.random.default_rng(4)
    prog = [isa.Instr(src1_row=0, truth_table=isa.TT_COPY_A, c_rst=1,
                      dst_row=1, w1_sel=isa.W1_RIGHT, wp1_en=1),
            isa.Instr(src1_row=0, truth_table=isa.TT_COPY_A, c_rst=1,
                      dst_row=2, w2_sel=isa.W2_LEFT, wp2_en=1)]
    state = _random_state(rng, (3, 2))
    for eng in ENGINES:
        grid = _load(ComefaGrid(3, n_blocks=2, chain=True, engine=eng,
                                device="cpu"), state)
        grid.run(prog)
        for s in range(3):
            alone = _load(ComefaArray(n_blocks=2, chain=True, engine=eng,
                                      device="cpu"),
                          tuple(v[s] for v in state))
            alone.run(prog)
            np.testing.assert_array_equal(grid.mem[s], alone.mem)


def test_grid_rows_staged_on_device_equal_host_placement():
    """`write_rows` / `read_rows` move whole packed rows without a host
    sync and agree with `layout.place` on slot views."""
    rng = np.random.default_rng(5)
    vals = rng.integers(0, 256, size=(3, 300))
    for eng in ENGINES:
        host = ComefaGrid(3, n_blocks=2, engine=eng, device="cpu")
        for g in range(3):
            padded = np.pad(vals[g], (0, 20)).reshape(2, isa.N_COLS)
            layout.place(host.slot(g), padded, 40, 8)
        dev = ComefaGrid(3, n_blocks=2, engine=eng, device="cpu")
        words = layout.to_row_words(torch.as_tensor(vals), 8, 2)
        dev.write_rows(range(40, 48), words.transpose(-3, -2))
        assert dev.host_syncs == 0 and dev.device_puts == 1
        back = layout.from_row_words(
            dev.read_rows(range(40, 48)).transpose(-3, -2))
        np.testing.assert_array_equal(back.numpy()[:, :300], vals)
        assert dev.host_syncs == 0
        np.testing.assert_array_equal(dev.mem, host.mem)


# ---------------------------------------------------------------------------
# the plain scan itself, the CUDA wrapper on the CPU, engine selection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_folded_datapath_equals_full_evaluation(seed):
    """With Python-int fields `datapath` folds switched-off terms away
    (a value whose write is disabled may be left out); with tensor fields
    it evaluates every term - the same latches and the same rows after
    both port writes."""
    rng = np.random.default_rng(seed)
    mat = _random_matrix(rng, 40)
    a, b, carry, mask = (engine_packed.pack_bits(
        rng.integers(0, 2, (2, isa.N_COLS), dtype=np.uint8))
        for _ in range(4))
    fields = {n: i for i, n in enumerate(isa.ENGINE_FIELD_NAMES)}
    for row in mat.tolist():
        for chain in (False, True):
            x = engine_packed.prepare_fields(lambda n: row[fields[n]])
            xt = engine_packed.prepare_fields(
                lambda n: torch.tensor(row[fields[n]]))
            outs = []
            for bundle in (x, xt):
                c, m, val1, we1, val2, we2 = engine_packed.datapath(
                    a, b, carry, mask, bundle, chain)
                mem_row = engine_packed._merge(mask, val1, we1)
                mem_row = engine_packed._merge(mem_row, val2, we2)
                outs.append([engine_packed._tensor(v, a)
                             for v in (c, m, mem_row)])
            for u, v in zip(*outs):
                assert torch.equal(u, v)


def test_cuda_wrapper_takes_the_plain_version_on_cpu():
    rng = np.random.default_rng(6)
    state = [engine_packed.pack_bits(v)
             for v in _random_state(rng, (2, 2))]
    mat = torch.as_tensor(_random_matrix(rng, 24))
    before = comefa_step.launches
    got = comefa_step.run_packed(*[v.clone() for v in state], mat,
                                 chain=True, per_slot=False)
    want = comefa_step.run_packed_plain(*[v.clone() for v in state], mat,
                                        chain=True, per_slot=False)
    assert comefa_step.launches == before
    assert all(torch.equal(u, v) for u, v in zip(got, want))
    with pytest.raises(ValueError, match="prog must be"):
        comefa_step.run_packed(*state, mat, chain=True, per_slot=True)
    with pytest.raises(ValueError, match="int32"):
        comefa_step.run_packed(state[0].long(), *state[1:], mat,
                               chain=True, per_slot=False)


def test_engine_follows_device_and_cuda_engine_refuses_cpu():
    assert ComefaArray(device="cpu").engine.name == "reference"
    assert ComefaGrid(2, device="cpu", engine="packed").engine.name == \
        "packed"
    with pytest.raises(RuntimeError, match="CUDA"):
        ComefaGrid(2, device="cpu", engine="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        ComefaArray(device="cpu", engine="cuda")
    with pytest.raises(ValueError, match="unknown CoMeFa engine"):
        ComefaArray(device="cpu", engine="pallas")


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        ComefaArray()
    with pytest.raises(RuntimeError, match="is_available"):
        ComefaGrid(2)


@pytest.mark.parametrize("eng", ENGINES)
def test_state_stays_on_device_between_runs(eng):
    """run(); run() chains device state: one upload, no host sync."""
    prog = [isa.Instr(src1_row=ROW_ONES, truth_table=isa.TT_COPY_A,
                      dst_row=3, wp1_en=1)]
    arr = ComefaArray(n_blocks=2, engine=eng, device="cpu")
    arr.run(prog)
    arr.run(prog)
    assert (arr.device_puts, arr.host_syncs, arr.dispatches) == (1, 0, 2)
    assert (arr.mem[:, 3] == 1).all()
    assert arr.host_syncs == 1
