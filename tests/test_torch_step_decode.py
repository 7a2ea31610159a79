"""The CoMeFa step kernel's decoded program, held to the packed scan.

`kernels.comefa_step.decode` folds the engine field matrix into the words
the CUDA kernel reads (rows as byte offsets, every select an
all-ones/all-zeros mask), and `run_decoded_plain` runs those words in the
kernel's order: tiles of 64 instructions, the next instruction's rows
read before this one writes, the rows it writes forwarded.  Here, on the
CPU, that interpreter must leave mem, carry and mask bit-identical to the
packed engine's scan (`run_packed_plain`, the kernel's plain version) on
seeded random field matrices - with rows drawn from a handful so that
forwarding and dst2 == dst are frequent, and longer than a tile - on the
main path's real chunk programs, shared and per-slot, with `chain` both
ways; and to the JAX package's packed engine on a short stream.  The
cache of decoded programs returns one tensor for a frozen matrix and
decodes a writable one afresh.
"""
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _minihyp import given, settings, strategies as st

from repro.core.comefa import ComefaGrid as JaxGrid
from repro_torch.core.comefa import (ComefaGrid, block, engine_packed, isa,
                                    schedule)
from repro_torch.kernels import comefa_sim
from repro_torch.kernels import comefa_step as cs
from repro_torch.serve import comefa_exec


def _fields(rng, t, rows=isa.N_ROWS):
    """Random engine field rows [t, 16]: every select, out-of-range selects
    (pred 4, w1_sel 3) that switch a write off, rows drawn from `rows`
    values, dst2 == dst on about a third of them."""
    cols = dict(
        src1_row=rng.integers(0, rows, t), src2_row=rng.integers(0, rows, t),
        dst_row=rng.integers(0, rows, t), truth_table=rng.integers(0, 16, t),
        pred_sel=rng.integers(0, 5, t), w1_sel=rng.integers(0, 4, t),
        w2_sel=rng.integers(0, 4, t), wp1_en=rng.integers(0, 2, t),
        wp2_en=rng.integers(0, 2, t), c_en=rng.integers(0, 2, t),
        c_rst=rng.integers(0, 2, t), m_en=rng.integers(0, 2, t),
        ext_bit=rng.integers(0, 2, t), b_ext=rng.integers(0, 2, t),
        dst2_row=rng.integers(0, rows, t), pred2_sel=rng.integers(0, 5, t))
    f = np.stack([cols[k] for k in isa.ENGINE_FIELD_NAMES], axis=1)
    same = rng.integers(0, 3, t) == 0
    f[same, isa.ENGINE_FIELD_NAMES.index("dst2_row")] = f[same, 2]
    return f.astype(np.int32)


def _state(rng, s, nb):
    shapes = ((s, nb, isa.N_ROWS, isa.N_COLS), (s, nb, isa.N_COLS),
              (s, nb, isa.N_COLS))
    return [rng.integers(0, 2, sh, dtype=np.uint8) for sh in shapes]


def _assert_decoded_equals_plain(bits, prog, chain, per_slot):
    state = [engine_packed.pack_bits(v) for v in bits]
    want = cs.run_packed_plain(*[v.clone() for v in state], prog,
                               chain=chain, per_slot=per_slot)
    got = cs.run_decoded_plain(*[v.clone() for v in state], cs.decode(prog),
                               chain=chain, per_slot=per_slot)
    for name, g, w in zip(("mem", "carry", "mask"), got, want):
        assert torch.equal(g, w), name


@given(t=st.integers(1, 40), s=st.integers(1, 3), nb=st.integers(1, 3),
       rows=st.sampled_from([4, isa.N_ROWS]), chain=st.booleans(),
       per_slot=st.booleans(), seed=st.integers(0, 10_000))
@settings(max_examples=30, deadline=None)
def test_decoded_program_equals_packed_scan_property(t, s, nb, rows, chain,
                                                     per_slot, seed):
    rng = np.random.default_rng(seed)
    prog = np.stack([_fields(rng, t, rows) for _ in range(s)]) if per_slot \
        else _fields(rng, t, rows)
    _assert_decoded_equals_plain(_state(rng, s, nb), torch.as_tensor(prog),
                                 chain, per_slot)


@pytest.mark.parametrize("nb", [1, 2, 7])
@pytest.mark.parametrize("chain", [False, True])
@pytest.mark.parametrize("per_slot", [False, True])
def test_decoded_program_across_tiles(nb, chain, per_slot):
    """150 instructions (three 64-instruction tiles) on 8 rows: nearly
    every instruction reads a row its predecessor wrote."""
    rng = np.random.default_rng(100 * nb + 10 * chain + per_slot)
    s = 2
    prog = np.stack([_fields(rng, 150, 8) for _ in range(s)]) if per_slot \
        else _fields(rng, 150, 8)
    _assert_decoded_equals_plain(_state(rng, s, nb), torch.as_tensor(prog),
                                 chain, per_slot)


def _chunk_programs(k, n):
    """The broadcast chunk programs the grid path runs for a (K, N)
    projection at 8-bit weights and activations, and the plan's blocks."""
    acc = comefa_exec.acc_bits_for(8, 8, k)
    k_tile = comefa_sim.gemv_batched_k_tile(8, 8, acc)
    plan = schedule.cached_plan_gemv(k, n, 8, 8, acc, k_tile=min(k, k_tile))
    x_rows = comefa_sim._gemv_batched_layout(plan)
    mats = [comefa_sim._gemv_batched_chunk_program(plan, tile, x_rows,
                                                   True)[1]
            for tile in plan.tiles()[:2]]
    return plan.n_blocks, mats


@pytest.mark.parametrize("k,n", [(960, 320), (64, 160)])
@pytest.mark.parametrize("chain", [False, True])
def test_decoded_program_on_main_path_chunk_programs(k, n, chain):
    nb, mats = _chunk_programs(k, n)
    rng = np.random.default_rng(k + n + chain)
    _assert_decoded_equals_plain(_state(rng, 2, nb), torch.tensor(mats[0]),
                                 chain, False)
    t = min(len(m) for m in mats)
    stack = torch.as_tensor(np.stack([m[:t] for m in mats]))
    _assert_decoded_equals_plain(_state(rng, 2, nb), stack, chain, True)


@pytest.mark.parametrize("chain", [False, True])
def test_decoded_program_matches_jax_packed_engine(chain):
    rng = np.random.default_rng(5 + chain)
    mat = _fields(rng, 16, isa.N_ROWS - 2)
    bits = _state(rng, 3, 2)
    want = JaxGrid(3, n_blocks=2, chain=chain, engine="packed-xla")
    want.mem, want.carry, want.mask = (b.copy() for b in bits)
    want.run(mat)
    state = [engine_packed.pack_bits(v) for v in bits]
    cs.run_decoded_plain(*state, cs.decode(torch.as_tensor(mat)),
                         chain=chain, per_slot=False)
    for got, ref in zip(state, (want.mem, want.carry, want.mask)):
        np.testing.assert_array_equal(
            engine_packed.unpack_bits(got).numpy(), np.asarray(ref))


def test_decode_words_fold_every_select():
    names = isa.ENGINE_FIELD_NAMES
    row = dict.fromkeys(names, 0)
    row.update(src1_row=3, src2_row=127, dst_row=5, dst2_row=5,
               truth_table=0b1010, pred_sel=isa.PRED_CARRY,
               w1_sel=isa.W1_RIGHT, wp1_en=1, c_rst=1, b_ext=1, ext_bit=1,
               pred2_sel=isa.PRED_MASK, w2_sel=isa.W2_LEFT, wp2_en=0)
    words = cs.decode(torch.tensor([[row[k] for k in names]])).tolist()[0]
    assert len(words) == cs.DECODED_WORDS == 24
    # rows as byte offsets into a lane's column; bit 0: port 1 writes a
    # right-shifted value
    assert words[0] == 3 * 128 | (127 * 128) << 16 | 1
    assert words[1] == 5 * 128 | (5 * 128) << 16
    assert words[2] == -1          # dst2 == dst
    x = dict(zip(cs.MASKS, words[3:]))
    assert [x[f"tt{i}"] for i in range(4)] == [0, -1, 0, -1]
    assert (x["keep_b"], x["ext_and"], x["crst_keep"]) == (0, -1, 0)
    assert (x["p1a"], x["p1m"], x["p1c"], x["p1n"]) == (0, 0, -1, 0)
    # wp2 is off: port 2's enables fold to 0, whatever its selects say
    assert (x["p2a"], x["p2m"], x["p2c"], x["p2n"]) == (0, 0, 0, 0)
    assert (x["v1s"], x["v1r"], x["v2c"], x["v2l"]) == (0, -1, 0, -1)
    zero = cs.decode(torch.zeros((1, len(names)), dtype=torch.int32))
    assert zero.tolist()[0][0] & 1 == 0      # a no-op moves no seam


def test_decoded_cache_frozen_once_writable_afresh():
    rng = np.random.default_rng(9)
    frozen = _fields(rng, 12)
    frozen.setflags(write=False)
    stats = block.ENCODE_CACHE_STATS
    hits, misses = stats["device_hits"], stats["device_misses"]
    first = cs.decoded(frozen, "cpu")
    assert cs.decoded(frozen, "cpu") is first
    assert (stats["device_hits"], stats["device_misses"]) == (hits + 1,
                                                              misses + 1)
    assert torch.equal(first, cs.decode(torch.tensor(frozen)))
    writable = frozen.copy()
    a, b = cs.decoded(writable, "cpu"), cs.decoded(writable, "cpu")
    assert a is not b and torch.equal(a, b)
    writable[0, 0] = (writable[0, 0] + 1) % isa.N_ROWS
    assert not torch.equal(cs.decoded(writable, "cpu"), a)


def test_run_packed_takes_a_decoded_program_on_cpu():
    rng = np.random.default_rng(12)
    bits = _state(rng, 2, 3)
    prog = torch.as_tensor(_fields(rng, 30))
    state = [engine_packed.pack_bits(v) for v in bits]
    before = cs.launches
    got = cs.run_packed(*[v.clone() for v in state], cs.decode(prog),
                        chain=True, per_slot=False)
    want = cs.run_packed_plain(*[v.clone() for v in state], prog,
                               chain=True, per_slot=False)
    assert cs.launches == before
    assert all(torch.equal(u, v) for u, v in zip(got, want))
    with pytest.raises(ValueError, match="field matrix"):
        cs.run_packed_plain(*state, cs.decode(prog), chain=True,
                            per_slot=False)
    with pytest.raises(ValueError, match="decoded program"):
        cs.run_decoded_plain(*state, prog, chain=True, per_slot=False)


# ---------------------------------------------------------------------------
# the kernel's launch limits, checked before a launch
# ---------------------------------------------------------------------------

def test_launch_limit_names_the_chain_limit():
    """A chained slot of 625 blocks is refused with a message that names
    the limit; 624 (a cluster of 8 CTAs x 78 blocks) and any unchained nb
    pass."""
    assert cs.MAX_CHAIN_BLOCKS == 624
    cs.check_launch(4, 624, True)
    cs.check_launch(4, 625, False)
    with pytest.raises(ValueError, match="a chained slot holds at most 624 "
                                         "blocks on the cuda engine"):
        cs.check_launch(1, 625, True)
    with pytest.raises(ValueError, match="at most 2147483647 slots"):
        cs.check_launch(2 ** 31, 1, False)
    cs.check_launch(65536, 1, False)


@pytest.mark.parametrize("nb,chain,ctas", [
    (1, False, 1), (7, False, 2), (1, True, 1), (78, True, 1),
    (79, True, 2), (156, True, 2), (157, True, 4), (160, True, 4),
    (624, True, 8)])
def test_ctas_per_slot(nb, chain, ctas):
    """Unchained, one CTA a warp of six blocks; chained, one CTA up to 13
    warps, else a cluster of 2, 4 or 8 CTAs of at most 13 warps each."""
    assert cs.ctas_per_slot(nb, chain) == ctas
    if chain and ctas > 1:
        assert -(-nb // cs.BLOCKS_PER_WARP) <= ctas * cs.MAX_WARPS


def test_packed_engine_runs_a_625_block_chain_on_the_cpu():
    """The limit is the card's: the packed engine on the CPU runs a chained
    625-block grid, equal to the uint8 reference engine."""
    rng = np.random.default_rng(625)
    nb = cs.MAX_CHAIN_BLOCKS + 1
    mem = rng.integers(0, 2, (1, nb, isa.N_ROWS, isa.N_COLS), dtype=np.uint8)
    carry = rng.integers(0, 2, (1, nb, isa.N_COLS), dtype=np.uint8)
    mask = rng.integers(0, 2, (1, nb, isa.N_COLS), dtype=np.uint8)
    prog = _fields(rng, 6, rows=8)
    prog[:, isa.ENGINE_FIELD_NAMES.index("w1_sel")] = 2     # every step shifts
    grids = []
    for eng in ("packed", "reference"):
        g = ComefaGrid(1, n_blocks=nb, chain=True, engine=eng, device="cpu")
        g.mem, g.carry, g.mask = mem.copy(), carry.copy(), mask.copy()
        g.run(prog)
        grids.append(g)
    np.testing.assert_array_equal(grids[0].mem, grids[1].mem)
    np.testing.assert_array_equal(grids[0].carry, grids[1].carry)
    np.testing.assert_array_equal(grids[0].mask, grids[1].mask)
    assert grids[0].cycles == grids[1].cycles
