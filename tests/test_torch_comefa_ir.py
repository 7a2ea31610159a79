"""The port's CoMeFa ISA, IR, planner and recode selector held to the JAX
package's, on the same inputs.

Programs reach either package's engines as int32 ``[T, 16]`` field
matrices, so the port's `block.encoded` must give the JAX package's
matrices byte for byte: for every shipped generator (the verifier's
catalog), optimized, and for the batched GEMV's chunk programs.  The
planner's geometry and cycle quotes and `recode.select_wave`'s choices are
integers and must be equal.
"""
import dataclasses

import numpy as np
import pytest

from repro.core.comefa import block as jax_block
from repro.core.comefa import recode as jax_recode
from repro.core.comefa import schedule as jax_schedule
from repro.core.comefa import verify as jax_verify
from repro.kernels import comefa_sim as jax_sim
from repro.serve.comefa_exec import acc_bits_for as jax_acc_bits
from repro_torch.core.comefa import block, isa, recode, schedule, verify
from repro_torch.kernels import comefa_sim
from repro_torch.serve.comefa_exec import acc_bits_for

# SmolLM-360M's packed projections (K, N): wq/wo, wk/wv, wi/wg, ffn wo
SMOLLM_SHAPES = [(960, 960), (960, 320), (960, 2560), (2560, 960)]


def _catalog(verify_mod):
    return {name: (prog, ctx) for name, prog, _, ctx
            in verify_mod._generator_catalog()}


def test_isa_constants_and_field_order_equal():
    from repro.core.comefa import isa as jax_isa
    assert isa.ENGINE_FIELD_NAMES == jax_isa.ENGINE_FIELD_NAMES
    assert isa.FIELDS == jax_isa.FIELDS
    assert (isa.N_ROWS, isa.N_COLS, isa.RESERVED_ROWS, isa.USABLE_ROWS) == \
        (jax_isa.N_ROWS, jax_isa.N_COLS, jax_isa.RESERVED_ROWS,
         jax_isa.USABLE_ROWS)
    rng = np.random.default_rng(0)
    for _ in range(50):
        word = int(rng.integers(0, 1 << 38))
        assert isa.Instr.decode(word).engine_vector() == \
            jax_isa.Instr.decode(word).engine_vector()


@pytest.mark.parametrize("optimized", [False, True])
def test_generator_programs_encode_byte_for_byte(optimized):
    ours, theirs = _catalog(verify), _catalog(jax_verify)
    assert sorted(ours) == sorted(theirs) and len(ours) >= 25
    for name in ours:
        p, q = ours[name][0], theirs[name][0]
        if optimized:
            p, q = p.optimize(), q.optimize()
        a, b = block.encoded(p), jax_block.encoded(q)
        assert a.dtype == b.dtype == np.int32, name
        assert a.tobytes() == b.tobytes(), name
        assert p.cycles == q.cycles, name


@pytest.mark.parametrize("k,n", SMOLLM_SHAPES)
def test_plans_and_broadcast_quotes_equal_at_smollm_shapes(k, n):
    w_bits = x_bits = 8
    acc = acc_bits_for(w_bits, x_bits, k)
    assert acc == jax_acc_bits(w_bits, x_bits, k)
    for kw in (dict(reserve_neg=True),
               dict(k_tile=min(k, comefa_sim.gemv_batched_k_tile(
                   w_bits, x_bits, acc)))):
        ours = schedule.cached_plan_gemv(k, n, w_bits, x_bits, acc, **kw)
        theirs = jax_schedule.cached_plan_gemv(k, n, w_bits, x_bits, acc,
                                               **kw)
        assert dataclasses.astuple(ours) == dataclasses.astuple(theirs)
    q = comefa_sim._broadcast_quote(k, n, w_bits, x_bits, acc, True)
    jq = jax_sim._broadcast_quote(k, n, w_bits, x_bits, acc, True)
    assert q.compute_cycles == jq.compute_cycles
    assert q.total_cycles == jq.total_cycles
    # the chunk programs the grid dispatches: equal matrices, 752-830
    # instructions each (the issue's sizing), k_tile 4
    assert q.plan.k_tile == 4
    x_rows = comefa_sim._gemv_batched_layout(q.plan)
    jx_rows = jax_sim._gemv_batched_layout(jq.plan)
    assert [tuple(r) for r in x_rows] == [tuple(r) for r in jx_rows]
    for tile in q.plan.tiles()[:2] + q.plan.tiles()[-1:]:
        prog, a = comefa_sim._gemv_batched_chunk_program(q.plan, tile,
                                                         x_rows, True)
        assert a.tobytes() == block.encoded(prog).tobytes()
        b = jax_block.encoded(jax_sim._gemv_batched_chunk_program(
            jq.plan, tile, jx_rows, True))
        assert a.tobytes() == b.tobytes()
        assert 752 <= a.shape[0] <= 830


def test_layer_wave_quote_is_the_planner_sum():
    """One SmolLM-360M layer-wave: 2,080 chunks, 1,605,212 cycles."""
    per_layer = {(960, 960): 2, (960, 320): 2, (960, 2560): 2,
                 (2560, 960): 1}
    cycles = chunks = 0
    for (k, n), c in per_layer.items():
        q = comefa_sim._broadcast_quote(k, n, 8, 8, acc_bits_for(8, 8, k),
                                        True)
        cycles += c * sum(q.compute_cycles)
        chunks += c * len(q.compute_cycles)
    assert (chunks, cycles) == (2080, 1605212)


@pytest.mark.parametrize("seed", range(4))
def test_select_wave_choices_equal(seed):
    rng = np.random.default_rng(seed)
    k, n, w_bits, x_bits = 40, 70, 4, 4
    acc = acc_bits_for(w_bits, x_bits, k)
    x = rng.integers(0, 1 << x_bits, size=(3, k))
    if seed % 2:
        x[:, ::3] = 1 << (x_bits - 1)          # the offset zero point
    plan = schedule.cached_plan_gemv(k, n, w_bits, x_bits, acc,
                                     reserve_neg=True)
    jplan = jax_schedule.cached_plan_gemv(k, n, w_bits, x_bits, acc,
                                          reserve_neg=True)
    sel = recode.select_wave(plan, x, broadcast=comefa_sim._broadcast_quote(
        k, n, w_bits, x_bits, acc, True))
    jsel = jax_recode.select_wave(jplan, x, broadcast=jax_sim._broadcast_quote(
        k, n, w_bits, x_bits, acc, True))
    assert (sel.mode, sel.per_slot_cycles, sel.broadcast_cycles) == \
        (jsel.mode, jsel.per_slot_cycles, jsel.broadcast_cycles)
    assert [[dataclasses.astuple(c) for c in row] for row in sel.choices] == \
        [[dataclasses.astuple(c) for c in row] for row in jsel.choices]


@pytest.mark.parametrize("recode_name", ["naive", "booth", "naf", "auto"])
def test_specialized_tile_programs_encode_byte_for_byte(recode_name):
    k, n, w_bits, x_bits = 24, 40, 4, 4
    acc = acc_bits_for(w_bits, x_bits, k)
    plan = schedule.cached_plan_gemv(k, n, w_bits, x_bits, acc,
                                     reserve_neg=True)
    jplan = jax_schedule.cached_plan_gemv(k, n, w_bits, x_bits, acc,
                                          reserve_neg=True)
    x = np.random.default_rng(5).integers(0, 1 << x_bits, size=k)
    for tile in plan.tiles():
        chunk = x[tile.k_start:tile.k_end]
        a = plan.tile_program(tile, chunk, recode=recode_name)
        b = jplan.tile_program(tile, chunk, recode=recode_name)
        assert block.encoded(a).tobytes() == jax_block.encoded(b).tobytes()


def test_verify_hook_reads_the_port_env_var(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_COMEFA_VERIFY", raising=False)
    monkeypatch.setenv("REPRO_COMEFA_VERIFY", "1")
    assert not verify.verify_enabled()
    monkeypatch.setenv("REPRO_TORCH_COMEFA_VERIFY", "1")
    assert verify.verify_enabled()
    bad = isa.Instr(dst_row=isa.ROW_ONES, wp1_en=1)
    from repro_torch.core.comefa import ir
    prog = ir.Program([bad], name="writes_reserved_row")
    with pytest.raises(Exception, match="reserved|ROW|row"):
        block.encoded(prog)
