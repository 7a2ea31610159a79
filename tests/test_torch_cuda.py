"""The port on a CUDA GPU: the bit-plane kernel against its plain version
(both paths, both dtypes, the split-K cluster), a reduced model on the
card against the CPU, the CoMeFa step kernel against its plain version
and the uint8 reference engine (its warp segments at nb 1-17, chained
slots on clusters up to 624 blocks, 65,536 slots, its decoded-program
cache), the six array kernels of `comefa_sim` (GEMMs on 79- and
128-block chains and a 12,800-tap FIR, so clusters run real programs),
and the bit-serial and
bulk-bitwise kernels (bit transpose and untranspose, search-replace, RAID
XOR, bit-serial reduce and matmul) against their plain versions, bit for
bit, with the bit-serial matmul's binary-MMA tiling swept over ragged
shapes and held to one launch and no scratch a call.

Every test here needs the card: it carries the `cuda` marker and skips
where `torch.cuda.is_available()` is False.  The file imports no JAX, so
it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Float results are held to the f32 bound for two orders of one sum,
|d| <= (K + 2) * 2^-23 * (|x| @ |w|); integer inputs with scale 1 are
exact in any order.  The step kernel's state is bits: it must be
bit-identical.
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core.comefa import ComefaGrid, engine_packed, isa
from repro_torch.kernels import bit_transpose as bt
from repro_torch.kernels import bitplane_matmul as bpm
from repro_torch.kernels import bitserial_matmul as bsm
from repro_torch.kernels import bitserial_reduce as bsr
from repro_torch.kernels import bulk_bitwise as bb
from repro_torch.kernels import comefa_sim, ops
from repro_torch.kernels import comefa_step as cs
from repro_torch.models import common as cm
from repro_torch.models import lm
from repro_torch.quant import bitplane as bp
from repro_torch.serve import comefa_exec, engine

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py runs these checks "
                    "on the GPU)")
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 plain products
    return torch.device("cuda")


def _operands(seed, bits, m, k, n, dev, integer=False):
    rng = np.random.default_rng(seed)
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    q = rng.integers(lo, hi + 1, size=(k, n)).astype(np.int32)
    if integer:
        x = rng.integers(-8, 8, size=(m, k)).astype(np.float32)
        scale = np.ones((1, n), np.float32)
    else:
        x = rng.normal(size=(m, k)).astype(np.float32)
        scale = rng.uniform(0.01, 0.1, size=(1, n)).astype(np.float32)
    planes = bp.pack(torch.as_tensor(q), bits).to(dev)
    return (torch.as_tensor(x, device=dev), planes,
            torch.as_tensor(scale, device=dev), q)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("m,k,n", [(4, 960, 320), (4, 2560, 960),
                                   (3, 64, 100), (19, 96, 70)])
def test_kernel_matches_plain(cuda, bits, m, k, n):
    x, planes, scale, q = _operands(m + k + n, bits, m, k, n, cuda)
    before = bpm.launches
    y = bpm.bitplane_matmul(x, planes, scale, bits=bits)
    torch.cuda.synchronize()
    assert bpm.launches == before + 1
    y_plain = bpm.bitplane_matmul_plain(x, planes, scale, bits=bits)
    bound = (k + 2) * 2.0 ** -23 * (
        np.abs(x.cpu().numpy()).astype(np.float64)
        @ (np.abs(q) * scale.cpu().numpy()))
    assert np.all((y - y_plain).abs().cpu().numpy() <= bound)


@pytest.mark.parametrize("bits", [1, 2, 8])
def test_kernel_exact_on_integers(cuda, bits):
    x, planes, ones, q = _operands(bits, bits, 11, 320, 130, cuda,
                                   integer=True)
    y = bpm.bitplane_matmul(x, planes, ones, bits=bits)
    np.testing.assert_array_equal(y.cpu().numpy(),
                                  x.cpu().numpy() @ q.astype(np.float32))


SMOLLM_SHAPES = [(960, 960), (960, 320), (960, 2560), (2560, 960)]


def _bf16_ulp(y):
    """One bf16 ulp of each |y| (f32 tensor): the gap of the final
    rounding when two f32 sums within the f32 bound straddle a tie."""
    e = torch.floor(torch.log2(y.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


@pytest.mark.parametrize("bits", [1, 4, 8])
@pytest.mark.parametrize("m", [1, 4, 8, 9, 32])
@pytest.mark.parametrize("k,n", SMOLLM_SHAPES)
def test_kernel_dtypes_and_paths_at_smollm_shapes(cuda, k, n, m, bits):
    """Both paths (CUDA cores for M <= 8, tensor cores above), f32 and bf16
    x, f32 and bf16 y, K split over a cluster: exact on integers, within
    the f32 bound on floats (plus one bf16 ulp for a bf16 y), and a bf16 y
    is the f32 y rounded once, bit for bit."""
    for integer in (True, False):
        x, planes, scale, q = _operands(k * m + n + bits, bits, m, k, n,
                                        cuda, integer=integer)
        mag = x.abs().double().cpu() @ (torch.as_tensor(q).abs().double()
                                        * scale.double().cpu())
        bound = (k + 2) * 2.0 ** -23 * mag
        for xd in (torch.float32, torch.bfloat16):
            xx = x.to(xd)
            for od in (torch.float32, torch.bfloat16):
                got = bpm.bitplane_matmul(xx, planes, scale, bits=bits,
                                          out_dtype=od)
                want = bpm.bitplane_matmul_plain(xx, planes, scale,
                                                 bits=bits, out_dtype=od)
                assert got.dtype == od
                if od == torch.bfloat16:
                    y32 = bpm.bitplane_matmul(xx, planes, scale, bits=bits)
                    assert torch.equal(got, y32.to(od)), xd
                if integer:
                    assert torch.equal(got, want), (xd, od)
                    continue
                d = (got.double() - want.double()).abs().cpu()
                tol = bound if od == torch.float32 else \
                    bound + _bf16_ulp(want.float()).double().cpu()
                assert bool((d <= tol).all()), (xd, od, float(d.max()))


def test_kernel_runs_repeat_bit_for_bit(cuda):
    for m in (4, 32):
        x, planes, scale, _ = _operands(m, 8, m, 2560, 960, cuda)
        first = bpm.bitplane_matmul(x, planes, scale, bits=8)
        for _ in range(3):
            assert torch.equal(bpm.bitplane_matmul(x, planes, scale, bits=8),
                               first)


def test_ops_bf16_is_cast_kernel_cast_on_card(cuda):
    """One launch on a bf16 x and a bf16 y gives the bits of casting x to
    f32, running the f32 kernel and casting y back."""
    for m in (4, 32):
        x, planes, scale, _ = _operands(m + 1, 8, m, 960, 320, cuda)
        xb = x.to(torch.bfloat16)
        before = bpm.launches
        y = ops.bitplane_matmul(xb, planes, scale, bits=8,
                                out_dtype=torch.bfloat16)
        assert bpm.launches == before + 1
        via = bpm.bitplane_matmul(xb.float(), planes, scale,
                                  bits=8).to(torch.bfloat16)
        assert torch.equal(y, via)


def test_kernel_rejects_bad_operands(cuda):
    x, planes, scale, _ = _operands(0, 4, 2, 64, 8, cuda)
    with pytest.raises(ValueError, match="different devices"):
        bpm.bitplane_matmul(x, planes.cpu(), scale, bits=4)
    with pytest.raises(ValueError, match="contiguous"):
        bpm.bitplane_matmul(torch.zeros((64, 2), device=cuda).T, planes,
                            scale, bits=4)


def test_reduced_model_on_card_matches_cpu(cuda):
    cfg = cm.reduced(configs.get("smollm-360m"), n_layers=2, quant_bits=8)
    cpu_model = lm.init(torch.Generator().manual_seed(0), cfg, "cpu")
    gpu_model = copy.deepcopy(cpu_model).to(cuda)
    prompt = torch.as_tensor(
        np.random.default_rng(1).integers(0, cfg.vocab, (3, 5)))
    before = bpm.launches
    got = engine.generate(gpu_model, prompt.to(cuda), steps=4, max_len=10)
    assert bpm.launches - before == 7 * cfg.n_layers * (5 + 4)
    want = engine.generate(cpu_model, prompt, steps=4, max_len=10)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    logits = lm.forward(gpu_model, prompt.to(cuda)).cpu()
    np.testing.assert_allclose(logits.numpy(),
                               lm.forward(cpu_model, prompt).numpy(),
                               rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# the CoMeFa step kernel
# ---------------------------------------------------------------------------

def _random_fields(rng, t):
    """Random engine field rows [t, 16]: every select and latch control,
    co-issued port-2 writes (dst2 != dst) included."""
    n = isa.N_ROWS
    cols = dict(
        src1_row=rng.integers(0, n, t), src2_row=rng.integers(0, n, t),
        dst_row=rng.integers(0, n - 2, t), truth_table=rng.integers(0, 16, t),
        pred_sel=rng.integers(0, 4, t), w1_sel=rng.integers(0, 3, t),
        w2_sel=rng.integers(0, 4, t), wp1_en=rng.integers(0, 2, t),
        wp2_en=rng.integers(0, 2, t), c_en=rng.integers(0, 2, t),
        c_rst=rng.integers(0, 2, t), m_en=rng.integers(0, 2, t),
        ext_bit=rng.integers(0, 2, t), b_ext=rng.integers(0, 2, t),
        dst2_row=rng.integers(0, n - 2, t), pred2_sel=rng.integers(0, 4, t))
    return np.stack([cols[f] for f in isa.ENGINE_FIELD_NAMES],
                    axis=1).astype(np.int32)


def _grids(rng, s, nb, chain, cuda):
    mem = rng.integers(0, 2, (s, nb, isa.N_ROWS, isa.N_COLS), dtype=np.uint8)
    mem[:, :, isa.ROW_ZEROS] = 0
    mem[:, :, isa.ROW_ONES] = 1
    carry = rng.integers(0, 2, (s, nb, isa.N_COLS), dtype=np.uint8)
    mask = rng.integers(0, 2, (s, nb, isa.N_COLS), dtype=np.uint8)
    out = []
    for eng in ("cuda", "packed", "reference"):
        g = ComefaGrid(s, n_blocks=nb, chain=chain, engine=eng, device=cuda)
        g.mem, g.carry, g.mask = mem.copy(), carry.copy(), mask.copy()
        out.append(g)
    return out


def _assert_grids_equal(grids):
    for g in grids[1:]:
        np.testing.assert_array_equal(g.mem, grids[0].mem)
        np.testing.assert_array_equal(g.carry, grids[0].carry)
        np.testing.assert_array_equal(g.mask, grids[0].mask)
        assert g.cycles == grids[0].cycles


@pytest.mark.parametrize("nb", [1, 2, 16])
@pytest.mark.parametrize("chain", [False, True])
@pytest.mark.parametrize("layout", ["shared", "per_slot"])
def test_step_kernel_matches_plain_and_reference(cuda, nb, chain, layout):
    rng = np.random.default_rng(nb * 4 + 2 * chain + (layout == "shared"))
    grids = _grids(rng, 4, nb, chain, cuda)
    before = cs.launches
    if layout == "shared":
        prog = _random_fields(rng, 300)          # more than one 256-tile
        for g in grids:
            g.run(prog)
    else:
        progs = [_random_fields(rng, int(rng.integers(20, 60)))
                 for _ in range(4)]
        for g in grids:
            g.run_per_slot(progs)
    assert cs.launches == before + 1
    _assert_grids_equal(grids)


@pytest.mark.parametrize("reset", [False, True])
def test_step_kernel_run_programs_latch_boundaries(cuda, reset):
    rng = np.random.default_rng(3 + reset)
    grids = _grids(rng, 3, 2, True, cuda)
    progs = [_random_fields(rng, 16) for _ in range(3)]
    counts = {tuple(g.run_programs(progs, reset_latches=reset))
              for g in grids}
    assert len(counts) == 1
    _assert_grids_equal(grids)


@pytest.mark.parametrize("k,n", [(960, 320), (960, 2560), (2560, 960)])
def test_step_kernel_on_main_path_chunk_programs(cuda, k, n):
    from repro_torch.core.comefa import schedule
    acc = comefa_exec.acc_bits_for(8, 8, k)
    plan = schedule.cached_plan_gemv(
        k, n, 8, 8, acc, k_tile=comefa_sim.gemv_batched_k_tile(8, 8, acc))
    x_rows = comefa_sim._gemv_batched_layout(plan)
    _, mat = comefa_sim._gemv_batched_chunk_program(plan, plan.tiles()[1],
                                                    x_rows, True)
    rng = np.random.default_rng(k + n)
    state = [engine_packed.pack_bits(
        rng.integers(0, 2, shape, dtype=np.uint8)).to(cuda)
        for shape in ((4, plan.n_blocks, isa.N_ROWS, isa.N_COLS),
                      (4, plan.n_blocks, isa.N_COLS),
                      (4, plan.n_blocks, isa.N_COLS))]
    prog = torch.tensor(mat, device=cuda)
    got = cs.run_packed(*[v.clone() for v in state], prog, chain=False,
                        per_slot=False)
    want = cs.run_packed_plain(*[v.clone() for v in state], prog,
                               chain=False, per_slot=False)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("nb", [1, 2, 6, 7, 16, 17])
@pytest.mark.parametrize("chain", [False, True])
@pytest.mark.parametrize("layout", ["shared", "per_slot", "reset",
                                    "threaded"])
def test_step_kernel_warp_segments(cuda, nb, chain, layout):
    """Six blocks a warp: nb 1, 6 and 16 end a warp exactly or early, 7 and
    17 spill one block into a further warp (a second CTA unchained, a
    cross-warp seam chained); rows drawn from eight so that nearly every
    instruction reads a row its predecessor wrote; 150 instructions cross
    two program tiles."""
    rng = np.random.default_rng(1000 + 10 * nb + 2 * chain + len(layout))
    grids = _grids(rng, 3, nb, chain, cuda)

    def prog(t):
        f = _random_fields(rng, t)
        for c in (0, 1, 2, 14):                 # src1 src2 dst dst2
            f[:, c] = rng.integers(0, 8, t)
        return f

    before = cs.launches
    if layout == "shared":
        p = prog(150)
        for g in grids:
            g.run(p)
    elif layout == "per_slot":
        ps = [prog(int(rng.integers(20, 150))) for _ in range(3)]
        for g in grids:
            g.run_per_slot(ps)
    else:
        ps = [prog(40) for _ in range(3)]
        counts = {tuple(g.run_programs(ps, reset_latches=layout == "reset"))
                  for g in grids}
        assert len(counts) == 1
    assert cs.launches > before
    _assert_grids_equal(grids)


@pytest.mark.parametrize("nb", [78, 79, 160, 624])
@pytest.mark.parametrize("layout", ["shared", "per_slot"])
def test_step_kernel_long_chains(cuda, nb, layout):
    """Chained slots past one CTA: 78 blocks fill one CTA, 79 and 160 take
    a cluster of 2 and 4, 624 the full cluster of 8; about half the
    instructions write the right neighbour's S, so seams cross CTAs."""
    rng = np.random.default_rng(5000 + nb + len(layout))
    grids = _grids(rng, 2, nb, True, cuda)

    def prog(t):
        f = _random_fields(rng, t)
        f[:, isa.ENGINE_FIELD_NAMES.index("w1_sel")] = \
            2 * rng.integers(0, 2, t)
        return f

    before = cs.launches
    if layout == "shared":
        p = prog(70)
        for g in grids:
            g.run(p)
    else:
        ps = [prog(int(rng.integers(20, 70))) for _ in range(2)]
        for g in grids:
            g.run_per_slot(ps)
    assert cs.launches == before + 1
    _assert_grids_equal(grids)


def test_step_kernel_refuses_chains_past_624_before_launch(cuda):
    mem = torch.zeros((1, 625, isa.N_ROWS, engine_packed.N_WORDS),
                      dtype=torch.int32, device=cuda)
    latch = torch.zeros((1, 625, engine_packed.N_WORDS), dtype=torch.int32,
                        device=cuda)
    prog = torch.tensor(_random_fields(np.random.default_rng(0), 4),
                        device=cuda)
    before = cs.launches
    with pytest.raises(ValueError, match="at most 624 blocks"):
        cs.run_packed(mem, latch, latch.clone(), prog, chain=True,
                      per_slot=False)
    assert cs.launches == before


def test_step_kernel_more_than_65535_slots(cuda):
    """65,536 unchained slots of one block, a short program: slots sit on
    (gridDim.y, gridDim.z), 65,535 to a layer, where the old launch put
    them on gridDim.y alone and stopped at 65,535."""
    s = 65536
    gen = torch.Generator(device=cuda).manual_seed(3)
    state = [torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                           device=cuda, dtype=torch.int32)
             for shape in ((s, 1, isa.N_ROWS, engine_packed.N_WORDS),
                           (s, 1, engine_packed.N_WORDS),
                           (s, 1, engine_packed.N_WORDS))]
    prog = torch.tensor(_random_fields(np.random.default_rng(4), 12),
                        device=cuda)
    before = cs.launches
    got = cs.run_packed(*[v.clone() for v in state], prog, chain=False,
                        per_slot=False)
    assert cs.launches == before + 1
    want = cs.run_packed_plain(*[v.clone() for v in state], prog,
                               chain=False, per_slot=False)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_cuda_engine_decodes_a_frozen_program_once(cuda):
    rng = np.random.default_rng(31)
    mat = _random_fields(rng, 40)
    mat.setflags(write=False)
    g = ComefaGrid(2, n_blocks=3, engine="cuda", device=cuda)
    g.run(mat)
    first = cs.decoded(mat, cuda)
    g.run(mat)
    assert cs.decoded(mat, cuda) is first and first.device.type == "cuda"
    assert torch.equal(first.cpu(), cs.decode(torch.tensor(mat)))


def test_grid_executor_on_card_matches_reference(cuda):
    """A full-width projection (960 -> 320) on the grid, cuda engine."""
    rng = np.random.default_rng(0)
    q = rng.integers(-128, 128, size=(960, 320)).astype(np.int32)
    params = {"packed": bp.pack(torch.as_tensor(q), 8).to(cuda),
              "scale": torch.full((1, 320), 0.01, device=cuda)}
    x2 = torch.as_tensor(rng.normal(size=(3, 960)).astype(np.float32),
                         device=cuda)
    before = cs.launches
    grid = comefa_exec.GridLinearExecutor(slots=4, recode=None)
    y = grid(params, x2, 8)
    assert cs.launches - before == 240           # 960 / k_tile 4 chunks
    ref = comefa_exec.GridLinearExecutor(slots=4, backend="reference")
    assert torch.equal(y, ref(params, x2, 8))


def test_cuda_engine_is_the_default_on_the_card(cuda):
    assert ComefaGrid(2, device=cuda).engine.name == "cuda"


# ---------------------------------------------------------------------------
# the paper's evaluation layer: comefa_sim's array kernels on the card
# ---------------------------------------------------------------------------

def _fir_ref(taps, x):
    return np.convolve(taps.astype(np.int64), x.astype(np.int64))[:len(x)]


def _launched(fn):
    """fn() and the step-kernel launches it made (at least one)."""
    before = cs.launches
    out = fn()
    torch.cuda.synchronize()
    assert cs.launches > before
    return out


@pytest.mark.parametrize("recode", ["naive", "booth", "naf", "auto"])
def test_comefa_sim_gemv_on_card(cuda, recode):
    rng = np.random.default_rng(21)
    w = rng.integers(0, 32, size=(40, 200))
    x = rng.integers(0, 32, size=40)
    got = _launched(lambda: comefa_sim.comefa_gemv(
        w, x, w_bits=5, x_bits=5, acc_bits=24, recode=recode, device=cuda))
    np.testing.assert_array_equal(got, (w * x[:, None]).sum(0))


def test_comefa_sim_eltwise_and_dot_on_card(cuda):
    rng = np.random.default_rng(5)
    a = rng.integers(0, 256, size=1000)
    b = rng.integers(0, 256, size=1000)
    got = _launched(lambda: comefa_sim.comefa_eltwise_mul(a, b, bits=8,
                                                          device=cuda))
    np.testing.assert_array_equal(got, a * b)
    for n, bits in ((150, 4), (640, 3)):        # 1 and 4 chained blocks
        a = rng.integers(0, 1 << bits, size=n)
        b = rng.integers(0, 1 << bits, size=n)
        assert _launched(lambda: comefa_sim.comefa_dot(
            a, b, bits=bits, device=cuda)) == int((a * b).sum())


@pytest.mark.parametrize("m,k,n,bits,n_blocks", [
    (4, 16, 7, 3, 1), (5, 40, 9, 2, 4),
    (4, 256, 3, 3, 79),          # 256-lane groups across block seams
    (3, 256, 5, 2, 128)])        # and on 2-CTA clusters
def test_comefa_sim_gemm_on_card(cuda, m, k, n, bits, n_blocks):
    rng = np.random.default_rng(m * k + n)
    a = rng.integers(0, 1 << bits, size=(m, k))
    b = rng.integers(0, 1 << bits, size=(k, n))
    got = _launched(lambda: comefa_sim.comefa_gemm(
        a, b, bits=bits, n_blocks=n_blocks, device=cuda))
    np.testing.assert_array_equal(got, a @ b)
    ga = np.stack([a, a[::-1]])
    gb = np.stack([b, b[:, ::-1]])
    got = _launched(lambda: comefa_sim.comefa_gemm_batched(
        ga, gb, bits=bits, n_blocks=n_blocks, device=cuda))
    np.testing.assert_array_equal(got, np.einsum("gmk,gkn->gmn", ga, gb))


@pytest.mark.parametrize("n_taps,recode", [
    (96, "naive"), (290, "booth"), (520, "naf"),
    (12_800, "naive")])          # 80 chained blocks: 2-CTA clusters
def test_comefa_sim_fir_on_card(cuda, n_taps, recode):
    rng = np.random.default_rng(n_taps)
    taps = rng.integers(0, 16, size=n_taps)
    x = rng.integers(0, 16, size=5)
    got = _launched(lambda: comefa_sim.comefa_fir(
        taps, x, tap_bits=4, x_bits=4, recode=recode, device=cuda))
    np.testing.assert_array_equal(got, _fir_ref(taps, x))


# ---------------------------------------------------------------------------
# the bit-serial and bulk-bitwise kernels
# ---------------------------------------------------------------------------

def _signed(rng, bits, n, dev):
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    return torch.as_tensor(rng.integers(lo, hi + 1, size=n).astype(np.int32),
                           device=dev)


@pytest.mark.parametrize("w", [17, 8192])
@pytest.mark.parametrize("bits", [1, 8, 16, 32])
def test_bit_transpose_kernels_match_plain(cuda, w, bits):
    x = _signed(np.random.default_rng(w + bits), bits, 32 * w, cuda)
    before = dict(bt.launches)
    planes = bt.bit_transpose(x, bits=bits)
    assert torch.equal(planes, bt.bit_transpose_plain(x, bits=bits))
    for signed in (True, False):
        assert torch.equal(
            bt.bit_untranspose(planes, bits=bits, signed=signed),
            bt.bit_untranspose_plain(planes, bits=bits, signed=signed))
    assert torch.equal(bt.bit_untranspose(planes, bits=bits), x)
    assert bt.launches["bit_transpose"] == before["bit_transpose"] + 1
    assert bt.launches["bit_untranspose"] == before["bit_untranspose"] + 3


@pytest.mark.parametrize("w", [300, 8192])
@pytest.mark.parametrize("bits", [1, 12, 32])
def test_search_replace_kernel_matches_plain(cuda, w, bits):
    rng = np.random.default_rng(w * bits)
    planes = torch.as_tensor(rng.integers(-2**31, 2**31, size=(bits, w))
                             .astype(np.int32), device=cuda)
    planes[:, :7] = 0                      # records equal to key 0
    before = bb.launches["search_replace"]
    for key in (0, int(rng.integers(0, 1 << min(bits, 31))), -1):
        got = bb.search_replace(planes, bits=bits, key=key)
        want = bb.search_replace_plain(planes, bits=bits, key=key)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert bb.launches["search_replace"] == before + 3


@pytest.mark.parametrize("d", [1, 5, 8])
@pytest.mark.parametrize("w", [300, 8192])
def test_raid_xor_kernel_matches_plain(cuda, d, w):
    stripes = torch.as_tensor(np.random.default_rng(d + w).integers(
        -2**31, 2**31, size=(d, w)).astype(np.int32), device=cuda)
    before = bb.launches["raid_xor"]
    assert torch.equal(bb.raid_xor(stripes), bb.raid_xor_plain(stripes))
    assert bb.launches["raid_xor"] == before + 1


@pytest.mark.parametrize("w", [17, 8192])
@pytest.mark.parametrize("bits", [1, 8, 16, 32])
def test_bitserial_reduce_kernel_matches_plain(cuda, w, bits):
    x = _signed(np.random.default_rng(3 * w + bits), bits, 32 * w, cuda)
    planes = bt.bit_transpose_plain(x, bits=bits)
    before = bsr.launches
    got = bsr.bitserial_reduce(planes, bits=bits)
    assert bsr.launches == before + 1
    assert torch.equal(got, bsr.bitserial_reduce_plain(planes, bits=bits))
    assert torch.equal(got, torch.sum(x, dtype=torch.int64)
                       .to(torch.float32))


@pytest.mark.parametrize("a_bits,w_bits", [(8, 8), (4, 4), (2, 8), (5, 1)])
@pytest.mark.parametrize("m,k,n", [(4, 960, 320), (4, 2560, 960),
                                   (8, 512, 128), (3, 64, 100)])
def test_bitserial_matmul_kernel_matches_plain(cuda, m, k, n, a_bits,
                                               w_bits):
    rng = np.random.default_rng(m + k + n + a_bits)
    qx = _signed(rng, a_bits, m * k, cuda).view(m, k)
    qw = _signed(rng, w_bits, k * n, cuda).view(k, n)
    xp = bp.pack(qx, a_bits, axis=1).movedim(0, 1).contiguous()
    wp = bp.pack(qw, w_bits, axis=0)
    sx = torch.as_tensor(rng.uniform(0.01, 0.1, (m, 1)).astype(np.float32),
                         device=cuda)
    sw = torch.as_tensor(rng.uniform(0.01, 0.1, (1, n)).astype(np.float32),
                         device=cuda)
    ones_m, ones_n = torch.ones((m, 1), device=cuda), torch.ones((1, n),
                                                                 device=cuda)
    before = bsm.launches
    y_int = bsm.bitserial_matmul(xp, wp, ones_m, ones_n, a_bits=a_bits,
                                 w_bits=w_bits)
    exact = (qx.long().cpu() @ qw.long().cpu()).to(torch.float32)
    assert torch.equal(y_int.cpu(), exact)
    y = bsm.bitserial_matmul(xp, wp, sx, sw, a_bits=a_bits, w_bits=w_bits)
    assert torch.equal(y, bsm.bitserial_matmul_plain(
        xp, wp, sx, sw, a_bits=a_bits, w_bits=w_bits))
    assert bsm.launches == before + 2


@pytest.mark.parametrize("a_bits,w_bits", [(a, w) for a in (1, 3, 8)
                                           for w in (1, 3, 8)])
@pytest.mark.parametrize("m", [1, 4, 5, 16, 17, 64])
def test_bitserial_matmul_mma_shapes(cuda, m, a_bits, w_bits):
    """The binary-MMA kernel at K in 32..2560 (one word, tails of 3 and 6
    words, whole k256 steps) and N in 1..2560, M*a and N*w ragged against
    its 16 x 8 tiles: exact on integers, equal to the plain version when
    scaled."""
    rng = np.random.default_rng(100 * m + 10 * a_bits + w_bits)
    for k in (32, 96, 256, 960, 2560):
        for n in (1, 8, 100, 320, 2560):
            qx = _signed(rng, a_bits, m * k, cuda).view(m, k)
            qw = _signed(rng, w_bits, k * n, cuda).view(k, n)
            xp = bp.pack(qx, a_bits, axis=1).movedim(0, 1).contiguous()
            wp = bp.pack(qw, w_bits, axis=0)
            y = bsm.bitserial_matmul(xp, wp, torch.ones((m, 1), device=cuda),
                                     torch.ones((1, n), device=cuda),
                                     a_bits=a_bits, w_bits=w_bits)
            exact = (qx.double() @ qw.double()).to(torch.float32)
            assert torch.equal(y, exact), (m, k, n)
            sx = torch.rand((m, 1), device=cuda) * 0.09 + 0.01
            sw = torch.rand((1, n), device=cuda) * 0.09 + 0.01
            y = bsm.bitserial_matmul(xp, wp, sx, sw, a_bits=a_bits,
                                     w_bits=w_bits)
            assert torch.equal(y, bsm.bitserial_matmul_plain(
                xp, wp, sx, sw, a_bits=a_bits, w_bits=w_bits)), (m, k, n)


def test_bitserial_matmul_one_launch_no_scratch(cuda):
    """One kernel on the device a call - no memset, no second pass - and
    one allocation, the output."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(7)
    m, k, n = 4, 960, 320
    xp = bp.pack(_signed(rng, 8, m * k, cuda).view(m, k), 8,
                 axis=1).movedim(0, 1).contiguous()
    wp = bp.pack(_signed(rng, 8, k * n, cuda).view(k, n), 8, axis=0)
    sx, sw = torch.ones((m, 1), device=cuda), torch.ones((1, n), device=cuda)
    bsm.bitserial_matmul(xp, wp, sx, sw, a_bits=8, w_bits=8)    # warm up
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
    before = bsm.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        bsm.bitserial_matmul(xp, wp, sx, sw, a_bits=8, w_bits=8)
        torch.cuda.synchronize()
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == \
        allocs + 1
    assert bsm.launches == before + 1
    on_dev = [e for e in prof.events()
              if str(e.device_type).endswith("CUDA")]
    assert len(on_dev) == 1, [e.name for e in on_dev]
    assert "bitserial_matmul_kernel" in on_dev[0].name


def test_bitserial_equals_bitplane_on_integers_on_card(cuda):
    rng = np.random.default_rng(4)
    m, k, n, bits = 4, 960, 320, 8
    qx = torch.as_tensor(rng.integers(-128, 128, (m, k)).astype(np.int32),
                         device=cuda)
    qw = _signed(rng, bits, k * n, cuda).view(k, n)
    wp = bp.pack(qw, bits, axis=0)
    xp = ops.bit_transpose(qx.reshape(-1), bits=8).view(8, m, k // 32) \
        .transpose(0, 1).contiguous()
    y1 = ops.bitplane_matmul(qx.to(torch.float32), wp,
                             torch.ones((1, n), device=cuda), bits=bits)
    y2 = ops.bitserial_matmul(xp, wp, torch.ones((m, 1), device=cuda),
                              torch.ones((1, n), device=cuda), a_bits=8,
                              w_bits=bits)
    assert torch.equal(y1, y2)


def test_search_replace_round_trip_on_card(cuda):
    bits = 16
    recs = torch.as_tensor(np.random.default_rng(9).integers(
        0, 1 << 12, size=32 * 5000).astype(np.int32), device=cuda)
    key = int(recs[77])
    out, mask = ops.search_replace(ops.bit_transpose(recs, bits=bits),
                                   bits=bits, key=key)
    back = ops.bit_untranspose(out, bits=bits, signed=False)
    assert torch.equal(back, torch.where(recs == key, 0, recs))
    hits = ops.bit_untranspose(mask[None], bits=1, signed=False)
    assert torch.equal(hits.bool(), recs == key)


def test_new_kernels_raise_instead_of_falling_back(cuda):
    x = torch.zeros(48, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="multiple of 32"):
        bt.bit_transpose(x, bits=8)
    planes = torch.zeros((8, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        bb.raid_xor(planes.to(torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        bb.search_replace(torch.zeros((4, 8), dtype=torch.int32,
                                      device=cuda).T, bits=8, key=1)
    with pytest.raises(ValueError, match=r"\[4, W\]"):
        bsr.bitserial_reduce(planes, bits=4)
    xp = torch.zeros((2, 4, 2), dtype=torch.int32, device=cuda)
    wp = torch.zeros((4, 2, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="different devices"):
        bsm.bitserial_matmul(xp, wp, torch.ones((2, 1)),
                             torch.ones((1, 8), device=cuda), a_bits=4,
                             w_bits=4)
