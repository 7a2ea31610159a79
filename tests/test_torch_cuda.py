"""The port on a CUDA GPU: the bit-plane kernel against its plain version,
a reduced model on the card against the CPU, and the CoMeFa step kernel
against its plain version and the uint8 reference engine.

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
from repro_torch.kernels import bitplane_matmul as bpm
from repro_torch.kernels import comefa_sim
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
