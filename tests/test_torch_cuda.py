"""The port on a CUDA GPU: the bit-plane kernel against its plain version,
and a reduced model on the card against the CPU.

Every test here needs the card: it carries the `cuda` marker and skips
where `torch.cuda.is_available()` is False.  The file imports no JAX, so
it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Float results are held to the f32 bound for two orders of one sum,
|d| <= (K + 2) * 2^-23 * (|x| @ |w|); integer inputs with scale 1 are
exact in any order.
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import bitplane_matmul as bpm
from repro_torch.models import common as cm
from repro_torch.models import lm
from repro_torch.quant import bitplane as bp
from repro_torch.serve import engine

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
