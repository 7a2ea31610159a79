"""The port's bit-plane packing and bit-plane matmul, held to the JAX package.

Inputs come from numpy seeds and go through both packages.  Packing is
compared bit for bit (the port's int32 words viewed as uint32).  The
matmul's plain version sums in another order than the JAX kernel and
oracle, so float results are compared within the f32 bound for two
sums of the same K products taken in different orders (each within
(K + 1) * 2^-24 * (|x| @ |w|) of the exact sum, the scale included), so
|d| <= (K + 2) * 2^-23 * (|x| @ |w|); on
integer inputs with scale 1 every partial sum is exact and so is the
comparison.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import bitplane_matmul as jax_bpm
from repro.kernels import ref as jax_ref
from repro.models import common as jax_cm
from repro.quant import bitplane as jax_bp
from repro_torch.kernels import bitplane_matmul as bpm
from repro_torch.kernels import ops, ref
from repro_torch.models import common as cm
from repro_torch.quant import bitplane as bp

SMOLLM_SHAPES = [(960, 960), (960, 320), (960, 2560), (2560, 960)]


def _ints(rng, bits, shape):
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    return rng.integers(lo, hi + 1, size=shape).astype(np.int32)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _reorder_bound(x, q, scale):
    """Elementwise f32 bound on the gap between two orders of one sum."""
    k = x.shape[1]
    mag = np.abs(x).astype(np.float64) @ (np.abs(q) * np.abs(scale))
    return (k + 2) * 2.0 ** -23 * mag


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("shape,axis", [((64, 16), 0), ((32, 64), 1)])
def test_pack_bit_identical_to_jax(bits, shape, axis):
    q = _ints(np.random.default_rng(bits), bits, shape)
    mine = bp.pack(torch.as_tensor(q), bits, axis=axis)
    theirs = np.asarray(jax_bp.pack(jnp.asarray(q), bits, axis=axis))
    assert mine.dtype == torch.int32
    np.testing.assert_array_equal(_u32(mine), theirs)
    back = bp.unpack(mine, bits, axis=axis)
    np.testing.assert_array_equal(back.numpy(), q)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_pack_full_signed_range(bits):
    """Every representable value, the asymmetric minimum included, packs
    as the JAX package packs it and unpacks to itself."""
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    vals = np.arange(lo, hi + 1, dtype=np.int32)
    q = np.tile(vals, max(1, 64 // len(vals)))[:, None].repeat(3, axis=1)
    assert q.shape[0] % 32 == 0 and q.min() == lo and q.max() == hi
    mine = bp.pack(torch.as_tensor(q), bits, axis=0)
    np.testing.assert_array_equal(
        _u32(mine), np.asarray(jax_bp.pack(jnp.asarray(q), bits, axis=0)))
    np.testing.assert_array_equal(bp.unpack(mine, bits).numpy(), q)


def test_round_half_to_even_pinned():
    """torch.round and jnp.round both round half to even."""
    halves = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5], np.float32)
    expect = np.array([-2, -2, -0, 0, 2, 2], np.float32)
    np.testing.assert_array_equal(torch.round(torch.as_tensor(halves)),
                                  expect)
    np.testing.assert_array_equal(np.asarray(jnp.round(halves)), expect)
    # and quantize sees a tie: w / scale = 0.5 * k lands on even integers
    w = np.array([[127.0], [63.5], [-0.5], [1.5]], np.float32)
    q, scale = bp.quantize(torch.as_tensor(w), 8, axis=0)
    assert float(scale) == 1.0
    np.testing.assert_array_equal(q.numpy()[:, 0], [127, 64, 0, 2])


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_pack_matches_jax(bits):
    w = np.random.default_rng(7).normal(size=(96, 40)).astype(np.float32)
    q, scale = bp.quantize(torch.as_tensor(w), bits, axis=0)
    jq, jscale = jax_bp.quantize(jnp.asarray(w), bits, axis=0)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    packed, scale2 = bp.quantize_pack(torch.as_tensor(w), bits, axis=0)
    jpacked, _ = jax_bp.quantize_pack(jnp.asarray(w), bits, axis=0)
    np.testing.assert_array_equal(_u32(packed), np.asarray(jpacked))
    np.testing.assert_array_equal(scale2.numpy(), np.asarray(jscale))


# ---------------------------------------------------------------------------
# bit-plane matmul: plain version against the JAX kernel and oracle
# ---------------------------------------------------------------------------

def _operands(seed, bits, m, k, n):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    q = _ints(rng, bits, (k, n))
    scale = rng.uniform(0.01, 0.1, size=(1, n)).astype(np.float32)
    planes = np.asarray(jax_bp.pack(jnp.asarray(q), bits, axis=0))
    return x, q, scale, planes


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("m,k,n", [(8, 128, 128), (1, 384, 128)])
def test_plain_matches_pallas_interpret(bits, m, k, n):
    """At block-multiple shapes, against the Pallas kernel itself."""
    x, q, scale, planes = _operands(m * k + bits, bits, m, k, n)
    bm = min(128, max(8, m))
    xp = np.pad(x, ((0, (-m) % bm), (0, 0)))
    y_jax = np.asarray(jax_bpm.bitplane_matmul(
        jnp.asarray(xp), jnp.asarray(planes), jnp.asarray(scale), bits=bits,
        bm=bm, interpret=True))[:m]
    y = bpm.bitplane_matmul(torch.as_tensor(x),
                            torch.as_tensor(planes.view(np.int32).copy()),
                            torch.as_tensor(scale), bits=bits).numpy()
    assert np.all(np.abs(y - y_jax) <= _reorder_bound(x, q, scale))


@pytest.mark.parametrize("k,n", SMOLLM_SHAPES)
def test_plain_matches_ref_at_smollm_shapes(k, n):
    """SmolLM's projection shapes (K or N not multiples of 128 for wk/wv)
    against the JAX oracle `bitplane_matmul_ref`."""
    bits, m = 8, 4
    x, q, scale, planes = _operands(k + n, bits, m, k, n)
    y_ref = np.asarray(jax_ref.bitplane_matmul_ref(
        jnp.asarray(x), jnp.asarray(planes), jnp.asarray(scale), bits=bits))
    t_planes = torch.as_tensor(planes.view(np.int32).copy())
    y = bpm.bitplane_matmul(torch.as_tensor(x), t_planes,
                            torch.as_tensor(scale), bits=bits).numpy()
    bound = _reorder_bound(x, q, scale)
    assert np.all(np.abs(y - y_ref) <= bound)
    y_port_ref = ref.bitplane_matmul_ref(torch.as_tensor(x), t_planes,
                                         torch.as_tensor(scale), bits=bits)
    assert np.all(np.abs(y_port_ref.numpy() - y_ref) <= bound)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("m,k,n", [(8, 128, 128), (3, 64, 100)])
def test_plain_exact_on_integers(bits, m, k, n):
    """Integer x and scale 1: every sum is exact, so the result is."""
    rng = np.random.default_rng(bits + m)
    q = _ints(rng, bits, (k, n))
    x = rng.integers(-8, 8, size=(m, k)).astype(np.float32)
    planes = bp.pack(torch.as_tensor(q), bits, axis=0)
    y = bpm.bitplane_matmul(torch.as_tensor(x), planes,
                            torch.ones((1, n), dtype=torch.float32),
                            bits=bits)
    np.testing.assert_array_equal(y.numpy(), x @ q.astype(np.float32))


def test_ops_takes_ragged_and_bf16():
    """ops.bitplane_matmul takes any M and N and a bf16 x, returning
    out_dtype; the JAX wrapper would assert on N=100."""
    bits, m, k, n = 4, 3, 64, 100
    x, q, scale, planes = _operands(0, bits, m, k, n)
    xb = torch.as_tensor(x).to(torch.bfloat16)
    y = ops.bitplane_matmul(xb, torch.as_tensor(planes.view(np.int32).copy()),
                            torch.as_tensor(scale), bits=bits,
                            out_dtype=torch.bfloat16)
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (m, n)
    xf = xb.to(torch.float32).numpy()
    expect = xf @ (q * scale)
    # the only rounding beyond the f32 sum is the final cast to bf16
    bound = _reorder_bound(xf, q, scale) + 2.0 ** -8 * np.abs(expect)
    assert np.all(np.abs(y.to(torch.float32).numpy() - expect) <= bound)


def test_wrapper_rejects_bad_operands():
    x = torch.zeros((2, 64))
    planes = torch.zeros((4, 2, 8), dtype=torch.int32)
    scale = torch.ones((1, 8))
    with pytest.raises(ValueError, match="multiple of 32"):
        bpm.bitplane_matmul(torch.zeros((2, 48)), planes, scale, bits=4)
    with pytest.raises(ValueError, match="planes"):
        bpm.bitplane_matmul(x, planes.to(torch.int64), scale, bits=4)
    with pytest.raises(ValueError, match="scale"):
        bpm.bitplane_matmul(x, planes, torch.ones((8,)), bits=4)
    with pytest.raises(ValueError, match="contiguous"):
        bpm.bitplane_matmul(torch.zeros((64, 2)).T, planes, scale, bits=4)


@pytest.mark.parametrize("k,n", [(64, 96), (96, 40)])
def test_linear_matches_jax_xla_branch(k, n):
    """`linear` on packed params against the JAX `common.linear` (its XLA
    branch, which is what runs on the CPU) on a [B, S, K] input."""
    bits = 8
    rng = np.random.default_rng(k * n)
    w = rng.normal(size=(k, n)).astype(np.float32)
    x = rng.normal(size=(2, 3, k)).astype(np.float32)
    jpacked, jscale = jax_bp.quantize_pack(jnp.asarray(w), bits, axis=0)
    cfg = jax_cm.Config(name="t", n_layers=1, d_model=k, n_heads=1,
                        kv_heads=1, d_ff=n, vocab=8, dtype="float32")
    y_jax = np.asarray(jax_cm.linear({"packed": jpacked, "scale": jscale},
                                     jnp.asarray(x), cfg))
    layer = cm.PackedLinear(
        packed=torch.as_tensor(np.asarray(jpacked).view(np.int32).copy()),
        scale=torch.as_tensor(np.array(jscale)))
    y = cm.linear(layer, torch.as_tensor(x)).numpy()
    q = np.asarray(jax_bp.unpack(jpacked, bits))
    bound = _reorder_bound(x.reshape(-1, k), q, np.asarray(jscale))
    assert np.all(np.abs(y.reshape(-1, n) - y_jax.reshape(-1, n)) <= bound)


def test_linear_hook_contract():
    """A hook sees (params dict, x2 [rows, K], bits) and its answer is
    reshaped and cast; None falls through to the kernel's path."""
    planes = torch.zeros((8, 2, 5), dtype=torch.int32)
    layer = cm.PackedLinear(packed=planes, scale=torch.ones((1, 5)))
    seen = []

    def hook(params, x2, bits):
        seen.append((set(params), tuple(x2.shape), bits))
        return torch.full((x2.shape[0], 5), 2.0, dtype=torch.float64)

    prev = cm.set_linear_hook(hook)
    try:
        y = cm.linear(layer, torch.ones((2, 3, 64)))
    finally:
        assert cm.set_linear_hook(prev) is hook
    assert seen == [({"packed", "scale"}, (6, 64), 8)]
    assert y.dtype == torch.float32 and tuple(y.shape) == (2, 3, 5)
    assert torch.all(y == 2.0)
    prev = cm.set_linear_hook(lambda *a: None)
    try:
        assert torch.all(cm.linear(layer, torch.ones((1, 64))) == 0.0)
    finally:
        cm.set_linear_hook(prev)
