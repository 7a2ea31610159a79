"""The CUDA bit-plane kernel's arithmetic order, emulated in numpy, held to
the plain version and to the JAX kernel.

`csrc/bitplane_matmul.cu` rebuilds a column's 32 weights from its `bits`
plane words with a bit-matrix transpose (three butterfly stages, then one
byte a weight: byte g of word j is weight 8g + j), splits K over CTAs
(`bitplane_matmul.geometry`), and sums in a fixed order: on the CUDA cores
(M <= 8) each lane walks its words in order, and k in order inside a
word (byte g of words j = 0..7 for g = 0..3), with fused multiply-adds,
the four warps' partials meet in warp order and the
splits' in split order; on the tensor cores (M > 8) x is split into three
bf16 parts (hi, mid, lo: one for a bf16 x), and each k16 step adds one
product a part, in that order, into an f32 accumulator.  `_emulate` does
the same on the CPU, so its order, and not only its function, is tested
here.

Integer inputs with scale 1 are exact in any order, so they are compared
bit for bit.  Float inputs are held to the f32 bound for two orders of one
sum, |d| <= (K + 2) * 2^-23 * (|x| @ |q|) * scale, plus one bf16 ulp of the
result where y is bf16 (two sums within the bound may round to
neighbouring bf16 values).  The JAX kernel runs in interpret mode at the
shapes it accepts (K and N multiples of 128).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _minihyp import given, settings, strategies as st

from repro.kernels import bitplane_matmul as jax_bpm
from repro_torch.kernels import bitplane_matmul as bpm
from repro_torch.kernels import ops
from repro_torch.quant import bitplane as bp

SMS = 132                  # the H100 SXM's SMs, for the kernel's geometry
WARPS = 4                  # warps of a CTA (csrc/bitplane_matmul.cu)
SMOLLM_SHAPES = [(960, 960), (960, 320), (960, 2560), (2560, 960)]
DTYPES = (torch.float32, torch.bfloat16)


def _swap(w, i, j, s, mask):
    t = ((w[i] >> np.uint32(s)) ^ w[j]) & np.uint32(mask)
    w[j] = w[j] ^ t
    w[i] = w[i] ^ (t << np.uint32(s))


def _rebuild(planes_u32, kw, bits):
    """The kernel's rebuild of K-word `kw` for every column: planes uint32
    [bits, K/32, N] -> weights f32 [32, N] (row k = weight kw * 32 + k)."""
    n = planes_u32.shape[2]
    w = [planes_u32[i, kw].copy() if i < bits else np.zeros(n, np.uint32)
         for i in range(8)]
    for i in range(4):
        _swap(w, i, i + 4, 4, 0x0F0F0F0F)
    for i in (0, 1, 4, 5):
        _swap(w, i, i + 2, 2, 0x33333333)
    for i in (0, 2, 4, 6):
        _swap(w, i, i + 1, 1, 0x55555555)
    sign = np.uint32((1 << (bits - 1)) * 0x01010101)
    q = np.empty((32, n), np.float32)
    for j in range(8):
        v = w[j] ^ sign
        for g in range(4):
            byte = (v >> np.uint32(8 * g)) & np.uint32(0xFF)
            # the float trick: 2^23 + byte, less 2^23 + 2^(bits-1) (exact)
            q[8 * g + j] = (np.float32(8388608.0) + byte.astype(np.float32)
                            - np.float32(8388608.0 + (1 << (bits - 1))))
    return q


def _fma(a, b, c):
    """f32 a * b + c with one rounding (the product is exact in f64)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _bf16(v):
    return torch.as_tensor(v).to(torch.bfloat16).to(torch.float32).numpy()


def _emulate(x, planes, scale, bits, out_dtype=torch.float32):
    """What the kernel computes, in its order: x torch f32/bf16 [M, K],
    planes int32 [bits, K/32, N], scale f32 [1, N] -> torch [M, N]."""
    xf = x.to(torch.float32).numpy()
    m, k = xf.shape
    n = planes.shape[2]
    pu = planes.numpy().view(np.uint32)
    geo = bpm.geometry(m, k, n, SMS)
    words, per = k // 32, geo["per"]
    partials = []
    for sp in range(geo["splits"]):
        kb, ke = sp * per, min(words, (sp + 1) * per)
        if geo["path"] == "simt":
            part = None
            for w in range(WARPS):
                acc = np.zeros((m, n), np.float32)
                for kw in range(kb + w, ke, WARPS):
                    q = _rebuild(pu, kw, bits)
                    for kk in range(32):
                        acc = _fma(xf[:, kw * 32 + kk, None], q[kk], acc)
                part = acc if part is None else part + acc
        else:
            parts = [xf]                # a bf16 x is its own hi part
            if x.dtype == torch.float32:
                hi = _bf16(xf)
                mid = _bf16(xf - hi)
                parts = [hi, mid, _bf16(xf - hi - mid)]
            q = np.concatenate([_rebuild(pu, kw, bits)
                                for kw in range(kb, ke)])
            part = np.zeros((m, n), np.float32)
            for s0 in range(0, q.shape[0], 16):
                ks = slice(kb * 32 + s0, kb * 32 + s0 + 16)
                for xp in parts:
                    prod = xp[:, ks].astype(np.float64) @ q[s0:s0 + 16]
                    part = (part + prod).astype(np.float32)
        partials.append(part)
    total = partials[0]
    for p in partials[1:]:
        total = total + p
    y = torch.as_tensor(total * scale.numpy())
    return y.to(out_dtype)


def _operands(seed, bits, m, k, n, integer):
    rng = np.random.default_rng(seed)
    q = rng.integers(-(1 << (bits - 1)), 1 << (bits - 1),
                     size=(k, n)).astype(np.int32)
    if integer:
        x = rng.integers(-8, 8, size=(m, k)).astype(np.float32)
        scale = np.ones((1, n), np.float32)
    else:
        x = rng.normal(size=(m, k)).astype(np.float32)
        scale = rng.uniform(0.01, 0.1, size=(1, n)).astype(np.float32)
    planes = bp.pack(torch.as_tensor(q), bits, axis=0)
    return torch.as_tensor(x), q, torch.as_tensor(scale), planes


def _tolerance(x, q, scale, want):
    """The f32 reorder bound, plus one bf16 ulp of `want` if it is bf16."""
    k = x.shape[1]
    mag = np.abs(x.to(torch.float32).numpy()).astype(np.float64) @ (
        np.abs(q) * scale.numpy())
    bound = (k + 2) * 2.0 ** -23 * mag
    if want.dtype == torch.bfloat16:
        w = np.abs(want.to(torch.float32).numpy()).astype(np.float64)
        bound = bound + 2.0 ** (np.floor(np.log2(np.maximum(w, 2.0 ** -126)))
                                - 7)
    return bound


def _check(x, q, scale, planes, bits, out_dtype, integer):
    got = _emulate(x, planes, scale, bits, out_dtype)
    want = bpm.bitplane_matmul_plain(x, planes, scale, bits=bits,
                                     out_dtype=out_dtype)
    assert got.dtype == want.dtype == out_dtype
    if integer:
        assert torch.equal(got, want)
    else:
        d = np.abs(got.double().numpy() - want.double().numpy())
        assert np.all(d <= _tolerance(x, q, scale, want))
    return got


@pytest.mark.parametrize("bits", range(1, 9))
def test_rebuild_gives_the_packed_weights(bits):
    """The butterfly and byte gather give back every weight, in k order,
    over the whole signed range."""
    rng = np.random.default_rng(bits)
    q = rng.integers(-(1 << (bits - 1)), 1 << (bits - 1),
                     size=(96, 40)).astype(np.int32)
    q[:2] = [[-(1 << (bits - 1))], [(1 << (bits - 1)) - 1]]
    pu = bp.pack(torch.as_tensor(q), bits, axis=0).numpy().view(np.uint32)
    for kw in range(3):
        np.testing.assert_array_equal(_rebuild(pu, kw, bits),
                                      q[kw * 32:(kw + 1) * 32])


@pytest.mark.parametrize("m", [4, 32])
@pytest.mark.parametrize("k,n", SMOLLM_SHAPES)
def test_geometry_fills_the_card(k, n, m):
    """At every SmolLM-360M shape the split launches at least one CTA an
    SM, or as many as a cluster of 8 CTAs a tile allows; one K slice a
    CTA, every split with a word."""
    words = k // 32
    geo = bpm.geometry(m, k, n, SMS)
    assert geo["path"] == ("simt" if m <= 8 else "mma")
    assert (geo["splits"] - 1) * geo["per"] < words <= \
        geo["splits"] * geo["per"]
    assert geo["splits"] <= bpm.MAX_CLUSTER
    tiles = geo["n_tiles"] * geo["m_tiles"]
    assert geo["ctas"] >= min(SMS, tiles * bpm.MAX_CLUSTER)


@pytest.mark.parametrize("bits", [1, 8])
@pytest.mark.parametrize("m", [4, 32])
def test_emulation_matches_pallas_interpret(bits, m):
    """At a shape the Pallas kernel accepts: the emulation, the plain
    version and the JAX kernel in interpret mode agree within the bound."""
    k, n = 256, 128
    x, q, scale, planes = _operands(m + bits, bits, m, k, n, integer=False)
    got = _check(x, q, scale, planes, bits, torch.float32, False)
    bm = 8 if m <= 8 else 32
    xp = np.pad(x.numpy(), ((0, (-m) % bm), (0, 0)))
    y_jax = np.asarray(jax_bpm.bitplane_matmul(
        jnp.asarray(xp), jnp.asarray(planes.numpy().view(np.uint32)),
        jnp.asarray(scale.numpy()), bits=bits, bm=bm, interpret=True))[:m]
    assert np.all(np.abs(got.numpy() - y_jax)
                  <= _tolerance(x, q, scale, got))


@pytest.mark.parametrize("m", [1, 4, 8, 9, 32])
@pytest.mark.parametrize("xd", DTYPES)
@pytest.mark.parametrize("od", DTYPES)
def test_emulation_at_smollm_shapes(m, xd, od):
    """(960, 320) and (2560, 960), both paths, both dtypes each way:
    integer inputs exact, float inputs within the bound."""
    for k, n, bits, integer in ((960, 320, 4, True), (960, 320, 4, False),
                                (2560, 960, 8, False)):
        x, q, scale, planes = _operands(m * n + integer, bits, m, k, n,
                                        integer)
        _check(x.to(xd), q, scale, planes, bits, od, integer)


@pytest.mark.parametrize("bits", range(1, 9))
@pytest.mark.parametrize("m", [1, 4, 8, 9, 32])
def test_emulation_every_bit_width_ragged(bits, m):
    """The ragged (M, 64, 100): N not a multiple of 32, two K-words."""
    for integer in (True, False):
        x, q, scale, planes = _operands(bits * m + integer, bits, m, 64,
                                        100, integer)
        for xd in DTYPES:
            _check(x.to(xd), q, scale, planes, bits, torch.float32, integer)


@given(m=st.integers(1, 40), kw=st.integers(1, 12), n=st.integers(1, 70),
       bits=st.integers(1, 8), integer=st.booleans(),
       bf16=st.booleans())
@settings(max_examples=25, deadline=None)
def test_emulation_property(m, kw, n, bits, integer, bf16):
    x, q, scale, planes = _operands(m * 1000 + kw * 10 + n, bits, m,
                                    32 * kw, n, integer)
    xd = torch.bfloat16 if bf16 else torch.float32
    _check(x.to(xd), q, scale, planes, bits, xd, integer)


def test_integer_x_is_one_part_on_the_tensor_cores():
    """An integer x (|x| < 256) is its own bf16 hi part: mid and lo are
    zero, so f32 and bf16 x give the same emulated bits."""
    x, q, scale, planes = _operands(5, 8, 32, 256, 64, integer=True)
    assert torch.equal(_emulate(x, planes, scale, 8),
                       _emulate(x.to(torch.bfloat16), planes, scale, 8))


@pytest.mark.parametrize("m", [4, 32])
def test_ops_bf16_equals_cast_kernel_cast(m):
    """`ops.bitplane_matmul` on a bf16 x with a bf16 y, no casts around
    the kernel, gives the bits of cast -> f32 kernel -> cast."""
    x, q, scale, planes = _operands(m, 8, m, 96, 40, integer=False)
    xb = x.to(torch.bfloat16)
    y = ops.bitplane_matmul(xb, planes, scale, bits=8,
                            out_dtype=torch.bfloat16)
    via = bpm.bitplane_matmul(xb.to(torch.float32), planes, scale,
                              bits=8).to(torch.bfloat16)
    assert y.dtype == torch.bfloat16 and torch.equal(y, via)
    assert torch.equal(_emulate(xb, planes, scale, 8, torch.bfloat16),
                       _emulate(xb.to(torch.float32), planes, scale,
                                8).to(torch.bfloat16))
