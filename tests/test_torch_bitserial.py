"""The port's bit-serial and bulk-bitwise kernels, held to the JAX package.

The seven `ops` entries (`bitserial_matmul`, `quantized_matmul`,
`search_replace`, `raid_xor`, `bitserial_reduce`, `bit_transpose`,
`bit_untranspose`) run here on the CPU, where each takes its kernel's
plain PyTorch version.  Inputs are numpy arrays from seeded generators and
go through both packages; JAX's `ops` runs the Pallas kernels in interpret
mode, as `tests/test_kernels.py` does, at the shapes that file uses (the
Pallas kernels accept only block multiples).  At the shapes they reject -
SmolLM-360M's projections, ragged word counts - the port is held to the
`ref` oracles instead.

Words are compared bit for bit through a uint32 view of the port's int32.
The reduction is exact.  The bit-serial matmul is held to JAX's own
tolerance (rtol 1e-5, atol 1e-4) on real scales and exactly on integer
activations with unit scales; against the f32 oracle at K up to 2560 it
is held to the f32 bound for two orders of one sum,
|d| <= (K + 2) * 2^-23 * (|qx| @ |qw|) * sx * sw.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _minihyp import given, settings, strategies as st

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.quant import bitplane as jax_bp
from repro_torch.kernels import bit_transpose as bt
from repro_torch.kernels import bitserial_matmul as bsm
from repro_torch.kernels import bitserial_reduce as bsr
from repro_torch.kernels import bulk_bitwise as bb
from repro_torch.kernels import ops, ref
from repro_torch.quant import bitplane as bp

SMOLLM_SHAPES = [(960, 960), (960, 320), (960, 2560), (2560, 960)]


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _i32(a: np.ndarray) -> torch.Tensor:
    """JAX uint32 words (or any ints) -> the port's int32 words."""
    return torch.as_tensor(np.asarray(a).astype(np.uint32).view(np.int32))


def _signed(rng, bits, shape):
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    return rng.integers(lo, hi + 1, size=shape).astype(np.int32)


def _pack_rows(qx: np.ndarray, bits: int) -> torch.Tensor:
    """[M, K] ints -> x_packed int32 [M, bits, K/32] (pack along K)."""
    return bp.pack(torch.as_tensor(qx), bits, axis=1).movedim(0, 1) \
        .contiguous()


# ---------------------------------------------------------------------------
# bit_transpose / bit_untranspose
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [4, 8, 16])
def test_bit_transpose_matches_jax(bits):
    x = np.random.default_rng(bits).integers(0, 1 << bits, size=16384) \
        .astype(np.int32)
    mine = ops.bit_transpose(torch.as_tensor(x), bits=bits)
    theirs = np.asarray(jax_ops.bit_transpose(jnp.asarray(x), bits=bits))
    assert mine.dtype == torch.int32
    np.testing.assert_array_equal(_u32(mine), theirs)


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("bits", [4, 8])
def test_bit_untranspose_matches_jax(bits, signed):
    rng = np.random.default_rng(bits + 2 * signed)
    planes = rng.integers(0, 2**32, size=(bits, 512), dtype=np.uint64) \
        .astype(np.uint32)
    mine = ops.bit_untranspose(_i32(planes), bits=bits, signed=signed)
    theirs = np.asarray(jax_ops.bit_untranspose(jnp.asarray(planes),
                                                bits=bits, signed=signed))
    np.testing.assert_array_equal(mine.numpy(), theirs)


def test_bit_transpose_roundtrip_matches_jax():
    """Signed 6-bit values at N = 8192: the port and JAX give the same
    planes and both come back to the values."""
    bits, n = 6, 8192
    x = _signed(np.random.default_rng(6), bits, n)
    mine = ops.bit_transpose(torch.as_tensor(x), bits=bits)
    theirs = jax_ops.bit_transpose(jnp.asarray(x), bits=bits)
    np.testing.assert_array_equal(_u32(mine), np.asarray(theirs))
    np.testing.assert_array_equal(
        ops.bit_untranspose(mine, bits=bits, signed=True).numpy(), x)
    np.testing.assert_array_equal(
        np.asarray(jax_ops.bit_untranspose(theirs, bits=bits, signed=True)),
        x)


@pytest.mark.parametrize("n", [32 * 17, 32 * 300])
@pytest.mark.parametrize("bits", [3, 8, 32])
def test_bit_transpose_matches_ref_at_ragged_n(n, bits):
    """N not a multiple of the Pallas kernel's 8192-element block."""
    x = np.random.default_rng(n + bits).integers(
        -2**31, 2**31, size=n).astype(np.int32)
    mine = ops.bit_transpose(torch.as_tensor(x), bits=bits)
    np.testing.assert_array_equal(_u32(mine),
                                  jax_ref.bit_transpose_ref(x, bits))
    np.testing.assert_array_equal(_u32(mine), ref.bit_transpose_ref(x, bits))
    # unsigned at full width wraps to the same int32; else the low bits
    back = ops.bit_untranspose(mine, bits=bits, signed=False).numpy()
    low = x.astype(np.int64) & ((1 << bits) - 1)
    np.testing.assert_array_equal(back.astype(np.int64) & 0xFFFFFFFF, low)


# ---------------------------------------------------------------------------
# search_replace / raid_xor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits,n", [(16, 2048), (20, 4096), (8, 544)])
def test_search_replace_matches_jax(bits, n):
    recs = np.random.default_rng(bits * n).integers(0, 1 << bits, size=n)
    key = int(recs[5])
    planes = jax_ref.bit_transpose_ref(recs, bits)
    out, mask = ops.search_replace(_i32(planes), bits=bits, key=key)
    j_out, j_mask = jax_ops.search_replace(jnp.asarray(planes), bits=bits,
                                           key=key)
    np.testing.assert_array_equal(_u32(out), np.asarray(j_out))
    np.testing.assert_array_equal(_u32(mask), np.asarray(j_mask))
    got = bp.unpack(out, bits, signed=False).numpy()
    np.testing.assert_array_equal(got, ref.search_replace_ref(recs, key))


def test_raid_xor_matches_jax():
    stripes = np.random.default_rng(5).integers(
        0, 2**32, size=(5, 4096), dtype=np.uint64).astype(np.uint32)
    mine = ops.raid_xor(_i32(stripes))
    np.testing.assert_array_equal(
        _u32(mine), np.asarray(jax_ops.raid_xor(jnp.asarray(stripes))))


@pytest.mark.parametrize("bits", [1, 7, 32])
def test_search_replace_matches_ref_at_w300(bits):
    """W = 300 words, which the Pallas kernel's 512-word block rejects."""
    rng = np.random.default_rng(300 + bits)
    recs = rng.integers(0, 1 << min(bits, 8), size=32 * 300)
    if bits == 32:
        recs = recs - 128                   # negative records, all 32 bits
    key = int(recs[17])
    planes = ops.bit_transpose(torch.as_tensor(recs.astype(np.int32)),
                               bits=bits)
    out, mask = ops.search_replace(planes, bits=bits, key=key)
    back = ops.bit_untranspose(out, bits=bits, signed=bits == 32).numpy()
    np.testing.assert_array_equal(back, ref.search_replace_ref(recs, key))
    hits = ops.bit_untranspose(mask[None], bits=1, signed=False).numpy()
    np.testing.assert_array_equal(hits, (recs == key).astype(np.int32))


def test_raid_xor_matches_ref_at_w300():
    stripes = np.random.default_rng(7).integers(
        -2**31, 2**31, size=(6, 300)).astype(np.int32)
    np.testing.assert_array_equal(ops.raid_xor(torch.as_tensor(stripes))
                                  .numpy(), ref.raid_xor_ref(stripes))
    one = torch.as_tensor(stripes[:1])
    got = ops.raid_xor(one)
    assert torch.equal(got, one[0]) and got.data_ptr() != one.data_ptr()


# ---------------------------------------------------------------------------
# bitserial_reduce
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits,n", [(4, 2048), (8, 4096), (16, 1024)])
def test_bitserial_reduce_matches_jax(bits, n):
    vals = _signed(np.random.default_rng(bits + n), bits, n)
    planes = jax_bp.pack(jnp.asarray(vals), bits, axis=0)
    got = ops.bitserial_reduce(_i32(planes), bits=bits)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert float(got) == float(jax_ops.bitserial_reduce(planes, bits=bits))
    assert float(got) == ref.bitserial_reduce_ref(vals)


def test_bitserial_reduce_rounds_the_int64_sum_once():
    """Past 2^24 the port is the int64 sum rounded once to f32."""
    bits, n = 16, 32 * 4096
    vals = np.full(n, 2**15 - 1, np.int32)
    vals[::3] = 2**15 - 3
    got = ops.bitserial_reduce(ops.bit_transpose(torch.as_tensor(vals),
                                                 bits=bits), bits=bits)
    exact = int(vals.astype(np.int64).sum())
    assert exact > 2**24
    assert float(got) == float(np.float32(exact))


@given(bits=st.sampled_from([1, 4, 8, 12, 32]),
       seed=st.integers(0, 2**31 - 1))
@settings(max_examples=15, deadline=None)
def test_bitserial_reduce_property(bits, seed):
    rng = np.random.default_rng(seed)
    n = 32 * int(rng.integers(1, 64))
    vals = _signed(rng, bits, n)
    got = ops.bitserial_reduce(ops.bit_transpose(torch.as_tensor(vals),
                                                 bits=bits), bits=bits)
    assert float(got) == float(np.float32(vals.astype(np.int64).sum()))


@given(bits=st.integers(1, 32), signed=st.booleans(),
       seed=st.integers(0, 2**31 - 1))
@settings(max_examples=20, deadline=None)
def test_transpose_roundtrip_property(bits, signed, seed):
    rng = np.random.default_rng(seed)
    n = 32 * int(rng.integers(1, 40))
    if signed:
        x = _signed(rng, bits, n)
    else:
        x = rng.integers(0, 1 << min(bits, 31), size=n).astype(np.int32)
    planes = ops.bit_transpose(torch.as_tensor(x), bits=bits)
    np.testing.assert_array_equal(_u32(planes),
                                  jax_ref.bit_transpose_ref(x, bits))
    np.testing.assert_array_equal(
        ops.bit_untranspose(planes, bits=bits, signed=signed).numpy(), x)


# ---------------------------------------------------------------------------
# bitserial_matmul / quantized_matmul
# ---------------------------------------------------------------------------

def _quantized_operands(seed, a_bits, w_bits, m, k, n):
    """Float x and w quantized per row / per column, as JAX's test does."""
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.normal(size=(m, k)), jnp.float32)
    w = jnp.asarray(rng.normal(size=(k, n)), jnp.float32)
    qx, sx = jax_bp.quantize(x, a_bits, axis=1)
    qw, sw = jax_bp.quantize(w, w_bits, axis=0)
    xp = jnp.moveaxis(jax_bp.pack(qx, a_bits, axis=1), 0, 1)
    wp = jax_bp.pack(qw, w_bits, axis=0)
    return xp, wp, sx, sw, np.asarray(qx), np.asarray(qw)


def _port(xp, wp, sx, sw):
    return (_i32(xp), _i32(wp), torch.as_tensor(np.asarray(sx)),
            torch.as_tensor(np.asarray(sw)))


@pytest.mark.parametrize("a_bits,w_bits", [(4, 4), (8, 4), (2, 8)])
def test_bitserial_matmul_matches_jax(a_bits, w_bits):
    m, k, n = 8, 512, 128
    xp, wp, sx, sw, _, _ = _quantized_operands(a_bits * 10 + w_bits, a_bits,
                                               w_bits, m, k, n)
    y_jax = np.asarray(jax_ops.bitserial_matmul(xp, wp, sx, sw,
                                                a_bits=a_bits, w_bits=w_bits))
    y = ops.bitserial_matmul(*_port(xp, wp, sx, sw), a_bits=a_bits,
                             w_bits=w_bits)
    assert y.dtype == torch.float32 and tuple(y.shape) == (m, n)
    np.testing.assert_allclose(y.numpy(), y_jax, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("a_bits,w_bits", [(4, 4), (5, 4), (2, 8)])
def test_bitserial_matmul_exact_on_integers_like_jax(a_bits, w_bits):
    """Integer activations, unit scales: JAX and the port are both exact."""
    m, k, n = 8, 512, 128
    rng = np.random.default_rng(a_bits + w_bits)
    qx, qw = _signed(rng, a_bits, (m, k)), _signed(rng, w_bits, (k, n))
    xp = jnp.moveaxis(jax_bp.pack(jnp.asarray(qx), a_bits, axis=1), 0, 1)
    wp = jax_bp.pack(jnp.asarray(qw), w_bits, axis=0)
    ones_m, ones_n = jnp.ones((m, 1), jnp.float32), jnp.ones((1, n),
                                                             jnp.float32)
    y_jax = np.asarray(jax_ops.bitserial_matmul(xp, wp, ones_m, ones_n,
                                                a_bits=a_bits, w_bits=w_bits))
    y = ops.bitserial_matmul(*_port(xp, wp, ones_m, ones_n), a_bits=a_bits,
                             w_bits=w_bits).numpy()
    exact = (qx.astype(np.int64) @ qw).astype(np.float32)
    np.testing.assert_array_equal(y, exact)
    np.testing.assert_array_equal(y_jax, exact)


@pytest.mark.parametrize("m,k,n", [(4, k, n) for k, n in SMOLLM_SHAPES]
                         + [(3, 64, 100)])
def test_bitserial_matmul_matches_ref_at_smollm_shapes(m, k, n):
    """Shapes the Pallas kernel rejects (N % 128 or K % 512), against the
    JAX and port oracles, at 8x8 bits."""
    bits = 8
    xp, wp, sx, sw, qx, qw = _quantized_operands(k + n, bits, bits, m, k, n)
    y = ops.bitserial_matmul(*_port(xp, wp, sx, sw), a_bits=bits,
                             w_bits=bits).numpy()
    y_ref = np.asarray(jax_ref.bitserial_matmul_ref(xp, wp, sx, sw,
                                                    a_bits=bits, w_bits=bits))
    y_port_ref = ref.bitserial_matmul_ref(*_port(xp, wp, sx, sw),
                                          a_bits=bits, w_bits=bits).numpy()
    mag = (np.abs(qx).astype(np.float64) @ np.abs(qw)) * np.asarray(sx) \
        * np.asarray(sw)
    bound = (k + 2) * 2.0 ** -23 * mag
    assert np.all(np.abs(y - y_ref) <= bound)
    assert np.all(np.abs(y_port_ref - y_ref) <= bound)
    # the port's result is the exact product rounded once, then scaled
    exact = (qx.astype(np.int64) @ qw).astype(np.float32)
    np.testing.assert_array_equal(y, exact * np.asarray(sx) * np.asarray(sw))


@pytest.mark.parametrize("m,k,n,bits", [(8, 256, 128, 4), (4, 960, 320, 8),
                                        (3, 64, 100, 3)])
def test_bitserial_equals_bitplane_on_integers(m, k, n, bits):
    """The same integer operands through both kernels' paths agree
    exactly (every partial sum is an integer below 2^24)."""
    rng = np.random.default_rng(m * k + bits)
    qx = rng.integers(-8, 8, size=(m, k)).astype(np.int32)
    qw = _signed(rng, bits, (k, n))
    wp = bp.pack(torch.as_tensor(qw), bits, axis=0)
    y1 = ops.bitplane_matmul(torch.as_tensor(qx.astype(np.float32)), wp,
                             torch.ones((1, n)), bits=bits)
    y2 = ops.bitserial_matmul(_pack_rows(qx, 5), wp, torch.ones((m, 1)),
                              torch.ones((1, n)), a_bits=5, w_bits=bits)
    np.testing.assert_array_equal(y1.numpy(), y2.numpy())


@pytest.mark.parametrize("bits", [4, 8])
def test_quantized_matmul_matches_jax(bits):
    rng = np.random.default_rng(bits)
    x = rng.normal(size=(8, 256)).astype(np.float32)
    w = rng.normal(size=(256, 128)).astype(np.float32)
    y_jax = np.asarray(jax_ops.quantized_matmul(jnp.asarray(x),
                                                jnp.asarray(w), bits=bits))
    y = ops.quantized_matmul(torch.as_tensor(x), torch.as_tensor(w),
                             bits=bits).numpy()
    q, scale = jax_bp.quantize(jnp.asarray(w), bits, axis=0)
    mag = np.abs(x).astype(np.float64) @ (np.abs(np.asarray(q))
                                          * np.asarray(scale))
    assert np.all(np.abs(y - y_jax) <= (256 + 2) * 2.0 ** -23 * mag)


# ---------------------------------------------------------------------------
# the CUDA kernel's decomposition (csrc/bitserial_matmul.cu), emulated in
# numpy: planes stacked into the binary MMA's rows (m, j) and columns
# (n, i), k256 steps with a zero-filled tail, K split over a cluster, the
# uint32 coefficient epilogue, then (float(acc) * sx) * sw
# ---------------------------------------------------------------------------

H100_SMS = 132
_POPC8 = np.array([bin(v).count("1") for v in range(256)], np.int64)


def _popc32(v: np.ndarray) -> np.ndarray:
    b = np.ascontiguousarray(v, np.uint32).view(np.uint8)
    return _POPC8[b].reshape(*v.shape, 4).sum(-1)


def _coefs(bits: int) -> np.ndarray:
    """Plane weights modulo 2^32 (uint64 wraps mod 2^64, a multiple)."""
    c = [1 << b for b in range(bits)]
    c[-1] = (1 << 32) - c[-1]
    return np.array(c, np.uint64)


def _emulate_mma_kernel(xp, wp, sx, sw, a, w, sms=H100_SMS):
    """The kernel's arithmetic CTA by CTA, from its launch geometry."""
    xw = np.asarray(xp).view(np.uint32)                 # [M, a, W]
    ww = np.asarray(wp).view(np.uint32)                 # [w, W, N]
    m, _, words = xw.shape
    n = ww.shape[2]
    geo = bsm.geometry(m, 32 * words, n, a, w, sms)
    mt, nt = 16 // a, 8 // w
    rows_cta, cols_cta = 16 * bsm.ROW_TILES, 8 * bsm.COL_TILES
    mrows, ncols = bsm.ROW_TILES * mt, bsm.COL_TILES * nt
    kpad = geo["steps"] * bsm.STEP_WORDS
    ca, cw = _coefs(a), _coefs(w)
    y = np.zeros((m, n), np.float32)
    for ty in range(geo["m_tiles"]):
        # stacked rows: an m16 tile holds mt whole rows of a planes each
        A = np.zeros((rows_cta, kpad), np.uint32)
        ra = np.zeros((mrows, rows_cta), np.uint64)     # epilogue weights
        for r in range(rows_cta):
            ml, j = divmod(r % 16, a)
            if ml < mt:
                ra[(r // 16) * mt + ml, r] = ca[j]
                mm = ty * mrows + (r // 16) * mt + ml
                if mm < m:
                    A[r, :words] = xw[mm, j]
        for tx in range(geo["n_tiles"]):
            B = np.zeros((kpad, cols_cta), np.uint32)
            cb = np.zeros((cols_cta, ncols), np.uint64)
            for c in range(cols_cta):
                q, i = divmod(c % 8, w)
                if q < nt:
                    cb[c, (c // 8) * nt + q] = cw[i]
                    nn = tx * ncols + (c // 8) * nt + q
                    if nn < n:
                        B[:words, c] = ww[i, :, nn]
            acc = np.zeros((mrows, ncols), np.uint64)
            for rank in range(geo["splits"]):       # the cluster's CTAs
                cm = np.zeros((rows_cta, cols_cta), np.uint64)
                for st in range(rank * geo["per"],
                                min(geo["steps"], (rank + 1) * geo["per"])):
                    ks = slice(8 * st, 8 * st + 8)     # one k256 MMA step
                    cm += _popc32(A[:, None, ks] & B[ks].T[None]).sum(-1) \
                        .astype(np.uint64)
                acc += ra @ cm @ cb                  # wraps mod 2^64
            acc = (acc & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
            rows = ty * mrows + np.arange(mrows)
            cols = tx * ncols + np.arange(ncols)
            keep_r, keep_c = rows < m, cols < n
            vals = acc[np.ix_(keep_r, keep_c)].astype(np.float32)
            vals = vals * np.asarray(sx)[rows[keep_r]]
            vals = vals * np.asarray(sw)[:, cols[keep_c]]
            y[np.ix_(rows[keep_r], cols[keep_c])] = vals
    return y


def _serial_operands(seed, m, k, n, a, w, scaled=True):
    rng = np.random.default_rng(seed)
    qx, qw = _signed(rng, a, (m, k)), _signed(rng, w, (k, n))
    xp = _pack_rows(qx, a)
    wp = bp.pack(torch.as_tensor(qw), w, axis=0)
    if scaled:
        sx = rng.uniform(0.01, 0.1, (m, 1)).astype(np.float32)
        sw = rng.uniform(0.01, 0.1, (1, n)).astype(np.float32)
    else:
        sx, sw = np.ones((m, 1), np.float32), np.ones((1, n), np.float32)
    return xp, wp, torch.as_tensor(sx), torch.as_tensor(sw), qx, qw


@pytest.mark.parametrize("a,w", [(a, w) for a in (1, 3, 8)
                                 for w in (1, 3, 8)])
@pytest.mark.parametrize("k", [96, 960, 2560])
@pytest.mark.parametrize("m,n", [(5, 70), (17, 100), (4, 320)])
def test_mma_decomposition_equals_plain(m, k, n, a, w):
    """K = 96, 960, 2560 leave 3, 6 and 0 words after the k256 steps;
    M*a and N*w are ragged against the 16 x 8 tiles at 3 bits and at
    M = 5, 17, N = 70, 100."""
    xp, wp, sx, sw, qx, qw = _serial_operands(m * k + n + 10 * a + w, m, k,
                                              n, a, w)
    y = _emulate_mma_kernel(xp, wp, sx, sw, a, w)
    plain = bsm.bitserial_matmul_plain(xp, wp, sx, sw, a_bits=a, w_bits=w)
    np.testing.assert_array_equal(y, plain.numpy())
    exact = (qx.astype(np.int64) @ qw).astype(np.float32)
    ones = _emulate_mma_kernel(xp, wp, torch.ones_like(sx),
                               torch.ones_like(sw), a, w)
    np.testing.assert_array_equal(ones, exact)


@pytest.mark.parametrize("m,k,a,w", [(5, 96, 8, 8), (17, 96, 3, 1),
                                     (5, 2560, 3, 3), (17, 2560, 1, 3)])
def test_mma_decomposition_equals_jax_kernel(m, k, a, w):
    """At shapes the Pallas kernel takes (N = 128, K < 512 or K % 512 ==
    0), in interpret mode; every partial sum stays below 2^24, so JAX's
    f32 sum is exact too and the three agree bit for bit."""
    n = 128
    assert k << (a + w - 2) < 1 << 24
    xp, wp, sx, sw, _, _ = _serial_operands(m + k + a * w, m, k, n, a, w)
    y = _emulate_mma_kernel(xp, wp, sx, sw, a, w)
    y_jax = np.asarray(jax_ops.bitserial_matmul(
        jnp.asarray(_u32(xp)), jnp.asarray(_u32(wp)), jnp.asarray(sx.numpy()),
        jnp.asarray(sw.numpy()), a_bits=a, w_bits=w))
    np.testing.assert_array_equal(y, y_jax)


@given(m=st.integers(1, 20), kw=st.integers(1, 40), n=st.integers(1, 40),
       a=st.integers(1, 8), w=st.integers(1, 8), seed=st.integers(0, 999))
@settings(max_examples=25, deadline=None)
def test_mma_decomposition_property(m, kw, n, a, w, seed):
    xp, wp, sx, sw, _, _ = _serial_operands(seed, m, 32 * kw, n, a, w)
    np.testing.assert_array_equal(
        _emulate_mma_kernel(xp, wp, sx, sw, a, w),
        bsm.bitserial_matmul_plain(xp, wp, sx, sw, a_bits=a,
                                   w_bits=w).numpy())


@pytest.mark.parametrize("k,n", SMOLLM_SHAPES)
def test_mma_geometry_fills_the_card_at_decode(k, n):
    """M = 4, 8x8 bits on 132 SMs: at least one CTA an SM, clusters of at
    most 8, no cluster CTA without a k256 step, and none of the 32 stacked
    rows is padding."""
    geo = bsm.geometry(4, k, n, 8, 8, H100_SMS)
    assert geo["ctas"] >= H100_SMS and 1 <= geo["splits"] <= 8
    assert (geo["splits"] - 1) * geo["per"] < geo["steps"] <= \
        geo["splits"] * geo["per"]
    assert geo["m_tiles"] == 1 and 4 * 8 == 16 * bsm.ROW_TILES


# ---------------------------------------------------------------------------
# the paper's workloads, composed through ops at small size
# ---------------------------------------------------------------------------

def test_search_replace_pipeline():
    """Element-major records -> bit_transpose -> search_replace ->
    bit_untranspose: matches are zeroed, the mask marks exactly them."""
    bits, n = 16, 32 * 700
    recs = np.random.default_rng(16).integers(0, 1 << 10, size=n) \
        .astype(np.int32)
    key = int(recs[123])
    t = torch.as_tensor(recs)
    out, mask = ops.search_replace(ops.bit_transpose(t, bits=bits),
                                   bits=bits, key=key)
    back = ops.bit_untranspose(out, bits=bits, signed=False)
    assert torch.equal(back, torch.where(t == key, 0, t))
    hits = ops.bit_untranspose(mask[None], bits=1, signed=False)
    assert torch.equal(hits.bool(), t == key) and int(hits.sum()) > 1


def test_raid_rebuild_pipeline():
    """Seven data stripes and their parity; one data stripe lost; the XOR
    of the survivors is the lost stripe."""
    data = torch.as_tensor(np.random.default_rng(8).integers(
        -2**31, 2**31, size=(7, 1000)).astype(np.int32))
    parity = ops.raid_xor(data)
    survivors = torch.cat([data[:3], data[4:], parity[None]])
    assert torch.equal(ops.raid_xor(survivors), data[3])


# ---------------------------------------------------------------------------
# operand checks and device dispatch
# ---------------------------------------------------------------------------

def test_wrappers_reject_bad_operands():
    planes = torch.zeros((8, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        ops.bit_transpose(torch.zeros(64, dtype=torch.int64), bits=8)
    with pytest.raises(ValueError, match="multiple of 32"):
        ops.bit_transpose(torch.zeros(48, dtype=torch.int32), bits=8)
    with pytest.raises(ValueError, match="bits"):
        ops.bit_transpose(torch.zeros(64, dtype=torch.int32), bits=33)
    with pytest.raises(ValueError, match=r"\[4, W\]"):
        ops.bit_untranspose(planes, bits=4)
    with pytest.raises(ValueError, match="planes"):
        ops.search_replace(planes, bits=6, key=1)
    with pytest.raises(ValueError, match="int32"):
        ops.raid_xor(planes.to(torch.int64))
    with pytest.raises(ValueError, match="at least one"):
        ops.raid_xor(planes[:0])
    with pytest.raises(ValueError, match=r"\[4, W\]"):
        ops.bitserial_reduce(planes, bits=4)
    with pytest.raises(ValueError, match="contiguous"):
        bsr.bitserial_reduce(torch.zeros((4, 8), dtype=torch.int32).T,
                             bits=8)


def test_bitserial_matmul_rejects_bad_operands():
    xp = torch.zeros((4, 8, 30), dtype=torch.int32)
    wp = torch.zeros((8, 30, 64), dtype=torch.int32)
    sx, sw = torch.ones((4, 1)), torch.ones((1, 64))
    with pytest.raises(ValueError, match="w_packed"):        # K/32 differs
        bsm.bitserial_matmul(xp, wp[:, :29].contiguous(), sx, sw, a_bits=8,
                             w_bits=8)
    with pytest.raises(ValueError, match="x_packed"):        # mismatched bits
        bsm.bitserial_matmul(xp, wp, sx, sw, a_bits=4, w_bits=8)
    with pytest.raises(ValueError, match="w_packed"):
        bsm.bitserial_matmul(xp, wp.to(torch.int64), sx, sw, a_bits=8,
                             w_bits=8)
    with pytest.raises(ValueError, match="x_scale"):
        bsm.bitserial_matmul(xp, wp, sx.double(), sw, a_bits=8, w_bits=8)
    with pytest.raises(ValueError, match="1..8"):
        bsm.bitserial_matmul(xp, wp, sx, sw, a_bits=9, w_bits=8)
    big = torch.zeros((1, 8, 4096), dtype=torch.int32)        # K = 131072
    with pytest.raises(ValueError, match="overflow"):
        bsm.bitserial_matmul(big, torch.zeros((8, 4096, 1),
                                              dtype=torch.int32),
                             torch.ones((1, 1)), torch.ones((1, 1)),
                             a_bits=8, w_bits=8)


@pytest.mark.parametrize("call", [
    lambda t: bt.bit_transpose(t[0], bits=4),
    lambda t: bt.bit_untranspose(t, bits=4),
    lambda t: bb.search_replace(t, bits=4, key=3),
    lambda t: bb.raid_xor(t),
    lambda t: bsr.bitserial_reduce(t, bits=4),
])
def test_other_devices_raise(call):
    """A tensor neither on the CPU nor on CUDA takes no path at all."""
    with pytest.raises(ValueError, match="device"):
        call(torch.zeros((4, 64), dtype=torch.int32, device="meta"))


def test_cpu_takes_the_plain_path_and_counts_no_launch():
    before = (dict(bt.launches), dict(bb.launches), bsr.launches,
              bsm.launches)
    planes = ops.bit_transpose(torch.arange(64, dtype=torch.int32), bits=8)
    ops.bit_untranspose(planes, bits=8)
    ops.search_replace(planes, bits=8, key=3)
    ops.raid_xor(planes)
    ops.bitserial_reduce(planes, bits=8)
    ops.bitserial_matmul(planes.view(8, 1, 2).movedim(1, 0).contiguous(),
                         torch.zeros((8, 2, 3), dtype=torch.int32),
                         torch.ones((1, 1)), torch.ones((1, 3)), a_bits=8,
                         w_bits=8)
    assert (dict(bt.launches), dict(bb.launches), bsr.launches,
            bsm.launches) == before
