"""The port's six array kernels of `kernels.comefa_sim` held to the JAX
package's: eltwise multiply, GEMV, GEMM, dot, FIR and batched GEMM.

Each case feeds the same seeded numpy inputs, at the sizes the JAX tests
use (`tests/test_chaining.py`, `test_schedule.py`, `test_streams.py`,
`test_grid.py`, `test_ir.py`), through `repro.kernels.comefa_sim` and
`repro_torch.kernels.comefa_sim` on the CPU and requires:

  * results exactly equal (and equal to the numpy oracle);
  * every program either side dispatches - in order - byte-equal as an
    encoded engine matrix, and every `_PROGRAMS` entry the call made
    encoding to JAX's `block.encoded` of the JAX program;
  * the ``comefa.kernel_cycles`` counter equal for GEMV and GEMM;
  * the FIR per-sample cache evicting in the same FIFO order;
  * the batched GEMM's operands, staged as packed rows on the device,
    leaving the grid exactly as slot-by-slot host placement does.

The port runs on both CPU engines (``reference`` and ``packed``, the CUDA
step kernel's plain version) where a case takes under a second, and on
``packed`` alone otherwise.
"""
import numpy as np
import pytest

from repro.core.comefa import block as jax_block
from repro.core.comefa import grid as jax_grid
from repro.kernels import comefa_sim as jax_sim
from repro.obs import metrics as jax_metrics
from repro_torch.core.comefa import block, grid
from repro_torch.kernels import comefa_sim
from repro_torch.obs import metrics

BOTH = ("reference", "packed")
PACKED = ("packed",)


@pytest.fixture
def dispatched(monkeypatch):
    """Record the encoded matrix of every array and grid dispatch, one
    list for JAX and one for the port."""
    metrics.reset()
    seen = {"jax": [], "port": []}
    for side, classes in (("jax", (jax_block.ComefaArray,
                                   jax_grid.ComefaGrid)),
                          ("port", (block.ComefaArray, grid.ComefaGrid))):
        for cls in classes:
            orig = cls._dispatch

            def rec(self, mat, _orig=orig, _log=seen[side]):
                _log.append(np.array(mat))
                return _orig(self, mat)
            monkeypatch.setattr(cls, "_dispatch", rec)
    return seen


def _hold(dispatched, name, call, oracle, engines, kernel=None):
    """Run `call` through JAX, then the port on each engine; hold
    results, dispatched programs, new `_PROGRAMS` entries and the cycle
    counter to JAX's."""
    before = set(jax_sim._PROGRAMS)
    want = call(jax_sim, {})
    np.testing.assert_array_equal(np.asarray(want), oracle)
    jax_mats = list(dispatched["jax"])
    assert jax_mats, name
    for engine in engines:
        dispatched["port"].clear()
        metrics.reset()
        got = call(comefa_sim, {"engine": engine, "device": "cpu"})
        assert type(got) is type(want), (name, engine)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        if isinstance(got, np.ndarray):
            assert got.dtype == want.dtype == np.int64
        port_mats = dispatched["port"]
        assert len(port_mats) == len(jax_mats), (name, engine)
        for i, (p, j) in enumerate(zip(port_mats, jax_mats)):
            assert p.dtype == j.dtype and p.tobytes() == j.tobytes(), \
                (name, engine, i)
        if kernel is not None:
            labels = dict(kernel=kernel[0], mode=kernel[1])
            assert metrics.counter("comefa.kernel_cycles").value(**labels) \
                == jax_metrics.counter("comefa.kernel_cycles").value(
                    **labels) > 0, (name, engine)
    for key in set(jax_sim._PROGRAMS) - before:
        assert key in comefa_sim._PROGRAMS, key
        mine = block.encoded(comefa_sim._PROGRAMS[key][0])
        ref = jax_block.encoded(jax_sim._PROGRAMS[key][0])
        assert mine.tobytes() == ref.tobytes(), key


def _fir_ref(taps, x):
    k = len(taps)
    return np.array([
        sum(int(taps[j]) * int(x[t - j]) for j in range(min(k, t + 1)))
        for t in range(len(x))], dtype=np.int64)


@pytest.mark.parametrize("optimized", [True, False])
def test_eltwise_mul(dispatched, optimized):
    rng = np.random.default_rng(5)
    a = rng.integers(0, 256, size=333)
    b = rng.integers(0, 256, size=333)
    _hold(dispatched, "eltwise",
          lambda m, kw: m.comefa_eltwise_mul(a, b, bits=8,
                                             optimized=optimized, **kw),
          a * b, BOTH)


@pytest.mark.parametrize("recode", ["naive", "booth", "naf", "auto"])
def test_gemv_recodes(dispatched, recode):
    rng = np.random.default_rng(21)
    k, n = 11, 170
    w = rng.integers(0, 32, size=(k, n))
    x = rng.integers(0, 32, size=k)
    _hold(dispatched, f"gemv-{recode}",
          lambda m, kw: m.comefa_gemv(w, x, w_bits=5, x_bits=5, acc_bits=24,
                                      recode=recode, **kw),
          (w * x[:, None]).sum(0), BOTH, kernel=("gemv", recode))


@pytest.mark.parametrize("k,n,acc_bits,optimized", [
    (6, 200, 20, True),          # tests/test_ir.py
    (40, 200, 24, True),         # chunked k beyond the one-shot row budget
    (40, 200, 24, False)])
def test_gemv_chunked(dispatched, k, n, acc_bits, optimized):
    rng = np.random.default_rng(k + n)
    w = rng.integers(0, 32, size=(k, n))
    x = rng.integers(0, 32, size=k)
    _hold(dispatched, "gemv",
          lambda m, kw: m.comefa_gemv(w, x, w_bits=5, x_bits=5,
                                      acc_bits=acc_bits,
                                      optimized=optimized, **kw),
          (w * x[:, None]).sum(0), BOTH, kernel=("gemv", "naive"))


@pytest.mark.parametrize("m,k,n,bits,n_blocks,optimized", [
    (3, 8, 5, 2, 1, True),       # single ragged tile
    (4, 16, 7, 3, 1, True),      # multi-tile, ragged last (10 + 10 + 8)
    (4, 16, 7, 3, 1, False),
    (4, 64, 3, 2, 2, True),      # chained 2-block groups, ragged last tile
    (5, 40, 9, 2, 4, True),      # 4 blocks, 64-lane groups across seams
    (2, 5, 7, 3, 1, True)])      # non-power-of-two k
def test_gemm(dispatched, m, k, n, bits, n_blocks, optimized):
    rng = np.random.default_rng(m * 100 + k * 10 + n)
    a = rng.integers(0, 1 << bits, size=(m, k))
    b = rng.integers(0, 1 << bits, size=(k, n))
    engines = BOTH if n_blocks == 1 else PACKED
    _hold(dispatched, "gemm",
          lambda mm, kw: mm.comefa_gemm(a, b, bits=bits, n_blocks=n_blocks,
                                        optimized=optimized, **kw),
          a.astype(np.int64) @ b, engines, kernel=("gemm", "chained"))


def test_gemm_ragged_tile_not_polluted_by_previous_tile(dispatched):
    m, k, n, bits = 5, 8, 9, 3                 # 45 outputs, tiles of 20
    a = np.full((m, k), (1 << bits) - 1)
    b = np.full((k, n), (1 << bits) - 1)
    _hold(dispatched, "gemm-ragged",
          lambda mm, kw: mm.comefa_gemm(a, b, bits=bits, n_blocks=1, **kw),
          a.astype(np.int64) @ b, BOTH, kernel=("gemm", "chained"))


@pytest.mark.parametrize("n_blocks,n,bits,optimized,engines", [
    (1, 150, 4, True, BOTH),
    (2, 300, 4, True, PACKED),
    (2, 320, 3, False, PACKED),
    (4, 640, 3, True, PACKED)])
def test_dot(dispatched, n_blocks, n, bits, optimized, engines):
    rng = np.random.default_rng(n)
    a = rng.integers(0, 1 << bits, size=n)
    b = rng.integers(0, 1 << bits, size=n)
    assert comefa_sim.layout.plan_chain(n).n_blocks == n_blocks
    _hold(dispatched, "dot",
          lambda m, kw: m.comefa_dot(a, b, bits=bits, optimized=optimized,
                                     **kw),
          int((a.astype(np.int64) * b).sum()), engines)
    key = ("dot", bits, n_blocks, optimized)
    assert comefa_sim._PROGRAMS[key][0].cycles == \
        jax_sim._PROGRAMS[key][0].cycles


@pytest.mark.parametrize("n_blocks,n_taps,optimized", [
    (1, 96, True), (2, 290, True), (4, 520, True), (2, 200, False)])
def test_fir_across_blocks(dispatched, n_blocks, n_taps, optimized):
    rng = np.random.default_rng(n_taps)
    taps = rng.integers(0, 8, size=n_taps)
    x = rng.integers(0, 8, size=6)
    assert comefa_sim.layout.plan_chain(n_taps).n_blocks == n_blocks
    _hold(dispatched, "fir",
          lambda m, kw: m.comefa_fir(taps, x, tap_bits=3, x_bits=3,
                                     optimized=optimized, **kw),
          _fir_ref(taps, x), BOTH)


@pytest.mark.parametrize("recode", ["naive", "booth", "naf"])
def test_fir_recoded(dispatched, recode):
    rng = np.random.default_rng(23)
    taps = rng.integers(0, 16, size=170)          # 2 chained blocks
    xs = rng.integers(0, 16, size=5)
    _hold(dispatched, f"fir-{recode}",
          lambda m, kw: m.comefa_fir(taps, xs, tap_bits=4, x_bits=4,
                                     recode=recode, **kw),
          _fir_ref(taps, xs), BOTH)


@pytest.mark.parametrize("cache_max,x", [
    (3, [1, 2, 3]),                               # init and shift evicted
    (4, [1, 2, 3, 4, 5, 6, 7, 1, 2, 3])])         # evicted values recur
def test_fir_cache_fifo_eviction_matches_jax(monkeypatch, cache_max, x):
    rng = np.random.default_rng(cache_max)
    taps = rng.integers(0, 4, size=8)
    x = np.array(x, dtype=np.int64)
    for mod in (jax_sim, comefa_sim):
        monkeypatch.setattr(mod, "_FIR_CACHE", {})
        monkeypatch.setattr(mod, "_FIR_CACHE_MAX", cache_max)
    want = jax_sim.comefa_fir(taps, x, tap_bits=3, x_bits=3)
    got = comefa_sim.comefa_fir(taps, x, tap_bits=3, x_bits=3,
                                device="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _fir_ref(taps, x))
    assert list(comefa_sim._FIR_CACHE) == list(jax_sim._FIR_CACHE)
    assert 0 < len(comefa_sim._FIR_CACHE) <= cache_max
    for key, prog in comefa_sim._FIR_CACHE.items():
        assert block.encoded(prog).tobytes() == \
            jax_block.encoded(jax_sim._FIR_CACHE[key]).tobytes(), key


@pytest.mark.parametrize("g,m,k,n,bits,n_blocks", [
    (2, 3, 40, 3, 2, 4),           # tests/test_grid.py, 4 chained blocks
    (3, 2, 5, 4, 3, 1),
    (3, 4, 9, 1, 2, 1)])
def test_gemm_batched(dispatched, g, m, k, n, bits, n_blocks):
    rng = np.random.default_rng(13 + g + k)
    a = rng.integers(0, 1 << bits, size=(g, m, k))
    b = rng.integers(0, 1 << bits, size=(g, k, n))
    engines = BOTH if n_blocks == 1 else PACKED
    _hold(dispatched, "gemm_batched",
          lambda mm, kw: mm.comefa_gemm_batched(a, b, bits=bits,
                                                n_blocks=n_blocks, **kw),
          np.einsum("gmk,gkn->gmn", a, b), engines)


@pytest.mark.parametrize("g,m,k,n,bits,n_blocks", [(2, 3, 40, 3, 2, 4),
                                                   (3, 4, 9, 5, 3, 1)])
def test_gemm_batched_device_staging_leaves_host_placement_state(
        monkeypatch, g, m, k, n, bits, n_blocks):
    """The port stages each tile's operands as packed rows on the device;
    the grid must end exactly as the JAX kernel's slot-by-slot host
    placement leaves it, without a host sync."""
    grids = []

    class Recorded(grid.ComefaGrid):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            grids.append(self)
    monkeypatch.setattr(comefa_sim, "ComefaGrid", Recorded)
    rng = np.random.default_rng(g * k)
    a = rng.integers(0, 1 << bits, size=(g, m, k))
    b = rng.integers(0, 1 << bits, size=(g, k, n))
    comefa_sim.comefa_gemm_batched(a, b, bits=bits, n_blocks=n_blocks,
                                   engine="packed", device="cpu")
    staged = grids[-1]
    assert staged.host_syncs == 0 and staged.device_puts == 1
    plan = comefa_sim.schedule.plan_gemm(m, k, n, bits, n_blocks=n_blocks)
    lanes = plan.lane_plan()
    placed = grid.ComefaGrid(g, n_blocks=plan.n_blocks, chain=True,
                             engine="packed", device="cpu")
    for tile in plan.tiles():
        buf = plan.buffers[tile.buffer]
        for s in range(g):
            xv, yv = plan.tile_operands(tile, a[s], b[s])
            lanes.place(placed.slot(s), xv, buf.x.base, bits)
            lanes.place(placed.slot(s), yv, buf.y.base, bits)
        placed.run(plan.compute_program(tile.buffer))
    for name in ("mem", "carry", "mask", "cycles"):
        np.testing.assert_array_equal(getattr(staged, name),
                                      getattr(placed, name))
