"""Serving on the port's CoMeFa grid, held to itself and to the JAX package.

Two claims, both on the CPU at the tiny serving config of
`benchmarks/sim_speed.py` (vocab 64, one layer, d_model 32):

  * grid-executed projections are **bit-exact** against the port's
    reference backend (which swaps only the integer GEMV): a probe runs
    both on every hooked call of a decode sweep and requires
    `torch.equal`;
  * the same recorded activations fed through the JAX and the port's
    executors give equal integer accumulators, equal float outputs and
    equal ``stats["cycles"]`` / ``stats["mode"]`` for every recode mode.

The `sim_speed` sweep against the JAX package's tokens is in
tests/test_torch_serve_grid_sweep.py.

The grid runs the ``packed`` engine here: bit-identical to the uint8
``reference`` engine (tests/test_torch_comefa_engines.py) and about
twice as fast on the CPU.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.kernels import comefa_sim as jax_sim
from repro.models import common as jax_cm
from repro.models import lm as jax_lm
from repro.serve import engine as jax_engine
from repro.serve.comefa_exec import GridLinearExecutor as JaxExecutor
from repro_torch import configs
from repro_torch.kernels import comefa_sim
from repro_torch.models import common as cm
from repro_torch.models import lm
from repro_torch.obs import metrics
from repro_torch.serve import engine
from repro_torch.serve.comefa_exec import (GridLinearExecutor, ENV_RECODE,
                                           acc_bits_for)

ENGINE = "packed"
TINY = dict(vocab=64, n_layers=1, d_model=32, d_ff=64, n_heads=2,
            kv_heads=2, head_dim=16, dtype="float32")


def tiny_cfg(quant_bits=8):
    return dataclasses.replace(cm.reduced(configs.get("smollm-360m"),
                                          **TINY), quant_bits=quant_bits)


class Probe:
    """Runs the grid and reference executors on every hooked call and
    requires equal outputs; records each call's activations."""

    def __init__(self, grid_ex, ref_ex):
        self.grid_ex, self.ref_ex = grid_ex, ref_ex
        self.calls = []

    @property
    def active_mask(self):
        return self.grid_ex.active_mask

    @active_mask.setter
    def active_mask(self, live):
        self.grid_ex.active_mask = self.ref_ex.active_mask = live

    def __call__(self, params, x2, bits):
        yg = self.grid_ex(params, x2, bits)
        yr = self.ref_ex(params, x2, bits)
        assert torch.equal(yg, yr), f"call {len(self.calls)}"
        self.calls.append(x2.clone())
        return yg


def _grid_dispatches() -> float:
    c = metrics.counter("comefa.dispatches")
    return sum(v for labels, v in c.series().items()
               if ("kind", "grid") in labels)


# ---------------------------------------------------------------------------
# grid vs the port's own reference backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant_bits,x_bits,batch,slots",
                         [(4, 4, 3, 2), (8, 8, 1, 2)])
def test_generate_on_grid_bitexact_vs_reference(quant_bits, x_bits, batch,
                                                slots):
    """(4, 4, 3, 2) over-fills the grid (two waves per call); (8, 8, 1, 2)
    under-fills it (one partial wave)."""
    cfg = tiny_cfg(quant_bits)
    model = lm.init(torch.Generator().manual_seed(0), cfg, "cpu")
    prompt = torch.as_tensor(np.arange(2 * batch).reshape(batch, 2)
                             % cfg.vocab)
    probe = Probe(GridLinearExecutor(slots=slots, x_bits=x_bits,
                                     recode=None, engine=ENGINE),
                  GridLinearExecutor(slots=slots, x_bits=x_bits,
                                     backend="reference"))
    before = _grid_dispatches()
    out = engine.generate(model, prompt, steps=2, max_len=8, executor=probe)
    assert tuple(out.shape) == (batch, 2)
    assert len(probe.calls) == 7 * cfg.n_layers * 4
    assert _grid_dispatches() - before > 0
    grid_ex = probe.grid_ex
    assert grid_ex.grid_cycles > 0
    waves_per_call = -(-batch // slots)
    assert grid_ex.slot_steps == batch * len(probe.calls)
    assert grid_ex.slot_capacity == waves_per_call * slots * len(probe.calls)


def test_serve_continuous_on_grid_uses_active_mask():
    """Staggered requests: retired slots drop out of the waves, and the
    grid still equals the reference at every call."""
    cfg = tiny_cfg(4)
    model = lm.init(torch.Generator().manual_seed(1), cfg, "cpu")
    reqs = [engine.Request(np.array([3, 4]), 2),
            engine.Request(np.array([7, 1, 2]), 3)]
    probe = Probe(GridLinearExecutor(slots=2, x_bits=4, recode=None,
                                     engine=ENGINE),
                  GridLinearExecutor(slots=2, x_bits=4,
                                     backend="reference"))
    stats = {}
    outs = engine.serve_continuous(model, reqs, slots=2, max_len=8,
                                   executor=probe, stats=stats)
    assert [len(o) for o in outs] == [2, 3]
    # 3 steps with both rows live, then 2 with one: 8 of 10 slot-steps
    assert stats["steps"] == 5
    assert probe.grid_ex.slot_steps == 7 * 8
    assert probe.grid_ex.occupancy() == pytest.approx(0.8)


def test_wave_split_invariance():
    """Grid width must not change the math: slots=2 vs slots=8 tokens."""
    cfg = tiny_cfg(8)
    model = lm.init(torch.Generator().manual_seed(1), cfg, "cpu")
    prompt = torch.as_tensor(np.arange(10).reshape(5, 2))
    outs = [engine.generate(model, prompt, steps=2, max_len=8,
                            executor=GridLinearExecutor(
                                slots=s, backend="reference"))
            for s in (2, 8)]
    assert torch.equal(outs[0], outs[1])


def test_default_engine_on_cpu_is_the_reference_scan():
    w = np.random.default_rng(2).integers(0, 16, size=(32, 40))
    x = np.random.default_rng(3).integers(0, 16, size=(2, 32))
    stats = {}
    y = comefa_sim.comefa_gemv_batched(
        w[None].repeat(2, 0), x, w_bits=4, x_bits=4,
        acc_bits=acc_bits_for(4, 4, 32), stats=stats, device="cpu")
    np.testing.assert_array_equal(y, x @ w)
    assert stats["mode"] == "broadcast"


# ---------------------------------------------------------------------------
# the port's executor and kernel held to the JAX package's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def recorded():
    """Activations of two hooked calls of a JAX decode sweep at the
    sim_speed config (params from PRNGKey(0)): a K=32 projection (wq) and
    the K=64 FFN output projection, with their params."""
    jcfg = dataclasses.replace(
        jax_cm.reduced(jax_configs.get("smollm-360m"), **TINY), quant_bits=8)
    params = jax_lm.init(jax.random.PRNGKey(0), jcfg)
    seen = []

    def record(p, x2, bits):
        seen.append((p, np.asarray(x2), bits))
        return None                  # fall through to the JAX kernel path

    prompt = np.arange(6).reshape(3, 2) % jcfg.vocab
    jax_engine.generate(params, prompt, jcfg, steps=1, max_len=6,
                        executor=record)
    wq = seen[0]
    ffn_out = next(s for s in seen if s[0]["packed"].shape[1] == 2)
    return [wq, ffn_out]


def _port_params(p):
    return {"packed": torch.from_numpy(
                np.asarray(p["packed"]).view(np.int32).copy()),
            "scale": torch.from_numpy(np.asarray(p["scale"]).copy())}


@pytest.mark.parametrize("recode", [None, "naive", "booth", "naf", "auto"])
def test_executor_and_gemv_equal_jax_on_recorded_activations(recorded,
                                                             recode):
    x_bits = 4
    jax_ex = JaxExecutor(slots=2, x_bits=x_bits, recode=recode)
    ex = GridLinearExecutor(slots=2, x_bits=x_bits, recode=recode,
                            engine=ENGINE)
    rng = np.random.default_rng(9)
    for p, x2, bits in recorded:
        want = np.asarray(jax_ex(p, x2, bits))
        got = ex(_port_params(p), torch.tensor(x2), bits).numpy()
        np.testing.assert_array_equal(got, want)
        assert ex.grid_cycles == jax_ex.grid_cycles
        # the batched GEMV itself: integers, cycles and mode
        q = np.asarray(p["packed"]).view(np.int32)
        k, n = q.shape[1] * 32, q.shape[2]
        w_u = rng.integers(0, 1 << bits, size=(k, n))
        x_u = rng.integers(0, 1 << x_bits, size=(2, k))
        x_u[:, ::4] = 1 << (x_bits - 1)
        acc = acc_bits_for(bits, x_bits, k)
        js, ts = {}, {}
        jy = jax_sim.comefa_gemv_batched(
            np.broadcast_to(w_u, (2, k, n)), x_u, w_bits=bits,
            x_bits=x_bits, acc_bits=acc, recode=recode, stats=js)
        ty = comefa_sim.comefa_gemv_batched(
            w_u[None].repeat(2, 0), x_u, w_bits=bits, x_bits=x_bits,
            acc_bits=acc, recode=recode, stats=ts, engine=ENGINE,
            device="cpu")
        np.testing.assert_array_equal(ty, jy)
        np.testing.assert_array_equal(ty, x_u @ w_u)
        assert ts == js


# ---------------------------------------------------------------------------
# knobs
# ---------------------------------------------------------------------------

def test_recode_env_override(monkeypatch):
    monkeypatch.delenv(ENV_RECODE, raising=False)
    assert GridLinearExecutor().recode is None
    for val, want in (("auto", "auto"), ("naf", "naf"), ("none", None),
                      ("broadcast", None), ("", None), ("Booth", "booth")):
        monkeypatch.setenv(ENV_RECODE, val)
        assert GridLinearExecutor().recode == want, val
    monkeypatch.setenv(ENV_RECODE, "auto")
    assert GridLinearExecutor(recode="naive").recode == "naive"
    assert GridLinearExecutor(recode=None).recode is None
    monkeypatch.setenv(ENV_RECODE, "radix4")
    with pytest.raises(ValueError, match=ENV_RECODE):
        GridLinearExecutor()


def test_acc_bits_cover_worst_case():
    for w_bits, x_bits, k in [(4, 4, 32), (8, 8, 32), (8, 4, 1024),
                              (2, 2, 2)]:
        bound = ((2 ** w_bits - 1) * (2 ** x_bits - 1)) * k
        assert bound < 2 ** acc_bits_for(w_bits, x_bits, k)
