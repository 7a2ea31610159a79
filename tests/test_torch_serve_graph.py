"""Where `serve_continuous` keeps the eager decode step.

On a CUDA device with no executor, each step replays one captured CUDA
graph (`lm.capture_decode_step`); on the CPU, and with a packed-linear
executor installed, it runs the eager step as it always has.  These
tests hold that choice on the CPU: every step counts as ``mode="eager"``
and nothing is captured.  The greedy tokens and the stats are held to
the JAX package's engine on the same params; sampled tokens, which
cannot reproduce `jax.random`, to the port's own call with one slot, and
a call with an executor to the same call without one.  The replayed step
itself is held to the eager one on the card (`tests/test_torch_cuda.py`).
"""
import types
from collections import defaultdict

import jax
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import common as jax_cm
from repro.models import lm as jax_lm
from repro.serve import engine as jax_engine
from repro_torch import configs, convert
from repro_torch.models import common as cm
from repro_torch.models import lm
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace
from repro_torch.serve import engine

SLOTS, MAX_LEN = 3, 12
PHASES = ("serve.admit", "serve.batch_step", "serve.readback",
          "serve.advance")


@pytest.fixture(scope="module")
def pair():
    kw = dict(n_layers=2, quant_bits=8)
    jcfg = jax_cm.reduced(jax_configs.get("smollm-360m"), **kw)
    params = jax_lm.init(jax.random.PRNGKey(0), jcfg)
    model = convert.load(jax.tree.map(np.asarray, params),
                         cm.reduced(configs.get("smollm-360m"), **kw), "cpu")
    return jcfg, params, model


def _requests():
    rng = np.random.default_rng(7)
    return [(rng.integers(0, 256, int(rng.integers(1, 6))).astype(np.int32),
             int(rng.integers(1, 6))) for _ in range(7)]


def _jax_serve(jcfg, params):
    """The JAX engine's greedy tokens and stats for `_requests()`."""
    stats = {}
    out = jax_engine.serve_continuous(
        params, [jax_engine.Request(p, s) for p, s in _requests()], jcfg,
        slots=SLOTS, max_len=MAX_LEN, stats=stats)
    return [o.tolist() for o in out], stats


class Passthrough:
    """A packed-linear executor that counts its calls and lets every
    projection fall through to the kernel."""

    def __init__(self):
        self.active_mask = None
        self.calls = 0

    def __call__(self, weights, x, bits):
        self.calls += 1
        return None


def _counts():
    steps = obs_metrics.counter("serve.decode_steps")
    return (steps.value(mode="eager"), steps.value(mode="graph"),
            obs_metrics.counter("serve.graph_captures").value())


def _serve(model, slots, temperature, executor=None, stats=None):
    out = engine.serve_continuous(
        model, [engine.Request(p, s) for p, s in _requests()], slots=slots,
        max_len=MAX_LEN, temperature=temperature, executor=executor,
        stats=stats,
        generator=torch.Generator().manual_seed(5) if temperature else None)
    assert all(o.dtype == np.int32 for o in out)
    return [o.tolist() for o in out]


@pytest.mark.parametrize("hooked", [False, True])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_cpu_and_executor_steps_are_eager_as_before(pair, temperature,
                                                    hooked):
    jcfg, params, model = pair
    ex = Passthrough() if hooked else None
    before = _counts()
    stats = {}
    got = _serve(model, SLOTS, temperature, ex, stats)
    after = _counts()
    want, want_stats = _jax_serve(jcfg, params)
    assert stats == want_stats
    if temperature == 0.0:
        assert got == want
    else:        # a request's draws do not depend on its batch
        assert got == _serve(model, 1, temperature)
    assert after[0] - before[0] == stats["steps"]
    assert after[1] == before[1] and after[2] == before[2]
    if hooked:      # the hook saw every projection of every step
        assert ex.calls == lm.packed_projections(model) * stats["steps"]
        assert ex.active_mask is None
        assert got == _serve(model, SLOTS, temperature)
    assert model not in engine._SERVE_GRAPHS


def test_an_executor_or_a_cpu_device_chooses_the_eager_step(pair):
    model = pair[2]
    on_card = types.SimpleNamespace(device=torch.device("cuda"))
    assert engine._step_graph(on_card, SLOTS, MAX_LEN, Passthrough()) is None
    assert engine._step_graph(model, SLOTS, MAX_LEN, None) is None


def test_phases_keep_their_order_with_an_executor(pair):
    model = pair[2]
    t = trace.configure(enabled=True)
    t.clear()
    try:
        stats = {}
        _serve(model, SLOTS, 0.0, Passthrough(), stats)
        by_step = defaultdict(list)
        for ev in t.events():
            if ev.name in PHASES:
                by_step[ev.attrs["step"]].append(ev)
    finally:
        trace.configure(enabled=False)
        t.clear()
    assert sorted(by_step) == list(range(1, stats["steps"] + 1))
    prev_end = -np.inf
    for s in sorted(by_step):
        assert [ev.name for ev in by_step[s]] == list(PHASES)
        for ev in by_step[s]:
            assert ev.ts >= prev_end - 1e-3
            prev_end = ev.ts + ev.dur


def test_a_step_is_captured_on_a_cuda_device_only(pair):
    model = pair[2]
    states = lm.decode_state_init(model.cfg, 2, 4, "cpu")
    token = torch.zeros((2, 1), dtype=torch.long)
    with pytest.raises(ValueError, match="CUDA"):
        lm.capture_decode_step(model, token, states, 0)
    with pytest.raises(ValueError, match="ctx"):
        lm.decode_step(model, token, states, 0, ctx=torch.zeros(1),
                       graph=object())
