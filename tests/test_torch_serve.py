"""The port's serving engine held to the JAX package's on the same params.

Greedy tokens must be equal: the logits agree within f32 reordering
(see test_torch_model.py), far inside the gaps between the top logits of
these inputs.  Temperature sampling cannot reproduce `jax.random`, so at
temperature > 0 the port is held to its own property: a request's tokens
do not depend on what it was batched with.
"""
import jax
import jax.numpy as jnp
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
from repro_torch.obs import metrics, trace
from repro_torch.serve import engine


@pytest.fixture(scope="module")
def pair():
    kw = dict(n_layers=2, quant_bits=8)
    jcfg = jax_cm.reduced(jax_configs.get("smollm-360m"), **kw)
    cfg = cm.reduced(configs.get("smollm-360m"), **kw)
    params = jax_lm.init(jax.random.PRNGKey(0), jcfg)
    model = convert.load(jax.tree.map(np.asarray, params), cfg, "cpu")
    return jcfg, params, model


def _requests(seed, n, vocab):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, int(rng.integers(1, 5))).astype(np.int32),
             int(rng.integers(2, 5))) for _ in range(n)]


def test_generate_greedy_equals_jax(pair):
    jcfg, params, model = pair
    prompt = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 5)).astype(
        np.int32)
    want = np.asarray(jax_engine.generate(params, jnp.asarray(prompt), jcfg,
                                          steps=5, max_len=12))
    got = engine.generate(model, torch.as_tensor(prompt), steps=5, max_len=12)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_serve_continuous_greedy_equals_jax(pair):
    jcfg, params, model = pair
    reqs = _requests(1, 5, jcfg.vocab)
    jstats, stats = {}, {}
    want = jax_engine.serve_continuous(
        params, [jax_engine.Request(p, s) for p, s in reqs], jcfg, slots=2,
        max_len=10, stats=jstats)
    got = engine.serve_continuous(
        model, [engine.Request(p, s) for p, s in reqs], slots=2, max_len=10,
        stats=stats)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert stats == jstats


def test_prefill_matches_forward_last_token(pair):
    _, _, model = pair
    toks = torch.as_tensor(np.random.default_rng(4).integers(0, 256, (2, 6)))
    logits, states = engine.prefill(model, toks, max_len=8)
    np.testing.assert_array_equal(logits.numpy(),
                                  lm.forward(model, toks)[0][:, -1:].numpy())
    assert len(states) == model.cfg.n_layers
    assert tuple(states[0]["k"].shape) == (2, 8, 2, 16)


def test_generate_rejects_empty_prompt(pair):
    _, _, model = pair
    with pytest.raises(ValueError, match="non-empty prompt"):
        engine.generate(model, torch.zeros((2, 0), dtype=torch.long),
                        steps=2, max_len=4)


def test_serve_continuous_rejects_empty_and_too_long(pair):
    _, _, model = pair
    with pytest.raises(ValueError, match="empty prompt"):
        engine.serve_continuous(model, [engine.Request([1], 1),
                                        engine.Request([], 1)],
                                slots=2, max_len=8)
    with pytest.raises(ValueError, match="needs 9 positions, max_len is 8"):
        engine.serve_continuous(model, [engine.Request([1, 2, 3], 6)],
                                slots=2, max_len=8)


def test_batched_equals_serialised_at_temperature(pair):
    """At T=0.7, running requests together over 3 slots gives each the
    tokens it gets when slots=1 runs the same list one request at a time
    (same request ids, so the same draws)."""
    _, _, model = pair
    reqs = [engine.Request(p, s) for p, s in _requests(2, 5, 256)]
    kw = dict(max_len=10, temperature=0.7,
              generator=torch.Generator().manual_seed(11))
    stats = {}
    together = engine.serve_continuous(model, reqs, slots=3, stats=stats,
                                       **kw)
    alone = engine.serve_continuous(model, reqs, slots=1, **kw)
    for t, a, r in zip(together, alone, reqs):
        assert len(t) == r.steps
        np.testing.assert_array_equal(t, a)
    total = sum(len(r.prompt) + r.steps - 1 for r in reqs)
    assert stats["slot_steps"] == total and stats["steps"] < total
    greedy = engine.serve_continuous(model, reqs, slots=3, max_len=10)
    assert any(not np.array_equal(g, t) for g, t in zip(greedy, together))


def test_generate_temperature_is_seeded(pair):
    _, _, model = pair
    prompt = torch.tensor([[1, 2, 3]] * 3)

    def run(seed):
        return engine.generate(model, prompt, steps=6, max_len=10,
                               temperature=1.5,
                               generator=torch.Generator().manual_seed(seed))
    assert torch.equal(run(0), run(0))
    assert not torch.equal(run(0), run(1))


def test_serving_spans_and_counters(pair):
    """serve_continuous opens one serve.request span per request and
    counts completions in the port's own metrics registry."""
    _, _, model = pair
    metrics.reset()
    tracer = trace.configure(enabled=True)
    tracer.clear()
    try:
        engine.serve_continuous(model, [engine.Request([1, 2], 2)] * 3,
                                slots=2, max_len=6)
        names = [ev.name for ev in tracer.events()]
    finally:
        trace.configure(enabled=False)
        tracer.clear()
    assert names.count("serve.request") == 3
    assert metrics.counter("serve.requests_completed").value() == 3
