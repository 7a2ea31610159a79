"""The `benchmarks/sim_speed.py` serving sweep, in the port, on the grid.

Six staggered requests over 2 slots at the tiny serving config (vocab 64,
one layer, d_model 32, 8-bit planes), with the JAX package's params
carried over by `convert.py`: the port serving on the grid (recode auto,
``packed`` engine) must emit the JAX package's greedy tokens.  JAX's own
tests pin its grid bit-exact to its reference backend, so JAX runs the
reference backend here.
"""
import dataclasses

import jax
import numpy as np

from repro import configs as jax_configs
from repro.models import common as jax_cm
from repro.models import lm as jax_lm
from repro.serve import engine as jax_engine
from repro.serve.comefa_exec import GridLinearExecutor as JaxExecutor
from repro_torch import configs, convert
from repro_torch.models import common as cm
from repro_torch.serve import engine
from repro_torch.serve.comefa_exec import GridLinearExecutor

TINY = dict(vocab=64, n_layers=1, d_model=32, d_ff=64, n_heads=2,
            kv_heads=2, head_dim=16, dtype="float32")


def test_sim_speed_sweep_tokens_equal_jax():
    jcfg = dataclasses.replace(
        jax_cm.reduced(jax_configs.get("smollm-360m"), **TINY), quant_bits=8)
    params = jax_lm.init(jax.random.PRNGKey(0), jcfg)
    cfg = dataclasses.replace(cm.reduced(configs.get("smollm-360m"), **TINY),
                              quant_bits=8)
    model = convert.load(jax.tree.map(np.asarray, params), cfg, "cpu")

    def reqs(eng):
        return [eng.Request(np.arange(1, 2 + i % 3), 2 + (i * 2) % 5)
                for i in range(6)]

    want = jax_engine.serve_continuous(
        params, reqs(jax_engine), jcfg, slots=2, max_len=12,
        executor=JaxExecutor(slots=2, backend="reference"))
    ex = GridLinearExecutor(slots=2, recode="auto", engine="packed")
    stats = {}
    got = engine.serve_continuous(model, reqs(engine), slots=2, max_len=12,
                                  executor=ex, stats=stats)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert stats["occupancy"] >= 0.9
    assert ex.grid_cycles > 0
