"""The grid executor on every family whose projections are packed.

`serve/comefa_exec.GridLinearExecutor` is held on SmolLM by
tests/test_torch_serve_grid.py.  Here each other family's reduced config
(8-bit planes) runs one JAX decode sweep (`generate`, one new token)
whose hooked calls are recorded: local attention (Gemma-2), the
recurrent mixers (RecurrentGemma's RG-LRU, xLSTM's mLSTM and sLSTM),
cross-attention (Whisper, with seeded frame embeddings), the prefix LM
(PaliGemma) and Arctic's MoE layers (their attention and ``ffn_dense``,
the packed projections beside the experts).  Every distinct projection
shape then goes through the port's grid executor (``packed`` engine),
its ``reference`` backend and the JAX executor, with the same
activations and params: the three outputs are equal, bit for bit, in
every recode mode the parametrisation names.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import common as jax_cm
from repro.models import lm as jax_lm
from repro.serve import engine as jax_engine
from repro.serve.comefa_exec import GridLinearExecutor as JaxExecutor
from repro_torch.serve.comefa_exec import GridLinearExecutor

FAMILIES = ("gemma2-27b", "recurrentgemma-2b", "xlstm-1.3b",
            "whisper-small", "paligemma-3b", "arctic-480b")
# narrow widths keep the bit-level grid quick on the CPU
NARROW = dict(vocab=64, d_model=32, d_ff=64, n_heads=2, head_dim=16,
              dtype="float32", quant_bits=8)


def _jax_cfg(name):
    base = jax_configs.get(name)
    cfg = jax_cm.reduced(base, **NARROW)
    return dataclasses.replace(cfg, kv_heads=min(cfg.kv_heads, 2))


@pytest.fixture(scope="module", params=FAMILIES)
def recorded(request):
    """(family, the first hooked call of each distinct projection shape of
    one JAX decode sweep, and the layer kinds the config runs)."""
    cfg = _jax_cfg(request.param)
    params = jax_lm.init(jax.random.PRNGKey(0), cfg)
    seen = {}

    def record(p, x2, bits):
        key = (tuple(np.asarray(p["packed"]).shape), bits)
        seen.setdefault(key, (p, np.asarray(x2), bits))
        return None                  # fall through to the JAX kernel path

    enc = None
    if cfg.family == "encdec":
        enc = np.random.default_rng(1).standard_normal(
            (2, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    prompt = np.arange(4).reshape(2, 2) % cfg.vocab
    jax_engine.generate(params, prompt, cfg, steps=1, max_len=6,
                        enc_inputs=enc, executor=record)
    return request.param, list(seen.values()), cfg.layer_kinds()


def _port_params(p):
    return {"packed": torch.from_numpy(
                np.asarray(p["packed"]).view(np.int32).copy()),
            "scale": torch.from_numpy(np.asarray(p["scale"]).copy())}


def test_every_packed_family_hooks_its_projections(recorded):
    name, calls, kinds = recorded
    print(f"{name}: {len(calls)} projection shapes, layers {kinds}")
    assert len(calls) >= 2
    if name == "arctic-480b":
        assert ("global", "moe_dense") in kinds


@pytest.mark.parametrize("recode", [None, "booth", "auto"])
def test_grid_executor_equals_reference_and_jax(recorded, recode):
    name, calls, _ = recorded
    x_bits = 4
    jax_ex = JaxExecutor(slots=2, x_bits=x_bits, recode=recode)
    grid = GridLinearExecutor(slots=2, x_bits=x_bits, recode=recode,
                              engine="packed")
    ref = GridLinearExecutor(slots=2, x_bits=x_bits, backend="reference")
    for p, x2, bits in calls:
        want = np.asarray(jax_ex(p, x2, bits))
        pp, xt = _port_params(p), torch.tensor(x2)
        got = grid(pp, xt, bits)
        assert torch.equal(got, ref(pp, xt, bits)), (name, x2.shape)
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"{name} {x2.shape}")
    assert grid.grid_cycles > 0
