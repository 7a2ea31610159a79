"""The port's reduced SmolLM held to the JAX package on the same params.

JAX params are initialised once per configuration, carried across with
`repro_torch.convert` (both JAX stack layouts, and a remainder layer),
and the same numpy-seeded tokens go through both packages.  Logits are
compared in f32 within rtol 1e-4, atol 1e-5: the two packages take the
same sums in different orders (the port's bit-plane path applies the
scale after the sum, the JAX XLA branch before it).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import common as jax_cm
from repro.models import lm as jax_lm
from repro_torch import configs, convert
from repro_torch.models import attention
from repro_torch.models import common as cm
from repro_torch.models import lm

RTOL, ATOL = 1e-4, 1e-5


def _cfgs(quant_bits, scan_layers, **over):
    kw = dict(n_layers=2, quant_bits=quant_bits, scan_layers=scan_layers)
    kw.update(over)
    return (jax_cm.reduced(jax_configs.get("smollm-360m"), **kw),
            cm.reduced(configs.get("smollm-360m"), **kw))


def _pair(quant_bits, scan_layers, **over):
    jcfg, cfg = _cfgs(quant_bits, scan_layers, **over)
    params = jax_lm.init(jax.random.PRNGKey(0), jcfg)
    model = convert.load(jax.tree.map(np.asarray, params), cfg, "cpu")
    return jcfg, params, model


def _tokens(shape, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


@pytest.mark.parametrize("scan_layers", [False, True])
@pytest.mark.parametrize("quant_bits", [None, 8])
def test_forward_matches_jax(quant_bits, scan_layers):
    jcfg, params, model = _pair(quant_bits, scan_layers)
    toks = _tokens((2, 9), jcfg.vocab)
    want = np.asarray(jax_lm.forward(params, jnp.asarray(toks), jcfg)[0])
    got = lm.forward(model, torch.as_tensor(toks))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    last = lm.forward(model, torch.as_tensor(toks), last_only=True)
    np.testing.assert_allclose(last.numpy(), want[:, -1:], rtol=RTOL,
                               atol=ATOL)


def test_convert_reads_remainder_layers():
    """A two-kind pattern over three layers: one scanned group + `rem`."""
    pattern = (("global", "mlp"), ("global", "mlp"))
    jcfg, params, model = _pair(8, True, n_layers=3, pattern=pattern)
    assert len(params["stack"]["rem"]) == 1 and len(model.stack) == 3
    toks = _tokens((1, 6), jcfg.vocab, seed=3)
    want = np.asarray(jax_lm.forward(params, jnp.asarray(toks), jcfg)[0])
    got = lm.forward(model, torch.as_tensor(toks))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_convert_keeps_packed_bits():
    jcfg, params, model = _pair(8, False)
    jax_wq = np.asarray(params["stack"]["group_list"][1]["l0"]["mix"]["wq"]
                        ["packed"])
    assert jax_wq.dtype == np.uint32
    mine = model.stack[1].mix.wq.packed
    assert mine.dtype == torch.int32
    np.testing.assert_array_equal(mine.numpy().view(np.uint32), jax_wq)


@pytest.mark.parametrize("vector_index", [False, True])
@pytest.mark.parametrize("quant_bits", [None, 8])
def test_decode_step_matches_jax(quant_bits, vector_index):
    """Prime a cache, then one decode step at a scalar index (lockstep) or
    at a per-row vector index (each row writes and reads its own slot)."""
    jcfg, params, model = _pair(quant_bits, False)
    b, max_len = 3, 12
    toks = _tokens((b, 5), jcfg.vocab, seed=1)
    jstate = jax_lm.decode_state_init(jcfg, b, max_len)
    state = lm.decode_state_init(model.cfg, b, max_len, "cpu")
    for t in range(toks.shape[1]):
        idx = np.full((b,), t, np.int32)
        if vector_index:          # rows run at their own positions
            idx = np.minimum(idx, np.array([t, max(t - 1, 0), 0]))
        tok = toks[:, t:t + 1]
        jl, jstate = jax_lm.decode_step(
            params, jnp.asarray(tok), jstate,
            jnp.asarray(idx) if vector_index else jnp.int32(t), jcfg)
        tl, state = lm.decode_step(
            model, torch.as_tensor(tok), state,
            torch.as_tensor(idx) if vector_index else t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                                   atol=ATOL)
    for mine, theirs in zip(state, jstate["group_list"]):
        np.testing.assert_allclose(mine["k"].numpy(),
                                   np.asarray(theirs["l0"]["k"]),
                                   rtol=RTOL, atol=ATOL)


def test_bf16_forward_close_to_jax():
    """The working dtype of the full config: bf16 activations round at
    other places in the two frameworks, so the bound is bf16's."""
    jcfg, params, model = _pair(8, False, dtype="bfloat16")
    assert model.embed["e"].dtype == torch.bfloat16
    toks = _tokens((2, 6), jcfg.vocab, seed=2)
    want = np.asarray(jax_lm.forward(params, jnp.asarray(toks), jcfg)[0])
    got = lm.forward(model, torch.as_tensor(toks)).numpy()
    assert np.abs(got - want).max() <= 0.05 * np.abs(want).max()


def test_embed_scale_rounds_in_embedding_dtype():
    """sqrt(960) is rounded to bf16 (31.0) before it scales embeddings."""
    cfg = dataclasses.replace(configs.get("smollm-360m"), n_layers=1,
                              vocab=8)
    model = lm.init(torch.Generator().manual_seed(0), cfg, "cpu")
    e = model.embed["e"]
    x = lm._embed_tokens(model, torch.tensor([[3]]), cfg)
    np.testing.assert_array_equal(x[0, 0].float().numpy(),
                                  (e[3] * 31.0).float().numpy())


def test_gqa_maps_query_head_to_kv_head_by_floor_division():
    """Query head h reads KV head h // (Hq // Hkv) (15 -> 5 for SmolLM):
    a value that is nonzero only in KV head j shows up only in query
    heads 3j .. 3j+2."""
    cfg = dataclasses.replace(configs.get("smollm-360m"), n_layers=1)
    q = torch.zeros((1, 1, 15, 4))
    k = torch.zeros((1, 2, 5, 4))
    v = torch.zeros((1, 2, 5, 4))
    v[:, :, 1] = 1.0
    out = attention._sdpa(q, k, v, None, cfg)
    assert out.shape == (1, 1, 15, 4)
    hot = out[0, 0].abs().sum(-1).nonzero().flatten().tolist()
    assert hot == [3, 4, 5]


def test_unported_family_raises():
    cfg = dataclasses.replace(configs.get("smollm-360m"),
                              pattern=(("local", "mlp"),), n_layers=1)
    with pytest.raises(NotImplementedError):
        lm.init(torch.Generator().manual_seed(0), cfg, "cpu")
