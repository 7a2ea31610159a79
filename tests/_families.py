"""Shared set-up of the family parity tests (`test_torch_families_*.py`).

A reduced config of the JAX package and the port's same config, JAX
params initialised once per (config, quant_bits) in the
``scan_layers=False`` layout and restacked into the ``scan_layers=True``
layout (the group list's groups on a leading layer axis), so both JAX
layouts go through `repro_torch.convert` with the same numbers.  The JAX
forward and decode step are jitted (the config static): eager `lax.scan`
recompiles its body at every call, and eager layers dispatch op by op.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jax_configs
from repro.models import common as jax_cm
from repro.models import lm as jax_lm
from repro_torch import configs, convert
from repro_torch.models import common as cm
from repro_torch.models import lm

RTOL, ATOL = 1e-4, 1e-5

# depth of each reduced config: one pattern period, plus the remainder
# layers where the full config has some (RecurrentGemma's 26 = 8 x 3 + 2,
# Gemma-3's 62 = 10 x 6 + 2, Gemma-2's 46 = 23 x 2: one extra here); two
# layers where the pattern is one layer long, so that a layer reads
# another's output (Whisper: two decoder and, by `reduced`, two encoder
# layers)
DEPTH = {"smollm-360m": 2, "recurrentgemma-2b": 5, "xlstm-1.3b": 8,
         "gemma2-27b": 3, "gemma3-27b": 8, "starcoder2-7b": 2,
         "mixtral-8x7b": 2, "arctic-480b": 2, "whisper-small": 2,
         "paligemma-3b": 2}

jax_forward = jax.jit(jax_lm.forward, static_argnames=("cfg", "last_only"))
jax_decode = jax.jit(jax_lm.decode_step, static_argnames=("cfg",))
jax_encode = jax.jit(jax_lm.encode, static_argnames=("cfg",))


def cfgs(name, quant_bits, scan_layers, **over):
    kw = dict(n_layers=DEPTH[name], quant_bits=quant_bits,
              scan_layers=scan_layers)
    kw.update(over)
    return (jax_cm.reduced(jax_configs.get(name), **kw),
            cm.reduced(configs.get(name), **kw))


def _restack(params):
    stack = params["stack"]
    groups = jax.tree.map(lambda *xs: jnp.stack(xs), *stack["group_list"])
    return {**params, "stack": {"groups": groups, "rem": stack["rem"]}}


@functools.lru_cache(maxsize=None)
def _params(name, quant_bits, over):
    jcfg, _ = cfgs(name, quant_bits, False, **dict(over))
    return jax_lm.init(jax.random.PRNGKey(0), jcfg)


def pair(name, quant_bits, scan_layers, **over):
    """(JAX config, JAX params, port model on the CPU) for `name`."""
    jcfg, cfg = cfgs(name, quant_bits, scan_layers, **over)
    params = _params(name, quant_bits, tuple(sorted(over.items())))
    if scan_layers:
        params = _restack(params)
        assert "groups" in params["stack"]
    model = convert.load(jax.tree.map(np.asarray, params), cfg, "cpu")
    return jcfg, params, model


def tokens(shape, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def forward_aux_both(jcfg, params, model, toks, **inputs):
    """((logits, aux) of the port, (logits, aux) of JAX) for tokens and
    the numpy `inputs` (``enc_inputs``, ``prefix_embeddings``)."""
    want = jax_forward(params, jnp.asarray(toks), cfg=jcfg,
                       **{k: jnp.asarray(v) for k, v in inputs.items()})
    got = lm.forward(model, torch.as_tensor(toks),
                     **{k: torch.as_tensor(v) for k, v in inputs.items()})
    return ((got[0].numpy(), float(got[1])),
            (np.asarray(want[0]), float(want[1])))


def forward_both(jcfg, params, model, toks, **inputs):
    (got, _), (want, _) = forward_aux_both(jcfg, params, model, toks,
                                           **inputs)
    return got, want


def frames(cfg, batch, seed=0):
    """Seeded encoder inputs [batch, frontend_len, d_model] f32 (the
    stand-in for an audio or vision frontend's output)."""
    return np.random.default_rng(seed).normal(
        size=(batch, cfg.frontend_len, cfg.d_model)).astype(np.float32)


def decode_both(jcfg, params, model, toks, max_len, index_of, check,
                vector=False, enc_inputs=None):
    """Decode `toks` [B, T] one column a step through both packages, the
    position of step t being ``index_of(t)``: a [B] vector, or with
    `vector` False a scalar, which the port takes as a Python int.  The
    JAX step always gets the [B] vector (its first act is to broadcast a
    scalar index to one), so both index kinds share one compile.  An
    encoder-decoder encodes `enc_inputs` once in each package and every
    step reads its own package's context.  `check(got, want)` holds each
    step's logits."""
    b = toks.shape[0]
    jctx = ctx = None
    if enc_inputs is not None:
        jctx = jax_encode(params, jnp.asarray(enc_inputs), cfg=jcfg)
        ctx = lm.encode(model, torch.as_tensor(enc_inputs))
    jstate = jax_lm.decode_state_init(jcfg, b, max_len)
    state = lm.decode_state_init(model.cfg, b, max_len, "cpu")
    for t in range(toks.shape[1]):
        idx = index_of(t)
        tok = toks[:, t:t + 1]
        jl, jstate = jax_decode(
            params, jnp.asarray(tok), jstate,
            jnp.broadcast_to(jnp.asarray(idx, jnp.int32), (b,)), cfg=jcfg,
            ctx=jctx)
        tl, state = lm.decode_step(
            model, torch.as_tensor(tok),
            state, torch.as_tensor(idx) if vector else int(idx), ctx=ctx)
        check(tl.numpy(), np.asarray(jl))
    return state, jstate


def assert_close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
