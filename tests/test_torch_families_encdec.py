"""The port's encoder-decoder and prefix-LM families held to the JAX
package on the same params: Whisper-small (a bidirectional encoder over
frame embeddings; decoder layers of causal self-attention, then
cross-attention over the encoder's output; GELU) and PaliGemma-3B
(patch embeddings ahead of the tokens, attended bidirectionally; MQA,
head_dim 256).

JAX params go through `repro_torch.convert` in both stack layouts, with
and without 8-bit planes, and the same numpy-seeded inputs (tokens, and
frame or patch embeddings standing in for the frontends) go through both
packages.  Every comparison is held within rtol 1e-4, atol 1e-5: the
same sums in other orders.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _families import (assert_close, cfgs, decode_both, forward_both,
                       frames, jax_encode, pair, tokens)
from repro.models import attention as jax_attn
from repro.serve import engine as jax_engine
from repro_torch import configs
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention
from repro_torch.models import common as cm
from repro_torch.models import lm
from repro_torch.serve import engine

NAMES = ["whisper-small", "paligemma-3b"]

DECODE = [(None, False, "scalar"), (None, False, "vector"),
          (8, False, "scalar"), (8, False, "vector"), (8, True, "scalar")]


def _inputs(cfg, batch, seed=0):
    """Whisper's frame embeddings, or PaliGemma's patch embeddings."""
    x = frames(cfg, batch, seed)
    if cfg.family == "encdec":
        return {"enc_inputs": x}
    return {"prefix_embeddings": x}


@pytest.mark.parametrize("scan_layers", [False, True])
@pytest.mark.parametrize("quant_bits", [None, 8])
@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax(name, quant_bits, scan_layers):
    """Whisper's logits over its encoded frames; PaliGemma's over the
    tokens after 8 patch embeddings (their positions sliced off)."""
    jcfg, params, model = pair(name, quant_bits, scan_layers)
    toks = tokens((2, 9), jcfg.vocab)
    inputs = _inputs(jcfg, 2)
    got, want = forward_both(jcfg, params, model, toks, **inputs)
    assert got.shape == (2, 9, jcfg.vocab)
    assert_close(got, want)
    last, aux = lm.forward(model, torch.as_tensor(toks), last_only=True,
                           **{k: torch.as_tensor(v)
                              for k, v in inputs.items()})
    assert_close(last.numpy(), want[:, -1:])
    assert float(aux) == 0.0


@pytest.mark.parametrize("quant_bits,scan_layers,index", DECODE)
@pytest.mark.parametrize("name", NAMES)
def test_decode_steps_match_jax(name, quant_bits, scan_layers, index):
    """Nine decode steps at a scalar or per-row vector index, Whisper's
    reading its encoded frames at every step."""
    jcfg, params, model = pair(name, quant_bits, scan_layers)
    toks = tokens((3, 9), jcfg.vocab, seed=1)
    vector = index == "vector"

    def index_of(t):
        return np.array([t, max(t - 1, 0), 0]) if vector else t

    enc = frames(jcfg, 3, seed=4) if jcfg.family == "encdec" else None
    state, _ = decode_both(jcfg, params, model, toks, 12, index_of,
                           assert_close, vector, enc_inputs=enc)
    # a cross_global layer keeps its self-attention cache only
    assert all(set(s) == {"k", "v"} and s["k"].shape[1] == 12
               for s in state)


@pytest.mark.parametrize("scan_layers", [False, True])
@pytest.mark.parametrize("quant_bits", [None, 8])
def test_encode_matches_jax(quant_bits, scan_layers):
    jcfg, params, model = pair("whisper-small", quant_bits, scan_layers)
    enc = frames(jcfg, 2, seed=5)
    want = np.asarray(jax_encode(params, jnp.asarray(enc), cfg=jcfg))
    got = lm.encode(model, torch.as_tensor(enc))
    assert_close(got.numpy(), want)


_jax_cross = jax.jit(jax_attn.apply_cross, static_argnames=("cfg",))
_jax_apply = jax.jit(jax_attn.apply, static_argnames=("cfg", "kind",
                                                      "prefix_len"))


@pytest.mark.parametrize("quant_bits", [None, 8])
def test_apply_cross_matches_jax(quant_bits):
    """Queries from 5 decoder positions over 8 context rows: every key
    visible, no RoPE."""
    jcfg, params, model = pair("whisper-small", quant_bits, False)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 5, jcfg.d_model)).astype(np.float32)
    ctx = rng.normal(size=(2, 8, jcfg.d_model)).astype(np.float32)
    jp = params["stack"]["group_list"][0]["l0"]["cross"]
    want = np.asarray(_jax_cross(jp, jnp.asarray(x), jnp.asarray(ctx),
                                 cfg=jcfg))
    got = attention.apply_cross(model.stack[0].cross, torch.as_tensor(x),
                                torch.as_tensor(ctx), model.cfg)
    assert_close(got.numpy(), want)


@pytest.mark.parametrize("s", [12, 2048])
def test_bidir_attention_matches_jax(s):
    """An encoder layer's attention, dense with no mask (S = 12) and in
    512-row chunks past DENSE_MAX_SEQ (S = 2,048)."""
    jcfg, params, model = pair("whisper-small", None, False)
    jp = params["enc_stack"]["group_list"][0]["l0"]["mix"]
    x = np.random.default_rng(s).normal(size=(1, s, jcfg.d_model)).astype(
        np.float32)
    want = np.asarray(_jax_apply(jp, jnp.asarray(x), cfg=jcfg, kind="bidir"))
    got = attention.apply(model.enc_stack[0].mix, torch.as_tensor(x),
                          model.cfg, kind="bidir")
    assert_close(got.numpy(), want)


def test_prefix_is_causal_without_prefix_lm():
    """``prefix_len`` reaches attention only with ``cfg.prefix_lm``: the
    same prefix under a causal mask when it is off, in both packages,
    and other logits than with it on."""
    jcfg, params, model = pair("paligemma-3b", None, False, prefix_lm=False)
    toks = tokens((2, 6), jcfg.vocab, seed=7)
    inputs = _inputs(jcfg, 2, seed=8)
    got, want = forward_both(jcfg, params, model, toks, **inputs)
    assert_close(got, want)
    on = dataclasses.replace(model.cfg, prefix_lm=True)
    model.cfg = on
    bidir, _ = lm.forward(model, torch.as_tensor(toks),
                          **{k: torch.as_tensor(v)
                             for k, v in inputs.items()})
    assert np.abs(bidir.numpy() - got).max() > 1e-3


def test_missing_context_raises():
    _, _, model = pair("whisper-small", None, False)
    toks = torch.zeros((1, 2), dtype=torch.long)
    with pytest.raises(ValueError, match="enc_inputs"):
        lm.forward(model, toks)
    state = lm.decode_state_init(model.cfg, 1, 4, "cpu")
    with pytest.raises(ValueError, match="ctx"):
        lm.decode_step(model, toks[:, :1], state, 0)


# ---------------------------------------------------------------------------
# serving, launcher, configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_generate_greedy_equals_jax(name):
    """Greedy tokens of both engines; Whisper encodes its frames once."""
    jcfg, params, model = pair(name, 8, False)
    prompt = tokens((2, 4), jcfg.vocab, seed=6)
    enc = frames(jcfg, 2, seed=3) if jcfg.family == "encdec" else None
    want = np.asarray(jax_engine.generate(
        params, jnp.asarray(prompt), jcfg, steps=4, max_len=9,
        enc_inputs=None if enc is None else jnp.asarray(enc)))
    got = engine.generate(model, torch.as_tensor(prompt), steps=4,
                          max_len=9, enc_inputs=enc)
    np.testing.assert_array_equal(got.numpy(), want)


def test_prefill_with_enc_inputs_matches_forward():
    _, _, model = pair("whisper-small", 8, False)
    toks = torch.as_tensor(tokens((2, 5), model.cfg.vocab, seed=2))
    enc = torch.as_tensor(frames(model.cfg, 2, seed=2))
    logits, states = engine.prefill(model, toks, 8, enc_inputs=enc)
    want, _ = lm.forward(model, toks, enc_inputs=enc)
    np.testing.assert_array_equal(logits.numpy(), want[:, -1:].numpy())
    assert len(states) == model.cfg.n_layers


def test_serve_continuous_refuses_an_encoder_decoder():
    _, _, model = pair("whisper-small", 8, False)
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        engine.serve_continuous(model, [engine.Request([1, 2], 2)], slots=2,
                                max_len=6)


@pytest.mark.parametrize("name,decoder,encoder", [
    ("whisper-small", 132, 84), ("paligemma-3b", 126, 0)])
def test_full_depth_layers_and_packed_projections(name, decoder, encoder):
    """Full depth at narrow widths: Whisper's 12 decoder layers pack 11
    projections each (self-attention, cross-attention, MLP) and its 12
    encoder layers 7, counted apart because one `generate` encodes once;
    PaliGemma's 18 layers 7 each."""
    full = configs.get(name)
    cfg = cm.reduced(full, n_layers=full.n_layers,
                     enc_layers=full.enc_layers, quant_bits=8)
    model = lm.init(torch.Generator().manual_seed(0), cfg, "cpu")
    assert [tuple(layer.kinds) for layer in model.stack] == \
        cfg.layer_kinds()
    assert lm.packed_projections(model) == decoder
    assert lm.packed_projections(model, encoder=True) == encoder
    if encoder:
        assert [tuple(layer.kinds) for layer in model.enc_stack] == \
            [("bidir", "mlp")] * full.enc_layers
        assert hasattr(model.stack[0], "cross") and \
            hasattr(model.stack[0], "nc")


@pytest.mark.parametrize("name", NAMES)
def test_launcher_runs_each_family_on_cpu(name, capsys):
    launch_serve.main(["--arch", name, "--reduced", "--quant", "8",
                       "--device", "cpu", "--steps", "3"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "generated token ids:" and len(out) == 5


def test_reduced_configs_match_the_jax_package():
    for name in NAMES:
        jcfg, cfg = cfgs(name, 8, False)
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
