"""The port's attention families held to the JAX package on the same params:
Gemma-2 (local/global alternation, attention and final softcaps),
Gemma-3 (5:1 local/global, qk-norm) and StarCoder2 (GQA, GELU).

JAX params go through `repro_torch.convert` in both stack layouts, with
and without 8-bit planes, and the same numpy-seeded inputs go through
both packages.  Every comparison is held within rtol 1e-4, atol 1e-5, as
in `tests/test_torch_model.py`: the same sums in other orders.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _families import (ATOL, assert_close, cfgs, decode_both, forward_both, pair,
                       tokens)
from repro.models import attention as jax_attn
from repro.serve import engine as jax_engine
from repro_torch import configs
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention, lm
from repro_torch.models import common as cm
from repro_torch.serve import engine

NAMES = ["gemma2-27b", "gemma3-27b", "starcoder2-7b"]

# decode cases: both index kinds on the listed layout, the scanned layout
# with a scalar index and 8-bit planes
DECODE = [(None, False, "scalar"), (None, False, "vector"),
          (8, False, "scalar"), (8, False, "vector"), (8, True, "scalar")]


@pytest.mark.parametrize("scan_layers", [False, True])
@pytest.mark.parametrize("quant_bits", [None, 8])
@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax(name, quant_bits, scan_layers):
    jcfg, params, model = pair(name, quant_bits, scan_layers)
    toks = tokens((2, 9), jcfg.vocab)
    got, want = forward_both(jcfg, params, model, toks)
    assert_close(got, want)
    last, _ = lm.forward(model, torch.as_tensor(toks), last_only=True)
    assert_close(last.numpy(), want[:, -1:])


@pytest.mark.parametrize("quant_bits,scan_layers,index", DECODE)
@pytest.mark.parametrize("name", NAMES)
def test_decode_steps_match_jax(name, quant_bits, scan_layers, index):
    """Nine decode steps at a scalar index (lockstep) or at per-row vector
    indices (row 1 one step behind, row 2 held at 0), then the caches,
    within an atol of 1e-5 times their largest entry (Gemma-3's qk-norm
    scales k to an RMS of 2, and a reordered sum ahead of the norm moves
    an entry by up to 1.5e-5)."""
    jcfg, params, model = pair(name, quant_bits, scan_layers)
    toks = tokens((3, 9), jcfg.vocab, seed=1)
    vector = index == "vector"

    def index_of(t):
        return np.array([t, max(t - 1, 0), 0]) if vector else t

    state, jstate = decode_both(jcfg, params, model, toks, 12, index_of,
                                assert_close, vector)
    if not scan_layers:
        flat = [s for grp in jstate["group_list"] for s in grp.values()] \
            + list(jstate["rem"])
        for mine, theirs in zip(state, flat):
            for k in ("k", "v"):
                want = np.asarray(theirs[k])
                assert_close(mine[k].numpy(), want,
                             atol=ATOL * np.abs(want).max())


@pytest.mark.parametrize("vector", [False, True])
@pytest.mark.parametrize("name", ["gemma2-27b", "gemma3-27b"])
def test_local_ring_past_a_wrap(name, vector):
    """Local layers with window 4 over 14 positions: each ring wraps three
    times, and with vector indices the rows sit at different ring
    phases; global layers keep every position."""
    jcfg, params, model = pair(name, 8, False, window=4)
    toks = tokens((3, 14), jcfg.vocab, seed=5)

    def index_of(t):
        return np.array([t, max(t - 3, 0), max(t - 6, 0)]) if vector else t

    state, _ = decode_both(jcfg, params, model, toks, 16, index_of,
                           assert_close, vector)
    rows = [s["k"].shape[1] for s in state]
    assert rows == [4 if k[0] == "local" else 16
                    for k in model.cfg.layer_kinds()]


_jax_attn_apply = jax.jit(jax_attn.apply,
                          static_argnames=("cfg", "kind", "prefix_len"))


@pytest.mark.parametrize("name,kind,s", [
    ("gemma2-27b", "global", 2048), ("gemma2-27b", "local", 2048),
    ("gemma3-27b", "global", 2048), ("gemma3-27b", "local", 2048),
    ("gemma2-27b", "global", 1100), ("gemma2-27b", "local", 1100)])
def test_chunked_attention_matches_jax(name, kind, s):
    """Past DENSE_MAX_SEQ: 512-row global chunks and banded window-sized
    local chunks at S = 2,048; at S = 1,100 neither splits evenly and both
    packages fall back to dense attention under one mask."""
    jcfg, params, model = pair(name, None, False)
    layer = [k[0] for k in model.cfg.layer_kinds()].index(kind)
    jp = params["stack"]["group_list"][0][f"l{layer}"]["mix"]
    x = np.random.default_rng(s).normal(size=(1, s, jcfg.d_model)).astype(
        np.float32)
    want = np.asarray(_jax_attn_apply(jp, jnp.asarray(x), cfg=jcfg,
                                      kind=kind))
    got = attention.apply(model.stack[layer].mix, torch.as_tensor(x),
                          model.cfg, kind=kind)
    assert_close(got.numpy(), want)


@pytest.mark.parametrize("kind,prefix_len", [
    ("global", 0), ("global", 40), ("local", 0), ("bidir", 0)])
def test_chunked_equals_dense_in_the_port(kind, prefix_len):
    """The port's chunks against its own dense attention under the same
    mask at S = 2,048 (a local chunk reads one window back, so a prefix
    is asked of global attention only)."""
    cfg = cfgs("gemma2-27b", None, False)[1]
    rng = np.random.default_rng(11)
    q, k, v = (torch.as_tensor(rng.normal(size=(1, 2048, h, cfg.hd)).astype(
        np.float32)) for h in (cfg.n_heads, cfg.kv_heads, cfg.kv_heads))
    got = attention._attn_chunked(q, k, v, cfg, kind=kind,
                                  prefix_len=prefix_len)
    mask = None if kind == "bidir" else attention.causal_mask(
        2048, "cpu", window=cfg.window if kind == "local" else 0,
        prefix_len=prefix_len)
    assert_close(got.numpy(), attention._sdpa(q, k, v, mask, cfg).numpy())


@pytest.mark.parametrize("window,prefix_len", [(0, 0), (4, 0), (0, 3),
                                               (5, 2)])
def test_causal_mask_matches_jax(window, prefix_len):
    want = np.asarray(jax_attn.causal_mask(9, window, prefix_len))
    got = attention.causal_mask(9, "cpu", window=window,
                                prefix_len=prefix_len)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind,max_len,rows", [
    ("local", 16, 4), ("local", 3, 3), ("global", 16, 16)])
def test_init_cache_rows(kind, max_len, rows):
    cfg = cfgs("gemma2-27b", None, False, window=4)[1]
    cache = attention.init_cache(cfg, 2, max_len, "cpu", kind=kind)
    assert tuple(cache["k"].shape) == (2, rows, cfg.kv_heads, cfg.hd)


def test_generate_greedy_equals_jax():
    """Gemma-3 (qk-norm, local and global layers) through both engines'
    `generate`."""
    jcfg, params, model = pair("gemma3-27b", 8, False)
    prompt = tokens((2, 4), jcfg.vocab, seed=6)
    want = np.asarray(jax_engine.generate(params, jnp.asarray(prompt), jcfg,
                                          steps=4, max_len=9))
    got = engine.generate(model, torch.as_tensor(prompt), steps=4,
                          max_len=9)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name,expect", [
    ("gemma2-27b", 46 * 7), ("gemma3-27b", 62 * 7),
    ("starcoder2-7b", 32 * 7), ("smollm-360m", 32 * 7)])
def test_full_depth_layers_and_packed_projections(name, expect):
    """Each config at its full depth and pattern (narrow widths, every
    projection still packed): layer kinds in order (Gemma-3's two
    remainder layers are local), qk-norm where asked, and the packed
    projections a decode call runs."""
    cfg = cm.reduced(configs.get(name), n_layers=configs.get(name).n_layers,
                     quant_bits=8)
    model = lm.init(torch.Generator().manual_seed(0), cfg, "cpu")
    kinds = [tuple(layer.kinds) for layer in model.stack]
    assert kinds == cfg.layer_kinds()
    assert lm.packed_projections(model) == expect
    assert hasattr(model.stack[0].mix, "qn") == cfg.qk_norm
    if name == "gemma3-27b":
        assert [k[0] for k in kinds[-3:]] == ["global", "local", "local"]


@pytest.mark.parametrize("name", NAMES)
def test_launcher_runs_each_family_on_cpu(name, capsys):
    launch_serve.main(["--arch", name, "--reduced", "--quant", "8",
                       "--device", "cpu", "--steps", "3"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "generated token ids:" and len(out) == 5


def test_launcher_refuses_an_unported_arch(capsys):
    """Every config of the JAX package runs; a name outside the registry
    is refused with a usage error that lists the ten."""
    with pytest.raises(SystemExit):
        launch_serve.main(["--arch", "mixtral-8x22b", "--device", "cpu"])
    err = capsys.readouterr().err
    assert "the port runs" in err and "mixtral-8x7b" in err


def test_reduced_configs_match_the_jax_package():
    for name in NAMES:
        jcfg, cfg = cfgs(name, 8, False)
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
