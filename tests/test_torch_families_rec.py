"""The port's recurrent families held to the JAX package on the same params:
RecurrentGemma (RG-LRU + local attention with MQA) and xLSTM (mLSTM +
sLSTM, no FFN, untied head).

JAX params go through `repro_torch.convert` in both stack layouts, with
and without 8-bit planes, and the same numpy-seeded inputs go through
both packages.  Tolerances are those of `tests/test_torch_model.py` (rtol
1e-4, atol 1e-5: the same sums in other orders) except where a test says
otherwise:

* xLSTM's logits are held within rtol 1e-4 and an atol of 1e-3 times the
  largest logit.  Its decode output divides by the mLSTM normalizer
  |q . n|, a sum that cancels, and normalizes the quotient per head, so
  one reordered f32 sum shows at about 1e-5 of the largest logit after
  one step (measured against the JAX package: at most 8e-5 of it over
  nine steps, 1e-5 for the forward).
* The RG-LRU recurrence is a log2(S)-step (Hillis-Steele) scan here and
  `jax.lax.associative_scan` there: the same products in another tree,
  inside the default tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _families import (RTOL, ATOL, assert_close, cfgs, decode_both,
                       forward_both, pair, tokens)
from repro.models import recurrent as jax_rec
from repro.serve import engine as jax_engine
from repro_torch import configs, convert
from repro_torch.launch import serve as launch_serve
from repro_torch.models import common as cm
from repro_torch.models import lm, recurrent
from repro_torch.serve import engine

NAMES = ["recurrentgemma-2b", "xlstm-1.3b"]


def _tol(name, want):
    if name == "xlstm-1.3b":
        return dict(rtol=RTOL, atol=1e-3 * np.abs(want).max())
    return dict(rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("scan_layers", [False, True])
@pytest.mark.parametrize("quant_bits", [None, 8])
@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax(name, quant_bits, scan_layers):
    jcfg, params, model = pair(name, quant_bits, scan_layers)
    got, want = forward_both(jcfg, params, model,
                             tokens((2, 9), jcfg.vocab))
    assert_close(got, want, **_tol(name, want))
    last = lm.forward(model, torch.as_tensor(tokens((2, 9), jcfg.vocab)),
                      last_only=True)[0].numpy()
    assert_close(last, want[:, -1:], **_tol(name, want))


@pytest.mark.parametrize("scan_layers,index", [
    (False, "scalar"), (False, "vector"), (True, "scalar")])
@pytest.mark.parametrize("quant_bits", [None, 8])
@pytest.mark.parametrize("name", NAMES)
def test_decode_steps_match_jax(name, quant_bits, scan_layers, index):
    """Nine decode steps at a scalar index (lockstep) or at per-row vector
    indices (row 1 one step behind, row 2 held at 0), then the states."""
    jcfg, params, model = pair(name, quant_bits, scan_layers)
    toks = tokens((3, 9), jcfg.vocab, seed=1)
    vector = index == "vector"

    def index_of(t):
        return np.array([t, max(t - 1, 0), 0]) if vector else t

    state, jstate = decode_both(
        jcfg, params, model, toks, 12, index_of,
        lambda g, w: assert_close(g, w, **_tol(name, w)), vector)
    if not scan_layers:
        flat = [s for grp in jstate["group_list"] for s in grp.values()] \
            + list(jstate["rem"])
        for mine, theirs in zip(state, flat):
            assert mine.keys() == theirs.keys()
            for k in mine:
                want = np.asarray(theirs[k])
                assert_close(mine[k].numpy(), want,
                             **_tol(name, np.where(want < -1e29, 0, want)))


@pytest.mark.parametrize("vector", [False, True])
def test_local_ring_past_a_wrap(vector):
    """RecurrentGemma's local layer with window 4 over 14 positions: the
    ring wraps three times; with vector indices the rows sit at different
    ring phases."""
    jcfg, params, model = pair("recurrentgemma-2b", 8, False, window=4)
    toks = tokens((3, 14), jcfg.vocab, seed=5)

    def index_of(t):
        return np.array([t, max(t - 3, 0), max(t - 6, 0)]) if vector else t

    state, _ = decode_both(jcfg, params, model, toks, 16, index_of,
                           assert_close, vector)
    assert state[2]["k"].shape[1] == 4           # the ring keeps 4 rows


@pytest.mark.parametrize("name", NAMES)
def test_serve_continuous_greedy_equals_jax(name):
    """Four requests over two slots, so slots are reused: the recurrent
    rows must restart from a fresh state at each admission."""
    jcfg, params, model = pair(name, 8, False)
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(0, jcfg.vocab, int(rng.integers(1, 3))).astype(
        np.int32), int(rng.integers(2, 4))) for _ in range(4)]
    jstats, stats = {}, {}
    want = jax_engine.serve_continuous(
        params, [jax_engine.Request(p, s) for p, s in reqs], jcfg, slots=2,
        max_len=10, stats=jstats)
    got = engine.serve_continuous(
        model, [engine.Request(p, s) for p, s in reqs], slots=2, max_len=10,
        stats=stats)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert stats == jstats and stats["steps"] < sum(
        len(p) + s - 1 for p, s in reqs)


@pytest.mark.parametrize("name", NAMES)
def test_generate_greedy_equals_jax(name):
    jcfg, params, model = pair(name, None, False)
    prompt = tokens((2, 4), jcfg.vocab, seed=6)
    want = np.asarray(jax_engine.generate(params, jnp.asarray(prompt), jcfg,
                                          steps=4, max_len=9))
    got = engine.generate(model, torch.as_tensor(prompt), steps=4,
                          max_len=9)
    np.testing.assert_array_equal(got.numpy(), want)


def test_bf16_forward_close_to_jax():
    """RecurrentGemma in the full configs' dtype: bf16 activations round at
    other places in the two frameworks (and RG-LRU's wr/wi and the conv
    tail are bf16), so the bound is bf16's."""
    jcfg, params, model = pair("recurrentgemma-2b", 8, False,
                               dtype="bfloat16")
    got, want = forward_both(jcfg, params, model,
                             tokens((2, 6), jcfg.vocab, seed=2))
    assert np.abs(got - want).max() <= 0.05 * np.abs(want).max()


def test_xlstm_bf16_no_further_from_f32_than_jax():
    """xLSTM in bf16 is far from its f32 self in both packages: the
    exponential gates and the normalizer amplify bf16 rounding, so the
    5% bound of the RecurrentGemma test does not hold for either.  The
    port's bf16 logits are held to be no further from the f32 logits of
    the same params than the JAX package's are."""
    jcfg, params, model = pair("xlstm-1.3b", 8, False, dtype="bfloat16")
    toks = tokens((2, 6), jcfg.vocab, seed=2)
    got, want = forward_both(jcfg, params, model, toks)
    f32 = {"bfloat16": np.float32}
    p32 = jax.tree.map(lambda a: np.asarray(a).astype(
        f32.get(np.asarray(a).dtype.name, np.asarray(a).dtype)), params)
    _, cfg32 = cfgs("xlstm-1.3b", 8, False)
    ref = lm.forward(convert.load(p32, cfg32, "cpu"),
                     torch.as_tensor(toks))[0].numpy()
    assert np.abs(got - ref).max() <= np.abs(want - ref).max()


# ---------------------------------------------------------------------------
# the mixers alone
# ---------------------------------------------------------------------------

mlstm_apply = jax.jit(jax_rec.mlstm_apply, static_argnames=("cfg",))
slstm_apply = jax.jit(jax_rec.slstm_apply,
                      static_argnames=("cfg", "return_state"))
rglru_apply = jax.jit(jax_rec.rglru_apply,
                      static_argnames=("cfg", "return_state"))


def _x(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


def _mixer(name, layer, quant_bits=None):
    jcfg, params, model = pair(name, quant_bits, False)
    jp = params["stack"]["group_list"][0][f"l{layer}"]["mix"]
    return jcfg, jp, model.cfg, model.stack[layer].mix


def test_mlstm_two_chunks_match_jax():
    """S = 512 takes two chunks of 256 and the cross-chunk state scan.
    Held within rtol 1e-4 and atol 1e-4 times the largest output (the
    normalizer's cancelling sum, as in the module docstring)."""
    jcfg, jp, cfg, tp = _mixer("xlstm-1.3b", 0)
    x = _x((2, 512, cfg.d_model), 0)
    want = np.asarray(mlstm_apply(jp, jnp.asarray(x), cfg=jcfg))
    got = recurrent.mlstm_apply(tp, torch.as_tensor(x), cfg).numpy()
    assert_close(got, want, atol=1e-4 * np.abs(want).max())


def test_mlstm_uneven_length_raises_like_jax():
    jcfg, jp, cfg, tp = _mixer("xlstm-1.3b", 0)
    x = _x((1, 513, cfg.d_model), 1)
    with pytest.raises(TypeError):
        jax_rec.mlstm_apply(jp, jnp.asarray(x), jcfg)
    with pytest.raises(RuntimeError):
        recurrent.mlstm_apply(tp, torch.as_tensor(x), cfg)


def test_mlstm_chunkwise_equals_its_recurrence():
    """The port's two forms of one mLSTM: the chunkwise forward over 40
    tokens and 40 token-recurrent decode steps (f32; same tolerance as
    the two-chunk test)."""
    _, _, cfg, tp = _mixer("xlstm-1.3b", 0)
    x = torch.as_tensor(_x((2, 40, cfg.d_model), 2))
    full = recurrent.mlstm_apply(tp, x, cfg)
    state = recurrent.mlstm_state_init(cfg, 2, "cpu")
    steps = [recurrent.mlstm_decode(tp, x[:, t:t + 1], state, cfg)[0]
             for t in range(40)]
    want = full.numpy()
    assert_close(torch.cat(steps, 1).numpy(), want,
                 atol=1e-4 * np.abs(want).max())


def test_slstm_with_state_matches_jax():
    """The sequence form with a carried state and `return_state`."""
    jcfg, jp, cfg, tp = _mixer("xlstm-1.3b", 7, quant_bits=8)
    x1, x2 = _x((2, 5, cfg.d_model), 3), _x((2, 4, cfg.d_model), 4)
    jy, js = slstm_apply(jp, jnp.asarray(x1), cfg=jcfg, return_state=True)
    jy2 = slstm_apply(jp, jnp.asarray(x2), cfg=jcfg, state=js)
    y, st = recurrent.slstm_apply(tp, torch.as_tensor(x1), cfg,
                                  return_state=True)
    y2 = recurrent.slstm_apply(tp, torch.as_tensor(x2), cfg, state=st)
    assert_close(y.numpy(), np.asarray(jy))
    assert_close(y2.numpy(), np.asarray(jy2))
    for k in ("c", "n", "h", "m"):
        assert_close(st[k].numpy(), np.asarray(js[k]))


def test_slstm_state_tensors_are_distinct():
    """The JAX init builds c, n and h from one zeros array; the port
    updates states in place, so each must be its own tensor."""
    cfg = cm.reduced(configs.get("xlstm-1.3b"))
    st = recurrent.slstm_state_init(cfg, 2, "cpu")
    assert len({t.data_ptr() for t in st.values()}) == 4
    st["c"][0] += 1.0
    assert float(st["n"].abs().sum()) == 0.0
    assert float(st["h"].abs().sum()) == 0.0
    assert torch.all(st["m"] == -10.0)


@pytest.mark.parametrize("s", [1, 7, 300])
def test_rglru_matches_jax(s):
    """The full-sequence block (conv, gates, scan) and its final state, at
    lengths that are and are not powers of two."""
    jcfg, jp, cfg, tp = _mixer("recurrentgemma-2b", 0, quant_bits=8)
    x = _x((2, s, cfg.d_model), 5)
    h0 = np.abs(_x((2, cfg.d_model), 6))
    jy, js = rglru_apply(jp, jnp.asarray(x), cfg=jcfg,
                         state={"h": jnp.asarray(h0)}, return_state=True)
    y, st = recurrent.rglru_apply(tp, torch.as_tensor(x), cfg,
                                  state={"h": torch.as_tensor(h0)},
                                  return_state=True)
    assert_close(y.numpy(), np.asarray(jy))
    for k in ("h", "conv_tail"):
        assert_close(st[k].numpy(), np.asarray(js[k]))


def test_rglru_sequence_equals_its_decode_steps():
    """rglru_apply over 11 tokens, then its decode steps from the state it
    returns, equal decode steps from a fresh state all the way."""
    _, _, cfg, tp = _mixer("recurrentgemma-2b", 1)
    x = torch.as_tensor(_x((2, 14, cfg.d_model), 7))
    y, st = recurrent.rglru_apply(tp, x[:, :11], cfg, return_state=True)
    fresh = recurrent.rglru_state_init(cfg, 2, "cpu")
    ys = [recurrent.rglru_decode(tp, x[:, t:t + 1], fresh, cfg)[0]
          for t in range(14)]
    assert_close(torch.cat(ys[:11], 1).numpy(), y.numpy())
    more = [recurrent.rglru_decode(tp, x[:, t:t + 1], st, cfg)[0]
            for t in range(11, 14)]
    assert_close(torch.cat(more, 1).numpy(), torch.cat(ys[11:], 1).numpy())


def test_linear_scan_equals_a_loop():
    rng = np.random.default_rng(8)
    a = torch.as_tensor(rng.uniform(0.5, 1.0, (3, 37, 5)))
    b = torch.as_tensor(rng.normal(size=(3, 37, 5)))
    h, want = torch.zeros((3, 5), dtype=torch.float64), []
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    got = recurrent._linear_scan(a, b)
    np.testing.assert_allclose(got.numpy(), torch.stack(want, 1).numpy(),
                               rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# model, serving and launcher plumbing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,expect", [
    ("recurrentgemma-2b", 18 * 5 + 8 * 7), ("xlstm-1.3b", 42 * 4 + 6 * 2)])
def test_full_depth_layers_and_packed_projections(name, expect):
    """Each config at its full depth and pattern (narrow widths, every
    projection still packed): layer kinds in order (RecurrentGemma's two
    remainder layers are RG-LRU) and the packed projections a decode call
    runs; xLSTM has no FFN and its untied head stays unpacked."""
    cfg = cm.reduced(configs.get(name), n_layers=configs.get(name).n_layers,
                     quant_bits=8)
    model = lm.init(torch.Generator().manual_seed(0), cfg, "cpu")
    assert [tuple(layer.kinds) for layer in model.stack] == \
        cfg.layer_kinds()
    assert lm.packed_projections(model) == expect
    if name == "xlstm-1.3b":
        assert model.head.packed is None and \
            tuple(model.head.w.shape) == (cfg.d_model, cfg.vocab)
        assert not hasattr(model.stack[0], "ffn")
    else:
        assert [layer.kinds[0] for layer in model.stack[-3:]] == \
            ["local", "rglru", "rglru"]


@pytest.mark.parametrize("name", NAMES)
def test_reset_state_slot_restores_fresh_rows(name):
    """Admission restores a row of every state kind, mLSTM's m = -1e30 and
    sLSTM's m = -10 included, and leaves the other rows alone."""
    _, _, model = pair(name, 8, False)
    cfg = model.cfg
    states = lm.decode_state_init(cfg, 3, 8, "cpu")
    for t in range(3):
        lm.decode_step(model, torch.tensor([[1], [2], [3]]), states, t)
    before = [{k: v.clone() for k, v in s.items()} for s in states]
    fresh = lm.decode_state_init(cfg, 1, 8, "cpu")
    engine._reset_state_slot(states, fresh, 1)
    for s, b, f in zip(states, before, fresh):
        for k in s:
            assert torch.equal(s[k][1], f[k][0])
            assert torch.equal(s[k][0], b[k][0])
            assert torch.equal(s[k][2], b[k][2])


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


def test_untied_head_is_a_plain_product():
    """xLSTM's logits come from the dense head in the activation dtype."""
    _, params, model = pair("xlstm-1.3b", 8, False)
    np.testing.assert_array_equal(model.head.w.numpy(),
                                  np.asarray(params["head"]["w"]))
    x = torch.as_tensor(_x((1, 2, model.cfg.d_model), 9))
    xf = cm.rmsnorm(model.nf, x, model.cfg.norm_eps)
    assert torch.equal(lm._logits(model, x, model.cfg), xf @ model.head.w)
