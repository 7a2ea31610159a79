"""The port's MoE families held to the JAX package on the same params:
Mixtral-8x7B (top-2 of 8 experts under sliding-window attention, untied
head) and Arctic-480B (top-2 of 128 experts plus a dense MLP beside
them, every layer).

JAX params go through `repro_torch.convert` in both stack layouts, with
and without 8-bit planes, and the same numpy-seeded inputs go through
both packages.  Logits, decode steps, MoE outputs and aux losses are
held within rtol 1e-4, atol 1e-5 (the same sums in other orders); the
routing (expert indices, queue positions, keep mask) must be exactly
equal.  The reduced configs have 4 experts, except where a test asks
for Arctic's capacity of one slot at decode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _families import (assert_close, cfgs, decode_both,
                       forward_aux_both, pair, tokens)
from repro import configs as jax_configs
from repro.models import ffn as jax_ffn
from repro.serve import engine as jax_engine
from repro_torch import configs
from repro_torch.launch import serve as launch_serve
from repro_torch.models import common as cm
from repro_torch.models import ffn, lm
from repro_torch.serve import engine

NAMES = ["mixtral-8x7b", "arctic-480b"]

DECODE = [(None, False, "scalar"), (None, False, "vector"),
          (8, False, "scalar"), (8, False, "vector"), (8, True, "scalar")]


@pytest.mark.parametrize("scan_layers", [False, True])
@pytest.mark.parametrize("quant_bits", [None, 8])
@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax(name, quant_bits, scan_layers):
    """Logits and the summed aux loss of a 2-layer stack, and the last
    position alone."""
    jcfg, params, model = pair(name, quant_bits, scan_layers)
    toks = tokens((2, 9), jcfg.vocab)
    (got, aux), (want, jaux) = forward_aux_both(jcfg, params, model, toks)
    assert_close(got, want)
    assert_close(aux, jaux)
    assert aux > 0
    last, _ = lm.forward(model, torch.as_tensor(toks), last_only=True)
    assert_close(last.numpy(), want[:, -1:])


@pytest.mark.parametrize("quant_bits,scan_layers,index", DECODE)
@pytest.mark.parametrize("name", NAMES)
def test_decode_steps_match_jax(name, quant_bits, scan_layers, index):
    """Nine decode steps at a scalar or per-row vector index; three rows a
    step route as one group of three tokens (capacity 2 of 4 experts)."""
    jcfg, params, model = pair(name, quant_bits, scan_layers)
    toks = tokens((3, 9), jcfg.vocab, seed=1)
    vector = index == "vector"

    def index_of(t):
        return np.array([t, max(t - 1, 0), 0]) if vector else t

    decode_both(jcfg, params, model, toks, 12, index_of, assert_close,
                vector)


def test_decode_with_one_slot_an_expert():
    """Arctic's decode regime: 16 experts at batch 4 give a capacity of
    int(4 * 2 * 1.25 / 16) + 1 = 1, so two rows that pick one expert
    drop the later (token, choice) pair; both packages drop the same."""
    jcfg, params, model = pair("arctic-480b", 8, False, n_experts=16)
    toks = tokens((4, 6), jcfg.vocab, seed=9)
    decode_both(jcfg, params, model, toks, 8, lambda t: t, assert_close)


# ---------------------------------------------------------------------------
# moe_apply and its routing alone
# ---------------------------------------------------------------------------

_jax_moe = jax.jit(jax_ffn.moe_apply, static_argnames=("cfg",))


def _jax_route(router_w, xg, cfg, capacity):
    """The routing lines of the JAX `moe_apply` (repro/models/ffn.py
    96-112), which does not return them."""
    e, k = cfg.n_experts, cfg.top_k
    n, g, _ = xg.shape
    logits = jnp.einsum("ngd,de->nge", xg.astype(jnp.float32), router_w)
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, expert_idx = jax.lax.top_k(probs, k)
    gate_vals = gate_vals / jnp.clip(gate_vals.sum(-1, keepdims=True), 1e-9)
    onehot = jax.nn.one_hot(expert_idx, e, dtype=jnp.float32)
    flat = onehot.transpose(0, 2, 1, 3).reshape(n, k * g, e)
    pos_flat = jnp.cumsum(flat, axis=1) - flat
    pos = pos_flat.reshape(n, k, g, e).transpose(0, 2, 1, 3)
    pos = jnp.sum(pos * onehot, axis=-1).astype(jnp.int32)
    keep = pos < capacity
    return probs, gate_vals * keep, expert_idx, pos, keep


@pytest.mark.parametrize("name,shape,over,groups,drops", [
    ("mixtral-8x7b", (2, 64), {}, 2, None),        # t = 128: groups of 64
    ("mixtral-8x7b", (2, 9), {}, 1, None),         # t = 18: one group
    ("mixtral-8x7b", (2, 64), {"capacity_factor": 0.5}, 2, True),
    ("mixtral-8x7b", (2, 9), {"capacity_factor": 0.5}, 1, True),
    ("arctic-480b", (4, 1), {"n_experts": 16}, 1, None)])  # capacity 1
def test_moe_apply_matches_jax(name, shape, over, groups, drops):
    """One layer's MoE on seeded activations: both group branches (t a
    multiple of ``moe_group`` = 64, and not) and a capacity factor that
    drops tokens; output and aux within the f32 tolerance, the routing
    exactly."""
    pover = {"n_experts": over["n_experts"]} if "n_experts" in over else {}
    jcfg, params, model = pair(name, None, False, **pover)
    jcfg = dataclasses.replace(jcfg, **over)
    cfg = dataclasses.replace(model.cfg, **over)
    jp = params["stack"]["group_list"][0]["l0"]["ffn"]
    p = model.stack[0].ffn
    x = np.random.default_rng(sum(shape)).normal(
        size=shape + (cfg.d_model,)).astype(np.float32)
    want, jaux = _jax_moe(jp, jnp.asarray(x), cfg=jcfg)
    got, aux = ffn.moe_apply(p, torch.as_tensor(x), cfg)
    assert_close(got.numpy(), np.asarray(want))
    assert_close(float(aux), float(jaux))

    t = shape[0] * shape[1]
    g = cfg.moe_group if t % cfg.moe_group == 0 else t
    assert t // g == groups
    capacity = int(g * cfg.top_k * cfg.capacity_factor / cfg.n_experts) + 1
    xg = x.reshape(t // g, g, cfg.d_model)
    jr = _jax_route(jp["router"]["w"], jnp.asarray(xg), jcfg, capacity)
    tr = ffn.route(p.router["w"], torch.as_tensor(xg), cfg, capacity)
    for name_, j, mine in zip(("idx", "pos", "keep"), jr[2:], tr[2:]):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(j),
                                      err_msg=name_)
    assert_close(tr[0].numpy(), np.asarray(jr[0]))        # probs
    assert_close(tr[1].numpy(), np.asarray(jr[1]))        # gates, dropped 0
    if drops:
        assert not bool(tr[4].all())


# ---------------------------------------------------------------------------
# serving, launcher, registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_generate_greedy_equals_jax(name):
    jcfg, params, model = pair(name, 8, False)
    prompt = tokens((2, 4), jcfg.vocab, seed=6)
    want = np.asarray(jax_engine.generate(params, jnp.asarray(prompt), jcfg,
                                          steps=4, max_len=9))
    got = engine.generate(model, torch.as_tensor(prompt), steps=4,
                          max_len=9)
    np.testing.assert_array_equal(got.numpy(), want)


def test_serve_continuous_equals_jax():
    """Mixtral over 3 slots: every batched step routes all rows as one
    group, idle rows included, so a request's tokens depend on its
    neighbours through capacity, in both packages alike."""
    jcfg, params, model = pair("mixtral-8x7b", 8, False)
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(0, jcfg.vocab, int(rng.integers(1, 5))).astype(
        np.int32), int(rng.integers(2, 5))) for _ in range(5)]
    jstats, stats = {}, {}
    want = jax_engine.serve_continuous(
        params, [jax_engine.Request(p, s) for p, s in reqs], jcfg, slots=3,
        max_len=10, stats=jstats)
    got = engine.serve_continuous(
        model, [engine.Request(p, s) for p, s in reqs], slots=3, max_len=10,
        stats=stats)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert stats == jstats


@pytest.mark.parametrize("name,per_layer", [("mixtral-8x7b", 4),
                                            ("arctic-480b", 7)])
def test_full_depth_layers_and_packed_projections(name, per_layer):
    """Full depth at narrow widths: Mixtral's 32 layers pack their 4
    attention projections (experts stay plain: 128), Arctic's 35 also
    their dense MLP's 3 (245)."""
    full = configs.get(name)
    cfg = cm.reduced(full, n_layers=full.n_layers, quant_bits=8)
    model = lm.init(torch.Generator().manual_seed(0), cfg, "cpu")
    assert [tuple(layer.kinds) for layer in model.stack] == \
        cfg.layer_kinds()
    assert lm.packed_projections(model) == per_layer * full.n_layers
    assert lm.packed_projections(model, encoder=True) == 0
    moe = model.stack[0].ffn
    assert moe.router["w"].dtype == torch.float32
    assert tuple(moe.wi.shape) == (cfg.n_experts, cfg.d_model, cfg.d_ff)
    assert tuple(moe.wo.shape) == (cfg.n_experts, cfg.d_ff, cfg.d_model)
    assert hasattr(model.stack[0], "ffn_dense") == (name == "arctic-480b")


@pytest.mark.parametrize("name", NAMES)
def test_launcher_runs_each_family_on_cpu(name, capsys):
    launch_serve.main(["--arch", name, "--reduced", "--quant", "8",
                       "--device", "cpu", "--steps", "3"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "generated token ids:" and len(out) == 5


def test_registry_equals_the_jax_package():
    assert configs.ARCHS == jax_configs.ARCHS
    for name in configs.ARCHS:
        assert dataclasses.asdict(configs.get(name)) == \
            dataclasses.asdict(jax_configs.get(name))


def test_reduced_configs_match_the_jax_package():
    for name in NAMES:
        jcfg, cfg = cfgs(name, 8, False)
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
