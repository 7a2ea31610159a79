"""The port's training modules held to the JAX package on the same numpy
inputs: `lm.loss_fn` and its gradient for all ten reduced configs,
AdamW (`apply_updates`, the int8 second moment), `train_step` over three
steps, and the synthetic data pipeline.

JAX params go through `repro_torch.convert`; gradients and optimizer
state come back through the same name mapping.  Loss and gradients are
held within rtol 1e-4, atol 1e-5 (the same sums in other orders) and MoE
routing is exactly equal (an unequal routing would move the aux loss and
the expert gradients far past that).  AdamW's params and ``v`` are held
within 1e-6 relative, ``m`` to the bf16 bit, int8 levels within one
level and exactly off rounding ties.  The data pipeline is byte for byte
the JAX one's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _families import (ATOL, RTOL, _restack, assert_close, frames, pair,
                       tokens)
from repro import configs as jax_configs
from repro.data import pipeline as jax_pipeline
from repro.models import lm as jax_lm
from repro.train import optimizer as jax_opt
from repro.train import step as jax_step
from repro_torch import configs, convert
from repro_torch.data import pipeline
from repro_torch.launch import train as launch_train
from repro_torch.models import common as cm
from repro_torch.models import lm
from repro_torch.train import optimizer as opt
from repro_torch.train import step as step_mod

jax_value_and_grad = jax.jit(
    jax.value_and_grad(jax_lm.loss_fn, has_aux=True),
    static_argnames=("cfg",))
jax_train_step = jax.jit(jax_step.train_step,
                         static_argnames=("cfg", "tcfg"))
jax_apply = jax.jit(jax_opt.apply_updates, static_argnames=("cfg",))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _sd(jax_tree):
    """A JAX param-shaped tree -> {state-dict name: tensor}."""
    return convert.state_dict(_np(jax_tree))


def _jax_opt_to_port(jstate):
    """JAX optimizer state (a param tree of {"m", "v"} or {"m", "v_q",
    "v_s"} dicts) -> the port's {name: {...}}."""
    is_leaf = lambda x: isinstance(x, dict) and "m" in x   # noqa: E731
    keys = jax.tree.leaves(jstate, is_leaf=is_leaf)[0].keys()
    parts = {k: _sd(jax.tree.map(lambda s: s[k], jstate, is_leaf=is_leaf))
             for k in keys}
    names = parts["m"].keys()
    return {n: {k: parts[k][n] for k in keys} for n in names}


def _lm_batch(cfg, b=2, s=16, seed=0):
    """tokens, labels shifted left with -1 at the end (as the pipeline
    makes them), and the frontend embeddings the config takes."""
    toks = tokens((b, s), cfg.vocab, seed)
    labels = np.concatenate([toks[:, 1:], np.full((b, 1), -1, np.int32)],
                            axis=1)
    batch = {"tokens": toks, "labels": labels}
    if cfg.family == "encdec":
        batch["enc_inputs"] = frames(cfg, b, seed)
    elif cfg.frontend == "vision_stub":
        batch["prefix_embeddings"] = frames(cfg, b, seed)
    return batch


def _torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _hold_grads(got, want):
    """Every gradient leaf within RTOL of the leaf's largest |grad| plus
    ATOL: an element is a sum over every token, and where that sum
    cancels its own relative error is unbounded."""
    assert got.keys() == want.keys()
    for name in got:
        w = want[name].numpy()
        np.testing.assert_allclose(
            got[name].numpy(), w, rtol=0,
            atol=ATOL + RTOL * float(np.abs(w).max()), err_msg=name)


# ---------------------------------------------------------------------------
# loss_fn and its gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(jax_configs.ARCHS))
def test_loss_and_grads_match_jax(name):
    """Loss, nll, aux and every gradient leaf of a reduced f32 config;
    the last label of each row is -1 and masked."""
    jcfg, params, model = pair(name, None, False)
    batch = _lm_batch(jcfg)
    (jloss, jm), jgrads = jax_value_and_grad(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, cfg=jcfg)
    lm.trainable(model)
    loss, m, grads = step_mod.loss_and_grads(
        model, _torch(batch), step_mod.TrainConfig())
    assert_close(float(loss), float(jloss))
    assert_close(float(m["nll"]), float(jm["nll"]))
    assert_close(float(m["aux"]), float(jm["aux"]))
    if jcfg.n_experts:
        assert float(m["aux"]) > 0
    _hold_grads(grads, _sd(jgrads))
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())


@pytest.mark.parametrize("name", ["smollm-360m", "mixtral-8x7b",
                                  "whisper-small"])
def test_remat_keeps_loss_and_grads(name):
    """``remat=True`` (every full config's setting) recomputes each
    layer in the backward pass, the encoder's too: the same loss and
    gradients as without it, bit for bit, and still JAX's; the MoE's
    recomputation routes as its first pass did."""
    jcfg, params, model = pair(name, None, False)
    batch = _lm_batch(jcfg, seed=3)
    lm.trainable(model)
    tcfg = step_mod.TrainConfig()
    loss, _, grads = step_mod.loss_and_grads(model, _torch(batch), tcfg)
    model.cfg = dataclasses.replace(model.cfg, remat=True)
    rloss, _, rgrads = step_mod.loss_and_grads(model, _torch(batch), tcfg)
    assert torch.equal(loss, rloss)
    assert all(torch.equal(grads[n], rgrads[n]) for n in grads)
    (jloss, _), jgrads = jax_value_and_grad(
        params, {k: jnp.asarray(v) for k, v in batch.items()},
        cfg=dataclasses.replace(jcfg, remat=True))
    assert_close(float(rloss), float(jloss))
    _hold_grads(rgrads, _sd(jgrads))


def test_masked_labels_get_no_gradient():
    """All labels -1: the loss is 0 and so is every gradient (JAX's mask
    semantics, with the clamped gather in between)."""
    _, _, model = pair("smollm-360m", None, False)
    lm.trainable(model)
    toks = torch.as_tensor(tokens((2, 8), model.cfg.vocab))
    loss, _, grads = step_mod.loss_and_grads(
        model, {"tokens": toks, "labels": torch.full_like(toks, -1)},
        step_mod.TrainConfig())
    assert float(loss) == 0.0
    assert all(not g.any() for g in grads.values())


def test_quant_training_refused_in_both_packages():
    """Packed bit-planes cannot be trained: JAX's value_and_grad raises
    TypeError on the uint32 planes, the port ValueError naming them."""
    jcfg, params, model = pair("smollm-360m", 8, False)
    batch = {k: jnp.asarray(v) for k, v in _lm_batch(jcfg).items()}
    with pytest.raises(TypeError, match="uint32"):
        jax.value_and_grad(lambda p: jax_lm.loss_fn(p, batch, jcfg)[0])(
            params)
    with pytest.raises(ValueError, match="packed projections.*stack.0"):
        lm.trainable(model)
    cfg = cm.reduced(configs.get("smollm-360m", quant_bits=8))
    with pytest.raises(ValueError, match="packed projections"):
        step_mod.init_state(torch.Generator().manual_seed(0), cfg,
                            step_mod.TrainConfig(), "cpu")
    with pytest.raises(ValueError, match="packed projections"):
        launch_train.main(["--reduced", "--quant", "8", "--device", "cpu",
                           "--steps", "1"])


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _adam_setup(scan_layers=False):
    jcfg, params, model = pair("smollm-360m", None, scan_layers)
    return jcfg, params, lm.trainable(model)


def _random_grads(jparams, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: jnp.asarray(
        rng.normal(size=p.shape) * 0.1, jnp.float32), jparams)


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 unit in the last place at |x| (8 significand bits)."""
    a = x.float().abs().clamp(min=torch.finfo(torch.float32).tiny)
    return 2.0 ** (torch.floor(torch.log2(a)) - 7)


def _near_tie(v64: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """Where the int8 level of `v64` (f64, flushed as XLA flushes) under
    the block offsets `lo` lies within 1e-3 of a rounding tie: there a
    one-ulp f32 difference in v or log2 may pick the other level."""
    lo_b = np.repeat(lo, opt.BLOCK, axis=-1)[..., :v64.shape[-1]]
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = (np.log2(np.where(v64 < np.finfo(np.float32).tiny, 0, v64))
               - lo_b) * (255.0 / opt.V_SPAN_OCTAVES)
    return np.abs(rel - np.floor(rel) - 0.5) < 1e-3


def _v64(before, g, clip, b2):
    """The step's new v in f64 from the state it started from."""
    if "v" in before:
        old = before["v"].double().numpy()
    else:
        q = before["v_q"].double().numpy()
        lo = np.repeat(before["v_s"].double().numpy(), opt.BLOCK,
                       axis=-1)[..., :q.shape[-1]]
        old = 2.0 ** ((q + 128.0) * (opt.V_SPAN_OCTAVES / 255.0) + lo)
        old = np.where(old < np.finfo(np.float32).tiny, 0, old)
    gc = g.double().numpy() * clip
    return b2 * old + (1 - b2) * gc * gc


def _hold_state(got, want, before, grads, cfg):
    """m within one bf16 ulp (equal but where the JAX code's fused f32
    multiply-add rounds its f32 m to the other side of a bf16 boundary);
    v and its block offsets within 1e-6 relative; int8 levels within one
    level, and equal wherever the level is not at a rounding tie."""
    gn = np.sqrt(sum(float((g.double() ** 2).sum()) for g in grads.values()))
    clip = min(1.0, cfg.grad_clip / max(gn, 1e-9))
    for name, s in got.items():
        w = want[name]
        dm = (s["m"].float() - w["m"].float()).abs()
        assert bool((dm <= _bf16_ulp(w["m"])).all()), name
        assert float((dm > 0).float().mean()) < 1e-3, name
        if "v" in s:
            np.testing.assert_allclose(s["v"].numpy(), w["v"].numpy(),
                                       rtol=1e-6, atol=0, err_msg=name)
            continue
        np.testing.assert_allclose(s["v_s"].numpy(), w["v_s"].numpy(),
                                   rtol=1e-6, err_msg=name)
        dq = (s["v_q"].to(torch.int32) - w["v_q"].to(torch.int32)).abs()
        assert int(dq.max()) <= 1, name
        tie = _near_tie(_v64(before[name], grads[name], clip, cfg.b2),
                        s["v_s"].double().numpy())
        assert not dq.numpy()[~tie].any(), name


@pytest.mark.parametrize("int8", [False, True])
def test_apply_updates_matches_jax(int8):
    """One `apply_updates` from the same state at step 0 (learning rate
    0: nothing moves) and at step 5, the state the JAX optimizer reached
    over steps 0-4 of seeded gradients; the clip binds.  Params within
    1e-6 relative, the state as `_hold_state` says."""
    cfg = jax_opt.AdamWConfig(lr=0.01, warmup_steps=2, total_steps=10,
                              weight_decay=0.1, int8_second_moment=int8)
    pcfg = opt.AdamWConfig(**dataclasses.asdict(cfg))
    _, jparams, params = _adam_setup()
    jstate = jax_opt.init_state(jparams, cfg)
    for step in range(6):
        jgrads = _random_grads(jparams, step)
        if step in (0, 5):
            with torch.no_grad():
                for name, t in _sd(jparams).items():
                    params[name].copy_(t)
            before = {n: p.detach().clone() for n, p in params.items()}
            state = _jax_opt_to_port(jstate)
            start = {n: {k: t.clone() for k, t in s.items()}
                     for n, s in state.items()}
            grads = _sd(jgrads)
            opt.apply_updates(params, grads, state,
                              torch.tensor(step, dtype=torch.int32), pcfg)
        jparams, jstate = jax_apply(jparams, jgrads, jstate,
                                    jnp.int32(step), cfg=cfg)
        if step not in (0, 5):
            continue
        want = _sd(jparams)
        for name, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       want[name].numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=name)
            assert torch.equal(p.detach(), before[name]) == (step == 0), \
                name
        _hold_state(state, _jax_opt_to_port(jstate), start, grads, pcfg)


def test_lr_is_zero_at_step_zero_even_without_warmup():
    """``warm = step / max(warmup, 1)``: with ``warmup_steps=0`` the
    step-0 update leaves the params unchanged, and step 5 moves them."""
    for pkg, step in ((jax_opt, jnp.int32), (opt, torch.tensor)):
        cfg = pkg.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=10)
        assert float(pkg.schedule(cfg, step(0))) == 0.0
        assert float(pkg.schedule(cfg, step(5))) > 0.0
    _, _, params = _adam_setup()
    pcfg = opt.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=10)
    before = {n: p.detach().clone() for n, p in params.items()}
    grads = {n: torch.ones_like(p) for n, p in params.items()}
    state = opt.init_state(params, pcfg)
    opt.apply_updates(params, grads, state, torch.tensor(0), pcfg)
    assert all(torch.equal(p.detach(), before[n]) for n, p in params.items())
    opt.apply_updates(params, grads, state, torch.tensor(5), pcfg)
    assert all(not torch.equal(p.detach(), before[n])
               for n, p in params.items())


def test_f32_arithmetic_and_rounding_match_jax():
    """The learning rate and the bias corrections are f32 arithmetic on
    f32 tensors, as in JAX (``b2 ** t`` with ``t`` an f32 tensor, not a
    Python float64): within one f32 ulp of JAX's at every step tried,
    and apart from the float64 values.  Rounding is half to even: the
    int8 level's `round` as `jnp.round`, a param's bf16 store as JAX's
    `astype`."""
    cfg = jax_opt.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=300)
    pcfg = opt.AdamWConfig(**dataclasses.asdict(cfg))
    steps = [0, 1, 7, 19, 20, 21, 150, 299, 300, 1000]
    got = opt.schedule(pcfg, torch.tensor(steps, dtype=torch.int32))
    want = np.asarray(jax_opt.schedule(cfg, jnp.asarray(steps, jnp.int32)))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2.0 ** -23, atol=0)
    t = np.arange(1, 400, dtype=np.float32)
    bc = (1.0 - pcfg.b2 ** torch.from_numpy(t)).numpy()
    jbc = np.asarray(1.0 - cfg.b2 ** jnp.asarray(t))
    assert bc.dtype == np.float32
    np.testing.assert_allclose(bc, jbc, rtol=2.0 ** -22, atol=0)
    assert not np.array_equal(bc, (1.0 - cfg.b2 ** t.astype(np.float64))
                              .astype(np.float32))
    halves = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 126.5], np.float32)
    assert np.array_equal(torch.round(torch.from_numpy(halves)).numpy(),
                          np.asarray(jnp.round(jnp.asarray(halves))))
    ties = np.array([1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8, -(1 + 2.0 ** -8),
                     0.1], np.float32)     # halfway between bf16 values
    got16 = torch.from_numpy(ties).to(torch.bfloat16).view(torch.int16)
    want16 = np.asarray(jnp.asarray(ties).astype(jnp.bfloat16)).view(
        np.int16)
    assert np.array_equal(got16.numpy(), want16)


def test_weight_decay_follows_the_stored_rank():
    """JAX's stacked layout (``scan_layers=True``) stores each per-layer
    1-D leaf as [L, d] and decays it; the port stores it 1-D and does
    not, as JAX's unstacked layout.  Against the stacked layout exactly
    the per-layer 1-D leaves differ; against the unstacked one none."""
    cfg = jax_opt.AdamWConfig(lr=0.01, warmup_steps=0, total_steps=10,
                              weight_decay=0.5)
    pcfg = opt.AdamWConfig(**dataclasses.asdict(cfg))
    _, jflat, params = _adam_setup(scan_layers=False)
    _, jstacked, _ = _adam_setup(scan_layers=True)
    grads = _random_grads(jflat, 7)
    sgrads = _restack(grads)            # the same values, stacked
    assert jax.tree.structure(sgrads) == jax.tree.structure(jstacked)
    step = jnp.int32(5)
    flat_out, _ = jax_apply(jflat, grads, jax_opt.init_state(jflat, cfg),
                            step, cfg=cfg)
    stacked_out, _ = jax_apply(jstacked, sgrads,
                               jax_opt.init_state(jstacked, cfg), step,
                               cfg=cfg)
    opt.apply_updates(params, _sd(grads), opt.init_state(params, pcfg),
                      torch.tensor(5, dtype=torch.int32), pcfg)
    flat_want, stacked_want = _sd(flat_out), _sd(stacked_out)
    differ = set()
    for name, p in params.items():
        got = p.detach().numpy()
        np.testing.assert_allclose(got, flat_want[name].numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
        if not np.allclose(got, stacked_want[name].numpy(), rtol=1e-6,
                           atol=1e-7):
            differ.add(name)
    per_layer_1d = {n for n, p in params.items()
                    if n.startswith("stack.") and p.ndim == 1}
    assert per_layer_1d == {f"stack.{j}.{k}.g" for j in range(2)
                            for k in ("n1", "n2")}
    assert differ == per_layer_1d


def test_q8_round_trip_matches_jax():
    """Encode and decode over three decades of magnitude, exact zeros, a
    block of all zeros (its max floored at 1e-30), subnormals (flushed,
    as XLA flushes them) and a ragged last block."""
    rng = np.random.default_rng(4)
    v = (10.0 ** rng.uniform(-12, -3, size=(3, 600))).astype(np.float32)
    v[0, :7] = 0.0
    v[1, 256:512] = 0.0
    v[2, 3:5] = np.float32(1e-39)
    jq, js = jax_opt._q8_encode(jnp.asarray(v))
    q, s = opt._q8_encode(torch.from_numpy(v))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    assert np.all(np.asarray(js)[1, 1] == np.float32(np.log2(1e-30) - 40))
    dq = np.abs(q.numpy().astype(int) - np.asarray(jq).astype(int))
    assert dq.max() <= 1
    # off a rounding tie the level is exactly JAX's
    tie = _near_tie(v.astype(np.float64), s.double().numpy())
    assert np.array_equal(q.numpy()[~tie], np.asarray(jq)[~tie])
    assert (q.numpy()[0, :7] == -128).all() and (q.numpy()[2, 3:5] == -128
                                                  ).all()
    jd = jax_opt._q8_decode(jq, js, v.shape)
    d = opt._q8_decode(torch.from_numpy(np.asarray(jq)),
                       torch.from_numpy(np.asarray(js)), v.shape)
    # v = 2^logv with logv near -100: XLA fuses the multiply-add that
    # makes logv, and one f32 ulp of it (7.6e-6) is 5.3e-6 of v
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5, atol=0)
    back = opt._q8_decode(q, s, v.shape).numpy()
    big = v > v.max(-1, keepdims=True) * 2.0 ** -30
    np.testing.assert_allclose(back[big], v[big], rtol=0.06)


# ---------------------------------------------------------------------------
# train_step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("microbatches,accum", [(1, "float32"),
                                                (4, "float32"),
                                                (4, "bfloat16")])
def test_train_step_matches_jax(microbatches, accum):
    """Three steps from the same converted state on the pipeline's
    batches: metrics each step, then params and moments."""
    jcfg, jparams, model = pair("smollm-360m", None, False, vocab=128)
    adamw = jax_opt.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=6)
    jtcfg = jax_step.TrainConfig(adamw=adamw, microbatches=microbatches,
                                 accum_dtype=accum)
    tcfg = step_mod.TrainConfig(
        adamw=opt.AdamWConfig(**dataclasses.asdict(adamw)),
        microbatches=microbatches, accum_dtype=accum)
    jstate = {"params": jparams, "opt": jax_opt.init_state(jparams, adamw),
              "step": jnp.zeros((), jnp.int32)}
    state = step_mod.state_for(model, tcfg)
    data = pipeline.SyntheticLM(pipeline.DataConfig(
        vocab=128, global_batch=8, seq_len=16, seed=5))
    for step in range(3):
        batch = {k: v.numpy() for k, v in data.batch_at(step).items()}
        jstate, jm = jax_train_step(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()},
            cfg=jcfg, tcfg=jtcfg)
        state, m = step_mod.train_step(state, batch, model.cfg, tcfg)
        for k in ("loss", "grad_norm", "nll", "aux"):
            assert_close(float(m[k]), float(jm[k]))
        if microbatches > 1:
            assert float(m["aux"]) == 0.0
            assert float(m["nll"]) == float(m["loss"])
    assert int(state["step"]) == 3
    # grads 1e-6 apart can round a stored bf16 m to the other side of a
    # bf16 boundary, which moves the next update by up to 2^-8 of
    # m/sqrt(v) (at most about 1): params within RTOL plus lr * 2^-7 for
    # each of the two steps that move them (step 0's learning rate is 0)
    want = _sd(jstate["params"])
    for name, p in model.named_parameters():
        assert_close(p.detach().numpy(), want[name].numpy(),
                     atol=1e-5 + 2 * 3e-3 * 2.0 ** -7)
    # m is stored in bf16: a stored m one bf16 ulp off carries that ulp
    # (up to 2^-7 of the leaf's largest |m|) into every later m, however
    # far the moment then cancels.  v, a sum of squared gradients, within
    # twice the gradient's gap at the leaf's scale: RTOL with f32
    # accumulation, a bf16 ulp (2^-7) with bf16
    want_opt = _jax_opt_to_port(jstate["opt"])
    scale = 2.0 ** -7 if accum == "bfloat16" else RTOL
    for name, s in state["opt"].items():
        w = want_opt[name]["m"].float().numpy()
        assert_close(s["m"].float().numpy(), w, rtol=2.0 ** -7,
                     atol=2.0 ** -7 * float(np.abs(w).max()))
        w = want_opt[name]["v"].numpy()         # sums of g^2: twice that
        assert_close(s["v"].numpy(), w, atol=2 * scale * float(w.max()))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,b,s,seed", [(128, 8, 64, 5),
                                            (49152, 2, 300, 1234)])
def test_synthetic_batches_are_jax_bytes(vocab, b, s, seed):
    cfg = dict(vocab=vocab, global_batch=b, seq_len=s, seed=seed)
    want = jax_pipeline.SyntheticLM(jax_pipeline.DataConfig(**cfg))
    got = pipeline.SyntheticLM(pipeline.DataConfig(**cfg))
    for step in (0, 1, 17):
        w, g = want.batch_at(step), got.batch_at(step)
        for k in ("tokens", "labels"):
            assert g[k].dtype == torch.int32 and g[k].device.type == "cpu"
            assert g[k].numpy().tobytes() == np.asarray(w[k]).tobytes()
        assert (g["labels"][:, -1] == -1).all()
