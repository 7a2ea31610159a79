"""DeepSeek-V2-Lite on the port, on the CPU: multi-head latent attention
(the ``mla`` mixer, `models.mla`), fine-grained experts with shared
experts and unnormalised gates, and the dense first layer, held to a
plain float32 reference (`tests/_mla_moe_reference.py`) at a reduced
size: every MLA width shrunk, seeded random weights.

Tolerances: the port and the reference compute the same float32
functions with sums in other orders (the absorbed decode reassociates
W_kvb's products; a batched matmul blocks differently from a loop over
tokens), so they differ by float32 rounding, a few units of 1e-6 of the
values' size; the 1e-4 relative bounds below leave that room and are far
below anything a wrong term, position or gate would give (those move
logits by tens of percent).  The file imports no JAX: the JAX package
has no latent attention.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.launch import serve as launch_serve
from repro_torch.models import common as cm
from repro_torch.kernels import launch_count
from repro_torch.kernels import mla_decode as mla_kernel
from repro_torch.models import ffn, lm, mla
from repro_torch.quant import bitplane
from repro_torch.serve import engine

import _mla_moe_reference as ref

NAME = "deepseek-v2-lite"
REL = 1e-4


def _cfg(**kw):
    return cm.reduced(configs.get(NAME), **kw)


def _weights(model):
    """The model's leaves for the reference: packed projections
    dequantised to float [in, out] matrices under ``<name>.w``."""
    out = {}
    sd = model.state_dict()
    for name, t in sd.items():
        if name.endswith(".packed"):
            base = name[:-len(".packed")]
            bits = t.shape[0]
            q = bitplane.unpack(t, bits, axis=0).to(torch.float32)
            out[base + ".w"] = q * sd[base + ".scale"]
        elif not name.endswith(".scale"):
            out[name] = t
    return out


def _fields(cfg):
    return dataclasses.asdict(cfg)


def _close(got, want, rel=REL):
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= rel * scale, \
        ((got - want).abs().max().item(), scale)


@pytest.fixture(scope="module", params=[None, 8], ids=["f32", "packed8"])
def model(request):
    cfg = _cfg(quant_bits=request.param)
    return lm.init(torch.Generator().manual_seed(3), cfg, "cpu")


def test_registry_keeps_the_jax_ten_and_adds_the_published_config():
    assert NAME not in configs.ARCHS and len(configs.ARCHS) == 10
    assert configs.NAMES == configs.ARCHS + (NAME,)
    cfg = configs.get(NAME)
    assert isinstance(cfg, cm.MLAConfig)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.vocab) == \
        (27, 2048, 16, 102400)
    assert (cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim,
            cfg.v_head_dim) == (512, 128, 64, 128)
    assert (cfg.d_ff, cfg.d_ff_dense, cfg.n_experts, cfg.top_k,
            cfg.n_shared, cfg.norm_topk) == (1408, 10944, 64, 6, 2, False)
    kinds = cfg.layer_kinds()
    assert kinds[0] == ("mla", "mlp") and kinds[1:] == [("mla", "moe")] * 26
    # capacity >= a 32-token group: routing drops nothing
    assert int(32 * cfg.top_k * cfg.capacity_factor / cfg.n_experts) + 1 \
        >= 32
    assert configs.get(NAME, quant_bits=8).quant_bits == 8


def test_published_model_has_its_projections_and_widths():
    cfg = configs.get(NAME, quant_bits=8)
    model = lm.LM(cfg, torch.Generator(), torch.device("meta"))
    assert lm.packed_projections(model) == 162
    assert tuple(model.stack[0].ffn.wi.packed.shape) == (8, 64, 10944)
    assert tuple(model.stack[1].ffn_shared.wi.packed.shape) == (8, 64, 2816)
    assert tuple(model.stack[1].ffn.wi.shape) == (64, 2048, 1408)
    mix = model.stack[5].mix
    assert mix.wkvb.packed is None
    assert tuple(mix.wkvb.w.shape) == (512, 16 * 256)
    assert mix.wkvb.w.dtype == torch.bfloat16
    assert tuple(mix.wkva.packed.shape) == (8, 64, 576)
    n = sum(t.numel() for t in model.state_dict().values())
    assert 8.4e9 < n < 15.8e9     # 15.7B parameters, the planes 8 to a word


def test_yarn_frequencies_and_scale_follow_the_formulas():
    cfg = configs.get(NAME)
    want = ref.yarn_inv_freq(64, 10000.0, 40.0, 4096, 32.0, 1.0)
    got = mla.yarn_inv_freq(cfg).double()
    # float32 powers against float64 ones: a few ulp
    assert torch.allclose(got, want, rtol=1e-6, atol=0)
    freq = 10000.0 ** (-torch.arange(0, 64, 2, dtype=torch.float64) / 64)
    # the correction dims of beta 32 and 1 are 10 and 23: below 10 the
    # frequency is kept, from 23 on it is divided by the factor
    assert torch.allclose(got[:10], freq[:10], rtol=1e-6)
    assert torch.allclose(got[23:], freq[23:] / 40, rtol=1e-6)
    m = 0.1 * 0.707 * math.log(40) + 1
    assert abs(m - 1.2608) < 1e-4
    assert mla.softmax_scale(cfg) == pytest.approx(192 ** -0.5 * m * m,
                                                   rel=1e-12)
    assert mla.yarn_mscale(40.0, 0.707) / mla.yarn_mscale(40.0, 0.707) == 1
    plain = dataclasses.replace(cfg, yarn_factor=1.0)
    assert torch.allclose(mla.yarn_inv_freq(plain).double(), freq,
                          rtol=1e-6)


def test_forward_matches_the_reference(model):
    cfg = model.cfg
    tokens = torch.randint(0, cfg.vocab, (2, 9),
                           generator=torch.Generator().manual_seed(1))
    got, _ = lm.forward(model, tokens)
    _close(got, ref.forward(_weights(model), _fields(cfg), tokens))


def test_prefill_then_decode_gives_the_forward_logits(model):
    cfg = model.cfg
    tokens = torch.randint(0, cfg.vocab, (3, 8),
                           generator=torch.Generator().manual_seed(2))
    want, _ = lm.forward(model, tokens)
    last, _ = engine.prefill(model, tokens[:, :5], 12)
    _close(last[:, 0], want[:, 4])
    # the prompt primes the latent caches through decode, then decoding
    # goes on through them
    states = lm.decode_state_init(cfg, 3, 12, "cpu")
    for t in range(8):
        got, states = lm.decode_step(model, tokens[:, t:t + 1], states, t)
        _close(got[:, 0], want[:, t])
    assert states[0]["ckv"][:, 8:].abs().max() == 0


def test_absorbed_decode_equals_the_unabsorbed_attention(model):
    """One MLA layer: the absorbed decode over the latent cache gives the
    full-sequence form's output at every position, per row at its own
    position."""
    cfg = model.cfg
    p = model.stack[1].mix
    x = torch.randn(2, 6, cfg.d_model,
                    generator=torch.Generator().manual_seed(4))
    want = mla.apply(p, x, cfg)
    cache = mla.init_cache(cfg, 2, 10, "cpu")
    for t in range(6):
        got, cache = mla.decode_step(p, x[:, t:t + 1], cache, t, cfg)
        _close(got[:, 0], want[:, t])
    # rows at different positions in one call
    cache2 = mla.init_cache(cfg, 2, 10, "cpu")
    for t in range(6):
        idx = torch.tensor([t, max(t - 2, 0)])
        xs = torch.stack([x[0, t], x[1, max(t - 2, 0)]])[:, None]
        got, cache2 = mla.decode_step(p, xs, cache2, idx, cfg)
        if t >= 2:
            _close(got[1, 0], want[1, t - 2])


def test_plain_decode_kernel_is_softmax_over_live_rows():
    g = torch.Generator().manual_seed(5)
    b, h, t, lat, rd = 3, 4, 7, 8, 4
    q = torch.randn(b, h, lat + rd, generator=g)
    ckv = torch.randn(b, t, lat, generator=g)
    kpe = torch.randn(b, t, rd, generator=g)
    pos = torch.tensor([0, 3, 6])
    got = mla_kernel.mla_decode(q, ckv, kpe, pos, 0.3)
    for i in range(b):
        keys = torch.cat([ckv[i], kpe[i]], -1)[:pos[i] + 1]
        w = torch.softmax(q[i] @ keys.T * 0.3, -1)
        # the same f32 function over 7 rows in another order: a few ulp
        _close(got[i], w @ ckv[i, :pos[i] + 1], 1e-6)


def test_moe_layer_matches_the_reference():
    """The published routing (64 experts, top 6, gates not renormalised,
    capacity factor 11) at small widths: the layer's routed and shared
    experts equal the reference's, and nothing is dropped."""
    cfg = _cfg(n_experts=64, top_k=6, capacity_factor=11.0, d_model=64,
               d_ff=32, quant_bits=8)
    model = lm.init(torch.Generator().manual_seed(6), cfg, "cpu")
    layer = model.stack[1]
    x = torch.randn(1, 32, cfg.d_model,
                    generator=torch.Generator().manual_seed(7))
    got, _ = lm._ffn_block(layer, x, cfg)
    w = _weights(model)
    want = x + ref.moe(w, "stack.1",
                       ref.rmsnorm(x, w["stack.1.n2.g"], cfg.norm_eps),
                       _fields(cfg))
    _close(got, want)
    h = cm.rmsnorm(layer.n2, x, cfg.norm_eps)
    tokens = h.reshape(1, 32, -1)
    capacity = int(32 * cfg.top_k * cfg.capacity_factor / cfg.n_experts) + 1
    probs, gates, _, _, keep = ffn.route(layer.ffn.router["w"], tokens,
                                         cfg, capacity)
    assert bool(keep.all())
    assert torch.equal(gates, torch.topk(probs, cfg.top_k, -1).values)
    assert float(gates.sum(-1).max()) < 1.0      # not renormalised


def test_slot_reset_clears_the_latent_cache():
    cfg = _cfg()
    states = lm.decode_state_init(cfg, 3, 6, "cpu")
    for st in states:
        for t in st.values():
            t.normal_()
    fresh = lm.decode_state_init(cfg, 1, 6, "cpu")
    engine._reset_state_slot(states, fresh, 1)
    for st in states:
        assert set(st) == {"ckv", "kpe"}
        for t in st.values():
            assert t[1].abs().max() == 0 and t[0].abs().min() > 0


def test_serve_continuous_serves_it_and_counts_decodes(model):
    cfg = model.cfg
    rng = np.random.default_rng(8)
    reqs = [engine.Request(rng.integers(0, cfg.vocab, size=int(p)), int(s))
            for p, s in [(3, 4), (1, 2), (5, 3), (2, 5), (4, 1)]]
    before = mla_kernel.DECODES.value(path="plain")
    stats = {}
    out = engine.serve_continuous(model, reqs, slots=2, max_len=12,
                                  stats=stats)
    assert mla_kernel.DECODES.value(path="plain") - before == \
        stats["steps"] * cfg.n_layers
    for r, o in zip(reqs, out):
        assert len(o) == r.steps
        want = engine.generate(model, torch.as_tensor(r.prompt)[None],
                               steps=r.steps, max_len=12)
        assert o.tolist() == want[0].tolist()


def test_a_recording_tallies_launches_and_each_replay_counts_them(
        monkeypatch):
    """A launch inside `launch_count.recording()` is tallied, not counted
    (a recorded call launches nothing); `add` counts the tally once a
    replay.  The MLA kernel's count moves its launches and the decode
    counter's kernel path together."""
    seen = []
    monkeypatch.setitem(launch_count._COUNTS, "probe", seen.append)
    launch_count.launched("probe")
    with launch_count.recording() as tally:
        launch_count.launched("probe")
        launch_count.launched("probe")
    assert seen == [1] and tally == {"probe": 2}
    launch_count.add(tally)
    launch_count.add(tally)
    assert seen == [1, 2, 2]
    monkeypatch.setattr(mla_kernel, "launches", 0)
    before = mla_kernel.DECODES.value(path="kernel")
    launch_count.add({"mla_decode": 27})
    try:
        assert mla_kernel.launches == 27
        assert mla_kernel.DECODES.value(path="kernel") - before == 27
    finally:
        mla_kernel.DECODES.set(before, path="kernel")


def test_launcher_runs_it_on_cpu(capsys):
    launch_serve.main(["--arch", NAME, "--reduced", "--quant", "8",
                       "--device", "cpu", "--steps", "3"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "generated token ids:" and len(out) == 5


@pytest.mark.parametrize("quant", [None, 8])
def test_every_leaf_and_state_has_a_spec_of_its_rank(quant):
    for cfg in (_cfg(quant_bits=quant), configs.get(NAME, quant_bits=quant)):
        model = lm.LM(cfg, torch.Generator(), torch.device("meta"))
        sd, sp = model.state_dict(), lm.specs(cfg)
        assert set(sd) == set(sp)
        for name, t in sd.items():
            assert len(sp[name]) == t.dim(), name
    cfg = _cfg(quant_bits=quant)
    states = lm.decode_state_init(cfg, 2, 5, "cpu")
    for st, spec in zip(states, lm.decode_state_specs(cfg)):
        assert set(st) == set(spec)
        for k, t in st.items():
            assert len(spec[k]) == t.dim() and spec[k][0] == "batch"
