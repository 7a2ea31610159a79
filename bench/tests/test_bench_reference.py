"""The plain references against hand-worked cases and against the port
at tiny sizes on the CPU."""
import numpy as np
import pytest
import torch

from bench.harness import schedule, spec, weights
from bench.reference import dense_gqa, int_gemv, moe_decoder, quant
from bench.tests import _tiny


def test_quantize_hand_worked():
    w = torch.tensor([[1.0, -2.0], [0.5, 4.0]])
    q, s = quant.quantize(w, 8, axis=0)
    assert torch.equal(s, torch.tensor([[1 / 127, 4 / 127]]))
    # 63.5 rounds to 64 (half to even), -63.5 to -64
    assert torch.equal(q, torch.tensor([[127.0, -64.0], [64.0, 127.0]]))
    q4, s4 = quant.quantize(torch.tensor([[-1.0, 0.25, 0.0]]), 4, axis=1)
    assert torch.equal(s4, torch.tensor([[1 / 7]]))
    assert torch.equal(q4, torch.tensor([[-7.0, 2.0, 0.0]]))
    zero_q, zero_s = quant.quantize(torch.zeros(2, 3), 8, axis=0)
    assert torch.equal(zero_s, torch.ones(1, 3)) and not zero_q.any()


def test_integer_product_is_exact():
    rng = np.random.default_rng(0)
    a = rng.integers(-128, 128, size=(4, 2560))
    b = rng.integers(-128, 128, size=(2560, 960))
    got = int_gemv.integer_product(torch.tensor(a, dtype=torch.float32),
                                   torch.tensor(b, dtype=torch.float32))
    assert torch.equal(got, torch.tensor(a @ b))
    with pytest.raises(ValueError):
        int_gemv.integer_product(torch.full((1, 4), 2.0 ** 26),
                                 torch.full((4, 1), 2.0 ** 26))


def test_w8a8_linear_dequantises_the_integer_product():
    x = torch.tensor([[0.5, -1.0]])
    w = torch.tensor([[2.0], [-1.0]])
    y, acc = int_gemv.w8a8_linear(x, w, 8, 8)
    # q_x = [64, -127] at 1/127; q_w = [127, -64] at 2/127
    assert acc.tolist() == [[64 * 127 + 127 * 64]]
    assert torch.equal(y, torch.tensor(
        [[float(64 * 127 * 2)]]) * (torch.tensor(2 / 127) *
                                    torch.tensor(1 / 127)))


def test_keep_mask_hand_worked():
    idx = torch.tensor([[0, 1], [0, 2], [0, 1]])
    keep = moe_decoder.keep_mask(idx, torch.zeros(3, dtype=torch.long),
                                 4, 2)
    # first choices queue first: expert 0 takes tokens 0 and 1 and drops 2
    assert keep.tolist() == [[True, True], [True, True], [False, True]]
    # two groups queue apart
    keep2 = moe_decoder.keep_mask(idx, torch.tensor([0, 0, 1]), 4, 2)
    assert keep2.all()
    assert moe_decoder.capacity(16, 2, 1.25, 8) == 6


def _f32(model: dict) -> dict:
    return dict(model, dtype="float32")


def _port(model: dict, seed: int):
    cfg = spec.port_config({"arch": "smollm-360m" if "n_experts" not in
                            model else "mixtral-8x7b", "model": model})
    return cfg, weights.build(cfg, seed, torch.device("cpu"))


def _one_request(tokens):
    n = len(tokens)
    t = torch.as_tensor(tokens)
    return dense_gqa.Entries(tokens=t, pos=torch.arange(n),
                             seg=torch.zeros(n, dtype=torch.long),
                             step=torch.arange(n),
                             row=torch.zeros(n, dtype=torch.long),
                             real=torch.ones(n, dtype=torch.bool))


def test_dense_reference_equals_the_port_forward():
    from repro_torch.models import lm
    model = _f32(_tiny.TINY)
    cfg, w = _port(model, 5)
    tokens = np.random.default_rng(1).integers(0, model["vocab"], 11)
    want, _ = lm.forward(w.model, torch.as_tensor(tokens)[None])
    ent = _one_request(tokens)
    got = dense_gqa.forward(w.float_weights, model, ent,
                            torch.ones(len(tokens), dtype=torch.bool))
    assert torch.allclose(got, want[0], atol=2e-5, rtol=1e-5)


def test_dense_reference_with_quantised_activations_equals_the_executor():
    from repro_torch.models import common, lm
    from repro_torch.serve import comefa_exec
    model = _f32(_tiny.TINY)
    cfg, w = _port(model, 6)
    tokens = np.random.default_rng(2).integers(0, model["vocab"], 7)
    ex = comefa_exec.GridLinearExecutor(slots=4, x_bits=8, recode=None,
                                        backend="reference")
    prev = common.set_linear_hook(ex)
    try:
        want, _ = lm.forward(w.model, torch.as_tensor(tokens)[None])
    finally:
        common.set_linear_hook(prev)
    got = dense_gqa.forward(w.float_weights, model, _one_request(tokens),
                            torch.ones(len(tokens), dtype=torch.bool),
                            x_bits=8)
    assert torch.allclose(got, want[0], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("shared", [False, True])
def test_moe_reference_equals_the_port_layer(shared):
    """One routing group of 8 tokens over 4 experts; tokens close to one
    another route alike, so capacity drops choices."""
    from repro_torch.models import ffn
    model = _f32(_tiny.TINY_MOE)
    cfg, w = _port(model, 7)
    layer = w.model.stack[0].ffn
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(8, 1, model["d_model"], generator=gen) * 2
    if shared:
        x = x[:1] + 0.01 * x
    want, _ = ffn.moe_apply(layer, x, cfg)
    ent = dense_gqa.Entries(
        tokens=torch.zeros(8, dtype=torch.long),
        pos=torch.zeros(8, dtype=torch.long), seg=torch.arange(8),
        step=torch.zeros(8, dtype=torch.long), row=torch.arange(8),
        real=torch.ones(8, dtype=torch.bool))
    got = moe_decoder.moe_ffn(w.float_weights, model)(
        0, x[:, 0], ent, dense_gqa.identity)
    assert torch.allclose(got, want[:, 0], atol=1e-5, rtol=1e-5)
    _, idx = moe_decoder.route(x[:, 0], layer.router["w"], 2)
    keep = moe_decoder.keep_mask(idx, torch.zeros(8, dtype=torch.long), 4,
                                 moe_decoder.capacity(8, 2, 1.25, 4))
    assert bool(keep.all()) != shared


def test_schedule_follows_the_engine():
    from repro_torch.serve import engine
    model = _f32(_tiny.TINY)
    cfg, w = _port(model, 8)
    rng = np.random.default_rng(4)
    lengths = [(int(rng.integers(1, 5)), int(rng.integers(1, 6)))
               for _ in range(9)]
    prompts = [rng.integers(0, model["vocab"], p) for p, _ in lengths]
    stats = {}
    outs = engine.serve_continuous(
        w.model, [engine.Request(p, s) for p, (_, s) in
                  zip(prompts, lengths)], slots=3, max_len=12, stats=stats)
    sched = schedule.simulate(lengths, 3)
    assert sched.steps == stats["steps"]
    assert len(sched.positions()) == stats["slot_steps"]
    ent = schedule.entries(sched, prompts, outs)
    # every (step, slot) once; the idle slots repeat their last token
    assert len(ent) == sched.steps * 3
    mask, tok = schedule.served(ent, prompts, outs)
    assert int(mask.sum()) == sum(s for _, s in lengths)
    assert sorted(tok.tolist()) == sorted(
        int(t) for o in outs for t in o)
    sub = schedule.entries(sched, prompts, outs, requests=[2, 5])
    assert set(sub.seg.tolist()) == {2, 5} and bool(sub.real.all())
