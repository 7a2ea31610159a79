"""The DeepSeek-V2 cell's pieces on the CPU: a tiny MLA + DeepSeekMoE cell
run whole (correct on a sound run, false under each fault its check
must catch), the reference's `stages` against its `forward`, and the
readers of `mla_decode_roofline` and `mla.kernel_share` on a synthetic
run."""
import json
import time
import types

import numpy as np
import pytest
import torch

from bench.harness import cell as cell_mod
from bench.harness import schedule, spec
from bench.metrics import arith, mla_work
from bench.reference import dense_gqa, mla_moe_decoder
from bench.tests import _tiny

SEED = 2 ** 31 + 777

TINY_MLA = {"n_layers": 3, "d_model": 64, "n_heads": 4, "kv_heads": 4,
            "head_dim": 24, "d_ff": 32, "vocab": 256,
            "pattern": [["mla", "mlp"], ["mla", "moe"], ["mla", "moe"]],
            "n_experts": 8, "top_k": 3, "capacity_factor": 3.0,
            "moe_group": 512, "tie_embeddings": False,
            "rope_theta": 10000.0, "norm_eps": 1e-06, "kv_lora_rank": 32,
            "qk_nope_dim": 16, "qk_rope_dim": 8, "v_head_dim": 16,
            "d_ff_dense": 96, "n_shared": 2, "norm_topk": False,
            "yarn_factor": 40.0, "yarn_original_len": 4096,
            "yarn_beta_fast": 32.0, "yarn_beta_slow": 1.0,
            "yarn_mscale": 0.707, "yarn_mscale_all_dim": 0.707,
            "quant_bits": 8, "dtype": "bfloat16"}
LIMITS = {"stage_err": 0.02, "token_mismatch": 0, "schedule_steps": 0,
          "failed": 0}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny root of `_tiny` with one more cell, ``tiny-mla``."""
    r = _tiny.tiny_root(tmp_path_factory.mktemp("tiny_mla"))
    b = r / "bench"
    (b / "configs" / "tiny-mla.json").write_text(json.dumps(
        {"source": "test", "arch": "deepseek-v2-lite",
         "reference": "mla_moe_decoder", "model": TINY_MLA, "reduced": []}))
    (b / "limits" / "tiny-mla.json").write_text(json.dumps(
        {"follow": "stages", "limits": LIMITS}))
    bench = json.loads((r / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-mla", "source": "test",
                             "file": "bench/configs/tiny-mla.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-mla", "config": "tiny-mla",
                               "traffic": "tiny-mix", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and m["name"] != "serve_request_p95_s":
            m["workloads"].append("tiny-mla")
    (r / "BENCHMARK.json").write_text(json.dumps(bench))
    return r


def _run(root, trace=False, control=False, cell=None):
    cell = cell or spec.load_cell(root, "tiny-mla")
    return cell_mod.run_cell(cell, SEED, 1.0, trace, "cpu",
                             time.perf_counter(), control=control)


def test_a_sound_run_is_correct_and_counts_its_decodes(root):
    out = _run(root, trace=True)
    assert out["correct"], out["checks"]
    assert list(out["checks"]) == ["stage_err", "token_mismatch",
                                   "schedule_steps", "failed"]
    m = out["metrics"]
    # the CPU runs the plain decode: counted, none on the kernel path
    assert m["mla.kernel_share"]["value"] == 0.0
    assert "mla_decode_roofline" not in m


def test_float32_port_agrees_with_the_reference(root):
    cell = spec.load_cell(root, "tiny-mla")
    cell.config = dict(cell.config, model=dict(cell.config["model"],
                                               dtype="float32"))
    r = _run(root, control=True, cell=cell)["readings"]
    assert r["stage_err"] < 1e-5 and r["head_gap"] < 1e-4
    assert r["token_mismatch"] == 0


def test_control_reads_above_the_limit(root):
    out = _run(root, control=True)
    assert out["correct"]
    assert out["readings"]["control_stage_err"] > LIMITS["stage_err"]


class _Fault:
    """A fault in the served model from the 6th decode step on (the
    warm-up makes 5): ``token`` serves the least likely token, ``latent``
    leaves the latent row of the last half of the slots unwritten,
    ``shared`` leaves the shared experts out."""

    def __init__(self, monkeypatch, kind, at=6):
        from repro_torch.models import ffn, lm, mla
        self.calls = 0
        real_step, real_mla, real_mlp = (lm.decode_step, mla.decode_step,
                                         ffn.mlp_apply)

        def step(*a, **k):
            self.calls += 1
            logits, states = real_step(*a, **k)
            if kind == "token" and self.calls >= at:
                logits = -logits
            return logits, states

        def mla_step(params, x, cache, index, cfg):
            b = x.shape[0]
            idx = torch.as_tensor(index).expand(b)
            rows = torch.arange(b // 2, b)
            old = cache["ckv"][rows, idx[b // 2:]].clone()
            out = real_mla(params, x, cache, index, cfg)
            if self.calls >= at:
                cache["ckv"][rows, idx[b // 2:]] = old
            return out

        def mlp_apply(params, x, cfg):
            y = real_mlp(params, x, cfg)
            shared = params.wi.packed.shape[2] == cfg.shared_width
            return torch.zeros_like(y) if shared and self.calls >= at \
                else y
        monkeypatch.setattr(lm, "decode_step", step)
        if kind == "latent":
            monkeypatch.setattr(mla, "decode_step", mla_step)
        if kind == "shared":
            monkeypatch.setattr(ffn, "mlp_apply", mlp_apply)


@pytest.mark.parametrize("kind", ["token", "latent", "shared"])
def test_faults_make_correct_false(root, monkeypatch, kind):
    _Fault(monkeypatch, kind)
    out = _run(root)
    assert not out["correct"], out["checks"]
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def _entries():
    mix = json.loads(json.dumps(_tiny.MIX))
    from bench.harness import traffic
    reqs = traffic.requests(mix, 5, 1.0, TINY_MLA["vocab"])
    sched = schedule.simulate([(len(r.prompt), r.steps) for r in reqs],
                              mix["slots"])
    outs = [(np.arange(r.steps) * 7 + 3) % TINY_MLA["vocab"] for r in reqs]
    prompts = [r.prompt for r in reqs]
    ent = schedule.entries(sched, prompts, outs)
    return ent, schedule.served(ent, prompts, outs)[0]


def _weights():
    g = torch.Generator().manual_seed(11)
    m, w = TINY_MLA, {}
    d = m["d_model"]
    h = m["n_heads"]

    def mat(name, k, n, dtype=torch.float32):
        w[name] = (torch.randn(k, n, generator=g) / k ** 0.5).to(dtype)
    w["embed.e"] = (torch.randn(m["vocab"], d, generator=g) * 0.02).to(
        torch.bfloat16)
    for j, (_, f) in enumerate(mla_moe_decoder.layer_kinds(m)):
        p = f"stack.{j}"
        w[f"{p}.n1.g"] = w[f"{p}.n2.g"] = torch.ones(d)
        mat(f"{p}.mix.wq.w", d, h * 24)
        mat(f"{p}.mix.wkva.w", d, 40)
        w[f"{p}.mix.kvn.g"] = torch.ones(32)
        mat(f"{p}.mix.wkvb.w", 32, h * 32, torch.bfloat16)
        mat(f"{p}.mix.wo.w", h * 16, d)
        if f == "mlp":
            for n, (k, o) in {"wi": (d, 96), "wg": (d, 96),
                              "wo": (96, d)}.items():
                mat(f"{p}.ffn.{n}.w", k, o)
        else:
            w[f"{p}.ffn.router.w"] = torch.randn(d, 8, generator=g) * 0.02
            w[f"{p}.ffn.wi"] = torch.randn(8, d, 32, generator=g).to(
                torch.bfloat16) / 8
            w[f"{p}.ffn.wg"] = torch.randn(8, d, 32, generator=g).to(
                torch.bfloat16) / 8
            w[f"{p}.ffn.wo"] = torch.randn(8, 32, d, generator=g).to(
                torch.bfloat16) / 6
            for n, (k, o) in {"wi": (d, 64), "wg": (d, 64),
                              "wo": (64, d)}.items():
                mat(f"{p}.ffn_shared.{n}.w", k, o)
    w["nf.g"] = torch.ones(d)
    mat("head.w", d, m["vocab"], torch.bfloat16)
    return w


def test_reference_stages_follow_its_forward():
    """Fed the reference's own stage outputs as the served inputs, each
    stage gives the next input, and the head gives `forward`'s logits."""
    ent, mask = _entries()
    w, m = _weights(), TINY_MLA
    want = mla_moe_decoder.forward(w, m, ent, mask)
    h = dense_gqa.embed(w, m, ent)
    inputs = [h]
    proj = dense_gqa.Projections(w, m["quant_bits"])
    idx = dense_gqa._segments(ent)
    for j in range(m["n_layers"]):
        h = mla_moe_decoder.layer(w, m, ent, idx, j, h, proj,
                                  dense_gqa.identity)
        inputs.append(h)
    outs, head = mla_moe_decoder.stages(w, m, ent, inputs, mask)
    assert len(outs) == m["n_layers"] + 1
    for got, x in zip(outs, inputs):
        assert torch.equal(got, x)
    assert torch.equal(outs[-1], inputs[-1])
    assert torch.allclose(head, want, rtol=0, atol=1e-5)
    chained = outs + [head]
    assert len(chained) == len(outs) + 1 and chained[-1] is head


def _fake_run(model, sched, slots, trace=None, counters=None):
    cell = types.SimpleNamespace(config={"model": model},
                                 mix={"slots": slots})
    return types.SimpleNamespace(cell=cell, sched=sched, slots=slots,
                                 trace=trace, counters=counters or {},
                                 counter=lambda k: (counters or {}).get(
                                     k, 0.0))


class _Trace:
    def __init__(self, steps, first, launches, seconds):
        self.steps, self.first_step = steps, first
        self._hits = (launches, seconds)

    def time_s(self, names):
        assert names == ("mla_decode",)
        return self._hits


def test_mla_decode_roofline_reader_prices_each_slots_rows():
    model = {"n_layers": 27, "pattern": [["mla", "mlp"]] +
             [["mla", "moe"]] * 26, "n_heads": 16, "kv_lora_rank": 512,
             "qk_rope_dim": 64}
    # two slots: requests of 3 and 5 steps, then a third of 2 in slot 0
    sched = schedule.simulate([(2, 2), (3, 3), (1, 2)], 2)
    table = [mla_work.slot_positions(sched, s, 2)
             for s in range(sched.steps)]
    # slot 0: 0, 1, 2 (first request), then 0, 1 (third), then idle at 2;
    # slot 1: 0..4 (second request)
    assert table == [[0, 0], [1, 1], [2, 2], [0, 3], [1, 4]][:sched.steps]
    pos = [1, 4]
    nbytes = 2 * ((2 + 5) * 576 + 2 * 16 * 576 + 2 * 16 * 512)
    flops = 2 * 16 * (576 + 512) * (2 + 5)
    assert mla_work.call_bytes(pos, 16, 512, 64) == nbytes
    assert mla_work.call_flops(pos, 16, 512, 64) == flops
    bound = 27 * arith.roofline_s(nbytes, flops)
    mod = _reader("mla_decode_roofline")
    run = _fake_run(model, sched, 2, _Trace(1, 4, 2 * 27, 2 * bound))
    assert mod.read(run) == pytest.approx(50.0)
    # launches that are not whole steps of 27 layers, or none: not read
    assert mod.read(_fake_run(model, sched, 2,
                              _Trace(1, 4, 2 * 27 + 1, bound))) is None
    assert mod.read(_fake_run(model, sched, 2, _Trace(1, 4, 0, 0))) is None
    assert mod.read(_fake_run(model, sched, 2, None)) is None
    # a model with no latent attention: nothing to read
    assert mod.read(_fake_run({"n_layers": 2, "pattern": [["global",
                                                           "mlp"]]},
                              sched, 2, _Trace(1, 4, 54, 1.0))) is None


def test_mla_kernel_share_reader():
    mod = _reader("mla.kernel_share")
    c = {"attention.mla_decodes": 54.0,
         "attention.mla_decodes{path=kernel}": 54.0}
    assert mod.read(_fake_run({}, None, 2, counters=c)) == 100.0
    c = {"attention.mla_decodes": 40.0,
         "attention.mla_decodes{path=kernel}": 10.0,
         "attention.mla_decodes{path=plain}": 30.0}
    assert mod.read(_fake_run({}, None, 2, counters=c)) == 25.0
    assert mod.read(_fake_run({}, None, 2, counters={})) is None


def _reader(name):
    import importlib.util
    path = _tiny.REPO / "bench" / "metrics" / f"{name}.py"
    s = importlib.util.spec_from_file_location(name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod
