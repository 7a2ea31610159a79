"""Whole runs of tiny cells on the CPU: the harness past its look for a
chip, a cell and a metric added from new files alone, `correct` true on
a sound run and false under each fault a serving cell can have, and the
control reading above the limit."""
import json
import time

import pytest
import torch

from bench.harness import cell as cell_mod
from bench.harness import spec
from bench.tests import _tiny

SEED = 2 ** 31 + 12345


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tiny")
    extra = {"name": "dummy.tokens_per_step", "unit": "tokens/step",
             "better": "higher", "source": "program_counter",
             "layer": "serving engine", "moves": "serve_tokens_per_s",
             "workloads": ["tiny-serve"]}
    r = _tiny.tiny_root(tmp, extra_per_layer=[extra])
    (r / "bench" / "metrics" / "dummy.tokens_per_step.py").write_text(
        "def read(run):\n    return run.tokens / run.stats['steps']\n")
    return r


def _run(root, name, trace=False, control=False, seed=SEED):
    return cell_mod.run_cell(spec.load_cell(root, name), seed, 1.0, trace,
                             "cpu", time.perf_counter(), control=control)


def test_new_cell_and_metric_come_from_new_files_alone(root):
    for path in (root / "bench").rglob("*"):
        mine = _tiny.REPO / "bench" / path.relative_to(root / "bench")
        if path.is_file() and mine.is_file() and "__pycache__" not in \
                path.parts:
            assert path.read_bytes() == mine.read_bytes(), path
    out = _run(root, "tiny-serve", trace=True)
    assert out["correct"], out["checks"]
    m = out["metrics"]
    assert m["dummy.tokens_per_step"]["unit"] == "tokens/step"
    assert 0 < m["serve.occupancy"]["value"] <= 100
    # no device on the CPU: the device readers find nothing to read
    assert "bitplane_matmul_roofline" not in m
    assert "device_idle.serve" not in m


@pytest.mark.parametrize("name", ["tiny-serve", "tiny-moe", "tiny-moe16"])
def test_a_sound_run_is_correct_and_reports_its_metrics(root, name):
    out = _run(root, name)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 4
    assert out["metrics"]["serve_tokens_per_s"]["value"] > 0
    assert out["metrics"]["setup_s"]["value"] > 0
    first = ["stage_err", "token_mismatch"] if "moe" in name else \
        ["logit_gap"]
    assert list(out["checks"]) == first + ["schedule_steps", "failed"]


@pytest.mark.parametrize("name", ["tiny-serve", "tiny-moe"])
def test_float32_port_agrees_with_the_reference(root, name, tmp_path):
    """The port at float32 against the float32 reference: the widest gap
    is rounding, far below the bf16 runs' limit."""
    cell = spec.load_cell(root, name)
    cell.config = dict(cell.config, model=dict(cell.config["model"],
                                               dtype="float32"))
    out = cell_mod.run_cell(cell, SEED, 1.0, False, "cpu",
                            time.perf_counter(), control=True)
    r = out["readings"]
    if name == "tiny-moe":
        assert r["head_gap"] < 1e-4
        assert r["stage_err"] < 1e-5
        assert r["token_mismatch"] == 0
    else:
        assert r["logit_gap"] < 1e-4


class _Fault:
    """The port's decode step broken underneath the engine, at every step
    of the window (the warm-up makes 5 steps).  ``rows`` (lo, hi) are the
    shares of the batch a "half" or "layer" fault takes."""

    def __init__(self, monkeypatch, kind, at=6, rows=(0.5, 1.0)):
        from repro_torch.models import lm
        real, real_layer = lm.decode_step, lm.layer_decode
        self.calls = 0

        def span(n):
            return int(rows[0] * n), int(rows[1] * n)

        def broken(params, token, states, index, **kw):
            self.calls += 1
            hit = self.calls >= at
            if kind == "state" and hit:
                saved = [{k: v.clone() for k, v in st.items()}
                         for st in states]
            logits, states = real(params, token, states, index, **kw)
            if kind == "token" and hit:
                logits = -logits        # the least likely token wins
            elif kind == "half" and hit:
                # rows lo..hi served the logits of rows 0..hi-lo
                lo, hi = span(logits.shape[0])
                logits = logits.clone()
                logits[lo:hi] = logits[:hi - lo]
            elif kind == "state" and hit:
                for st, old in zip(states, saved):
                    for k in st:
                        st[k].copy_(old[k])
            return logits, states

        def layer_left_out(p, x, *a, **k):
            # every layer leaves rows lo..hi as they came in
            out = real_layer(p, x, *a, **k)
            if self.calls < at:
                return out
            lo, hi = span(x.shape[0])
            y = out[0].clone()
            y[lo:hi] = x[lo:hi]
            return (y,) + tuple(out[1:])
        monkeypatch.setattr(lm, "decode_step", broken)
        if kind == "layer":
            monkeypatch.setattr(lm, "layer_decode", layer_left_out)


@pytest.mark.parametrize("kind", ["token", "half", "state"])
@pytest.mark.parametrize("name", ["tiny-serve", "tiny-moe"])
def test_faults_make_correct_false(root, monkeypatch, name, kind):
    _Fault(monkeypatch, kind)
    out = _run(root, name)
    assert not out["correct"], out["checks"]
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("rows", [(0.5, 1.0), (0.75, 1.0)],
                         ids=["half", "quarter"])
@pytest.mark.parametrize("kind", ["half", "layer"],
                         ids=["logits", "layer"])
def test_a_fault_on_part_of_16_slots_makes_correct_false(
        root, monkeypatch, kind, rows):
    """A fault on slots 8-15, or on 12-15 alone, of a 16-slot MoE cell
    (its logits served from other rows, or every layer left out on those
    rows) fails the stage check."""
    _Fault(monkeypatch, kind, rows=rows)
    out = _run(root, "tiny-moe16")
    assert not out["correct"], out["checks"]
    assert out["checks"]["stage_err"]["value"] > \
        out["checks"]["stage_err"]["limit"]


@pytest.mark.parametrize("name", ["tiny-serve", "tiny-moe"])
def test_control_reads_above_the_limit(root, name):
    """The reference one precision step below bf16 (float8 e4m3
    activations) put in the program's place fails the limit the program
    meets."""
    out = _run(root, name, control=True)
    r = out["readings"]
    assert out["correct"]
    assert any(c["limit"] < r[f"control_{k}"]
               for k, c in out["checks"].items() if f"control_{k}" in r)


def test_limits_files_name_the_numbers_the_checks_read():
    for w in json.loads((_tiny.REPO / "BENCHMARK.json").read_text())[
            "workloads"]:
        lim = spec.load_json(_tiny.REPO / "bench" / "limits" /
                             f"{w['name']}.json")
        stages = lim.get("follow") == "stages"
        compared = {"stage_err", "token_mismatch"} if stages else \
            {"logit_gap"}
        assert set(lim["limits"]) >= compared | {"schedule_steps", "failed"}
        assert stages or lim["sample_tokens"] > 0
