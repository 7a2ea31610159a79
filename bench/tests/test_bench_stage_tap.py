"""The harness's taps, which must be right whether a step runs eagerly or
is replayed from a CUDA graph: a tap's copy takes its row from a
one-element tensor on the device when the copy runs (a replay runs the
copy the capture recorded, with no Python), the row is clamped on the
host, and a tiny MoE cell served through the captured step reads as the
same requests served eagerly."""
import time
from types import SimpleNamespace

import pytest
import torch

from bench.harness import cell as cell_mod
from bench.harness import spec
from bench.tests import _tiny

CPU = torch.device("cpu")
SEED = 2 ** 31 + 909091


def _io(step: int):
    x = torch.full((2, 1, 3), float(step))
    return x, x + 100


def test_a_tap_writes_the_row_the_device_index_holds_when_it_runs():
    log = cell_mod.StageLog(steps=4, n_layers=1, device=CPU)
    layer = object()
    log.start_step()
    log.layer_io(layer, *_io(0))
    # a replay: the host's step number stays where it was, and only the
    # tensor the copies read has moved on
    log.row.t.fill_(2)
    log.layer_io(layer, *_io(7))
    assert log.step == 0
    assert log.io[0, :, 0, 0, 0].tolist() == [0.0, 100.0]
    assert log.io[2, :, 0, 0, 0].tolist() == [7.0, 107.0]


def test_an_index_past_the_end_is_clamped_on_the_host():
    log = cell_mod.StageLog(steps=3, n_layers=1, device=CPU)
    layer = object()
    for step in range(5):
        log.start_step()
        log.layer_io(layer, *_io(step))
    # steps 3 and 4 went to the spill row, which no reader takes
    assert log.row.value == 3 and int(log.row.t) == 3
    assert log.io[:3, 0, 0, 0, 0].tolist() == [0.0, 1.0, 2.0]
    assert log.io[3, 0, 0, 0, 0].item() == 4.0
    log.row.set(-5)
    assert int(log.row.t) == 0


def test_the_moe_tap_keeps_each_profiled_steps_input_in_its_row():
    """Steps 1 and 2 of 5 profiled: the tap keeps their inputs in rows 0
    and 1 and counts two steps; the other steps spill."""
    tap = cell_mod.MoeTap(2, CPU)
    params = SimpleNamespace(router={"w": torch.zeros(3, 4)})
    window = SimpleNamespace(active=False, seen=0, first=1)
    for step in range(5):
        tap.collect()
        window.seen, window.active = step + 1, 1 <= step < 3
        tap.start_step(window)
        x = torch.full((2, 1, 3), float(step))
        out, _ = tap(lambda p, x, cfg: (2 * x, None), params, x, None)
        assert out.equal(2 * x)
    tap.collect()
    (router_w, inputs), = tap.inputs()
    assert router_w is params.router["w"]
    assert tap.steps == 2 and inputs[:, 0, 0, 0].tolist() == [1.0, 2.0]
    assert tap.seconds == 0.0       # no timing events off the card


@pytest.mark.cuda
def test_tiny_moe_served_from_the_captured_step_reads_as_eager(
        tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.serve import engine
    cell = spec.load_cell(_tiny.tiny_root(tmp_path), "tiny-moe")

    def run():
        return cell_mod.run_cell(cell, SEED, 2.0, True, "cuda",
                                 time.perf_counter(), control=True)
    graph = run()
    monkeypatch.setattr(engine, "_step_graph", lambda *a, **k: None)
    eager = run()
    share = "serve.captured_step_share"
    assert graph["metrics"][share]["value"] == 100.0
    assert eager["metrics"][share]["value"] == 0.0
    for out in (graph, eager):
        assert out["correct"], out["checks"]
        assert out["metrics"]["moe_apply_roofline"]["value"] > 0
    for k in ("stage_err", "token_mismatch"):
        assert graph["readings"][k] == eager["readings"][k], k
