"""The port's serving spans and their Chrome export.

`serve_continuous` splits each step into four wall spans (admission, the
model step's dispatch, the readback, the per-row advance), and opens one
`serve.request` span per request that need not nest.  The exporter
writes those as async events and carries the tracer's origin on the Unix
clock, which `merge_chrome_traces` uses to put the program's spans on a
`torch.profiler` trace's clock.
"""
import importlib.util
import json
import types
from collections import Counter, defaultdict
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.models import common as cm
from repro_torch.models import lm
from repro_torch.obs import export, trace
from repro_torch.serve import engine

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("serve.admit", "serve.batch_step", "serve.readback",
          "serve.advance")
SLOTS, MAX_LEN = 2, 10


@pytest.fixture(scope="module")
def model():
    cfg = cm.reduced(configs.get("smollm-360m"), n_layers=2, quant_bits=8)
    return lm.init(torch.Generator().manual_seed(0), cfg, "cpu")


@pytest.fixture
def tracer():
    """The global tracer, on and empty; off and empty afterwards."""
    t = trace.configure(enabled=True)
    t.clear()
    try:
        yield t
    finally:
        trace.configure(enabled=False)
        t.clear()


def _requests(seed=3, n=5):
    rng = np.random.default_rng(seed)
    return [engine.Request(rng.integers(0, 256, int(rng.integers(1, 5))),
                           int(rng.integers(2, 5))) for _ in range(n)]


def _serve(model, reqs, **kw):
    stats = {}
    out = engine.serve_continuous(model, reqs, slots=SLOTS, max_len=MAX_LEN,
                                  stats=stats, **kw)
    return out, stats


def test_each_step_is_four_phases_in_order(model, tracer):
    reqs = _requests()
    out, stats = _serve(model, reqs)
    by_step = defaultdict(dict)
    for ev in tracer.events():
        if ev.name in PHASES:
            assert ev.name not in by_step[ev.attrs["step"]]
            by_step[ev.attrs["step"]][ev.name] = ev
    assert sorted(by_step) == list(range(1, stats["steps"] + 1))
    prev_end = -np.inf
    for s in sorted(by_step):
        assert list(by_step[s]) == list(PHASES)
        for name in PHASES:            # in order, none overlapping
            ev = by_step[s][name]
            assert ev.ts >= prev_end - 1e-3, (s, name)
            prev_end = ev.ts + ev.dur
    admit = [by_step[s]["serve.admit"].attrs for s in sorted(by_step)]
    advance = [by_step[s]["serve.advance"].attrs for s in sorted(by_step)]
    assert sum(a["admitted"] for a in admit) == len(reqs)
    assert admit[0]["admitted"] == SLOTS
    assert admit[0]["queued"] == len(reqs) - SLOTS
    assert admit[-1]["queued"] == 0
    assert sum(a["emitted"] for a in advance) == sum(len(o) for o in out)
    assert sum(a["retired"] for a in advance) == len(reqs)
    assert sum(by_step[s]["serve.batch_step"].attrs["live"]
               for s in by_step) == stats["slot_steps"]


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_tokens_equal_with_the_tracer_on_and_off(model, temperature):
    reqs = _requests(seed=5, n=6)

    def gen():
        return torch.Generator().manual_seed(11) if temperature else None
    off, _ = _serve(model, reqs, temperature=temperature, generator=gen())
    t = trace.configure(enabled=True)
    try:
        on, _ = _serve(model, reqs, temperature=temperature,
                       generator=gen())
        assert len(t) > 0
    finally:
        trace.configure(enabled=False)
        t.clear()
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_tracer_off_records_nothing(model):
    t = trace.get_tracer()
    t.clear()
    assert not t.enabled
    _serve(model, _requests())
    assert len(t) == 0


def _load_reader(name):
    path = ROOT / "bench" / "end_to_end" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"reader_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_request_spans_run_from_admission_to_retirement(model, tracer):
    """Each `serve.request` is a wall-track event with its request's
    whole life as its duration: it opens inside the `serve.admit` of the
    step that admits it and closes inside the `serve.advance` of the step
    that emits its last token (prompt + steps - 1 steps later, one token
    a step).  `serve_request_p95_s` reads those durations."""
    reqs = _requests(seed=7, n=7)
    _serve(model, reqs)
    events = tracer.events()
    phase = {(ev.name, ev.attrs["step"]): ev for ev in events
             if ev.name in PHASES}
    spans = [ev for ev in events if ev.name == "serve.request"]
    assert sorted(ev.async_id for ev in spans) == list(range(len(reqs)))
    for ev in spans:
        assert ev.track == trace.WALL_TRACK
        req = reqs[ev.async_id]
        first = next(s for (n, s), p in phase.items() if n == "serve.admit"
                     and p.ts <= ev.ts <= p.ts + p.dur)
        last = phase["serve.advance",
                     first + len(req.prompt) + req.steps - 2]
        assert last.ts <= ev.ts + ev.dur <= last.ts + last.dur + 1e-3
    reader = _load_reader("serve_request_p95_s")
    run = types.SimpleNamespace(spans_named=lambda name: [
        e for e in events if e.name == name])
    durations = sorted(ev.dur / 1e6 for ev in spans)
    assert reader.read(run) == durations[int(np.ceil(0.95 * len(spans))) - 1]


def test_overlapping_requests_export_as_async_pairs(model, tracer):
    reqs = _requests(seed=9, n=5)
    _serve(model, reqs)
    events = export.chrome_trace(tracer.events())["traceEvents"]
    mine = [e for e in events if e["name"] == "serve.request"]
    assert Counter((e["ph"], e["id"]) for e in mine) == Counter(
        {(ph, rid): 1 for ph in "be" for rid in range(len(reqs))})
    begins = {e["id"]: e for e in mine if e["ph"] == "b"}
    ends = {e["id"]: e for e in mine if e["ph"] == "e"}
    spans = {ev.async_id: ev for ev in tracer.events()
             if ev.name == "serve.request"}
    for rid, b in begins.items():
        assert b["pid"] == export.WALL_PID and b["cat"] == trace.WALL_TRACK
        assert b["ts"] == spans[rid].ts and b["args"]["request"] == rid
        assert ends[rid]["ts"] == pytest.approx(spans[rid].ts +
                                                spans[rid].dur)
    # the rows overlap: some request opens while another one is open
    assert any(begins[a]["ts"] < begins[b]["ts"] < ends[a]["ts"]
               for a in begins for b in begins if a != b)
    # the phase spans nest and stay complete events
    assert {e["ph"] for e in events if e["name"] in PHASES} == {"X"}


def test_merge_puts_program_spans_on_the_profilers_clock(tmp_path, tracer):
    from torch.profiler import ProfilerActivity, profile, record_function
    x = torch.randn(32, 32)
    with record_function("warm"):     # the first range sets things up
        x @ x
    tracer.model_span("cycles", 5.0, 7.0, track_id=1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("program.around"):
            with record_function("probe"):
                for _ in range(20):
                    x = torch.tanh(x @ x)
    prof.export_chrome_trace(str(tmp_path / "profiler.json"))
    program = export.write_chrome_trace(str(tmp_path / "program.json"))
    out = export.merge_chrome_traces(program, str(tmp_path / "profiler.json"),
                                     str(tmp_path / "merged.json"))
    merged = json.loads(Path(out).read_text())
    events = merged["traceEvents"]
    probe = next(e for e in events if e.get("name") == "probe"
                 and e.get("ph") == "X")
    around = next(e for e in events if e.get("name") == "program.around")
    assert abs(around["ts"] - probe["ts"]) < 1000.0        # 1 ms, in us
    assert around["pid"] != probe["pid"]
    # the model-cycle process keeps its cycles
    cycles = next(e for e in events if e.get("name") == "cycles")
    assert (cycles["ts"], cycles["dur"]) == (5.0, 7.0)
    assert cycles["pid"] == around["pid"] + 1
    # the profiler's own events and keys are as it wrote them
    want = json.loads((tmp_path / "profiler.json").read_text())
    assert merged["baseTimeNanoseconds"] == want["baseTimeNanoseconds"]
    assert events[:len(want["traceEvents"])] == want["traceEvents"]


def test_export_carries_the_wall_origin(tracer):
    with trace.span("a"):
        pass
    meta = export.chrome_trace(tracer.events(), tracer.origin_unix_ns)
    wall = next(e for e in meta["traceEvents"] if e["ph"] == "M"
                and e["pid"] == export.WALL_PID)
    assert wall["args"]["baseTimeNanoseconds"] == tracer.origin_unix_ns
    assert "baseTimeNanoseconds" not in export.chrome_trace(
        tracer.events())["traceEvents"][0]["args"]


def test_merge_refuses_a_program_trace_without_an_origin(tmp_path, tracer):
    with trace.span("a"):
        pass
    old = tmp_path / "old.json"
    old.write_text(json.dumps(export.chrome_trace(tracer.events())))
    prof = tmp_path / "prof.json"
    prof.write_text(json.dumps({"traceEvents": []}))
    with pytest.raises(ValueError, match="baseTimeNanoseconds"):
        export.merge_chrome_traces(str(old), str(prof),
                                   str(tmp_path / "m.json"))
