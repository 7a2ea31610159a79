"""One run of one cell: set-up, warm-up, the measured window, the
metrics, and the judgement of what the window served.

The window is one call of the port's `serve.engine.serve_continuous`
over the run's requests (`traffic`).  End-to-end metrics (``--trace 0``) read the host
clock around it; per-layer metrics (``--trace 1``) read the port's spans
and counters over the whole window and a device trace over whole steps
in its middle (`devtrace`).
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import devtrace, schedule, spec, traffic, weights
from . import check as check_mod

PROFILED_STEPS = 16
SPAN_CAPACITY = 4_000_000


@dataclasses.dataclass
class Run:
    """What the readers of metrics see."""
    cell: spec.Cell
    cfg: object                       # the port's Config
    seed: int
    setup_s: float
    window_s: float
    requests: List[traffic.Req]
    outputs: List[np.ndarray]
    stats: dict
    sched: schedule.Schedule
    projections: List[tuple]          # (name, K, N) of packed projections
    counters: Dict[str, float]
    spans: Optional[list] = None      # the port's wall spans
    trace: Optional[devtrace.DeviceTrace] = None
    moe_tap: Optional[MoeTap] = None
    layer_log: Optional[StageLog] = None
    float_weights: Optional[dict] = None
    memory_peak_bytes: int = 0

    @property
    def tokens(self) -> int:
        return int(sum(len(o) for o in self.outputs))

    @property
    def slots(self) -> int:
        return int(self.cell.mix["slots"])

    def spans_named(self, name: str, outside_profile: bool = False):
        """The window's spans called `name`; with `outside_profile`, only
        those that start outside the profiled steps."""
        found = [s for s in self.spans or () if s.name == name]
        if outside_profile and self.trace is not None:
            lo, hi = self.profiled_span()
            found = [s for s in found if not lo <= s.ts < hi]
        return found

    def step_starts(self) -> Dict[int, float]:
        """0-based step -> start of its `serve.batch_step` span (us)."""
        return {int(s.attrs["step"]) - 1: s.ts
                for s in self.spans_named("serve.batch_step")}

    def profiled_span(self):
        """[start, end) in the spans' clock of the profiled steps."""
        starts = self.step_starts()
        a = self.trace.first_step
        b = a + self.trace.steps
        return starts[a], starts.get(b, float("inf"))

    def counter(self, name: str) -> float:
        return self.counters.get(name, 0.0)


def _counter_totals() -> Dict[str, float]:
    """Every counter of the port's registry: its total under its name,
    and each labelled series as ``name{k=v,...}``."""
    from repro_torch.obs import metrics as obs_metrics
    out: Dict[str, float] = {}
    for name, entry in obs_metrics.snapshot().items():
        if entry["kind"] != "counter":
            continue
        for s in entry["series"]:
            out[name] = out.get(name, 0.0) + float(s["value"])
            if s["labels"]:
                tag = ",".join(f"{k}={v}" for k, v in
                               sorted(s["labels"].items()))
                out[f"{name}{{{tag}}}"] = float(s["value"])
    return out


class DeviceRow:
    """A row number kept in a one-element long tensor on the device, for
    copies that index a buffer by it (``index_copy_``): a copy recorded
    once in a captured step reads the tensor at each replay, and so lands
    on the row current then.  `set` writes it from the host (``fill_``,
    only when it changes) and clamps there: past the last of `rows` rows
    it points at a spill row (row `rows`), which no reader takes, since
    an index out of range on the device would end the run."""

    def __init__(self, rows: int, device: torch.device):
        self.rows, self.value = rows, rows
        self.t = torch.full((1,), rows, dtype=torch.long, device=device)

    def set(self, i: int) -> None:
        i = min(max(i, 0), self.rows)
        if i != self.value:
            self.t.fill_(i)
            self.value = i

    def buffer(self, x: torch.Tensor) -> torch.Tensor:
        """An empty buffer of `rows` + 1 rows shaped like `x`."""
        return x.new_empty((self.rows + 1,) + tuple(x.shape))

    def copy(self, buf: torch.Tensor, x: torch.Tensor) -> None:
        buf.index_copy_(0, self.t, x[None])


class StageLog:
    """Each step's layer inputs, the last layer's output and the logits,
    for a check that follows the served model stage by stage: copied
    into buffers of `steps` steps (and a spill row) that the first step
    run allocates (in the warm-up, eagerly), so that the window allocates
    nothing for it and keeps no tensor of the program alive.  The layer
    copies go through a `DeviceRow` that the step wrapper sets, so that
    they are right in a step replayed from a CUDA graph as in an eager
    one; a layer's place is found by the identity of its params, not by
    counting calls (a capture runs the step twice)."""

    def __init__(self, steps: int, n_layers: int, device: torch.device):
        self.steps, self.n_layers = steps, n_layers
        self.row = DeviceRow(steps, device)
        self.io = self.logits = None   # [steps + 1, n_layers + 1, ...]
        self.layer_of: Dict[int, int] = {}
        self.step = -1

    def rewind(self) -> None:
        self.step = -1

    def start_step(self) -> None:
        self.step += 1
        self.row.set(self.step)

    def layer_io(self, p, x: torch.Tensor, out: torch.Tensor) -> None:
        """Layer `p` took `x` and gave `out`: `x` is kept for the first
        layer only (the embedding's output), `out` for every layer."""
        j = self.layer_of.setdefault(id(p), len(self.layer_of))
        if self.io is None:
            self.io = x.new_empty((self.steps + 1, self.n_layers + 1) +
                                  tuple(x.shape))
        if j == 0:
            self.row.copy(self.io[:, 0], x)
        self.row.copy(self.io[:, j + 1], out)

    def step_logits(self, t: torch.Tensor) -> None:
        if self.logits is None:
            self.logits = self.row.buffer(t)
        self.row.copy(self.logits, t)


class MoeTap:
    """In traced runs, what `moe_apply_roofline` reads of each MoE layer
    over the profiled steps: its input, copied into a buffer of
    `PROFILED_STEPS` rows through a `DeviceRow`, and the device time of
    its call, between two timing events recorded around it
    (``external``, so that a capture records them as graph nodes).  In a
    step replayed from a CUDA graph both run inside the replay; the
    events of a profiled step are read at the next step's start
    (`collect`), when the engine's readback has already waited for it."""

    def __init__(self, rows: int, device: torch.device):
        self.row = DeviceRow(rows, device)
        # id(params) -> (router weight, inputs, start event, end event)
        self.layers: Dict[int, tuple] = {}
        self.pending = False
        self.steps, self.seconds = 0, 0.0

    def start_step(self, window: devtrace.StepWindow) -> None:
        """Before a step: its row if the profiler is on, else spill."""
        self.pending = window.active
        self.row.set(window.seen - 1 - window.first if self.pending
                     else self.row.rows)

    def collect(self) -> None:
        if not self.pending:
            return
        self.pending = False
        for *_, start, end in self.layers.values():
            if start is not None:
                end.synchronize()
                self.seconds += start.elapsed_time(end) / 1e3
        self.steps += 1

    def __call__(self, real, params, x, cfg):
        key = id(params)
        if key not in self.layers:
            timing = [torch.cuda.Event(enable_timing=True, external=True)
                      for _ in range(2)] if x.is_cuda else [None, None]
            self.layers[key] = (params.router["w"], self.row.buffer(x),
                                *timing)
        _, inputs, start, end = self.layers[key]
        self.row.copy(inputs, x)
        if start is not None:
            start.record()
        out = real(params, x, cfg)
        if end is not None:
            end.record()
        return out

    def inputs(self):
        """(router weight, [steps, ...] inputs) of each MoE layer over
        the steps collected."""
        return [(w, buf[:self.steps])
                for w, buf, *_ in self.layers.values()]


class _Wrapped:
    """Wrappers around the port's decode step, layer and MoE layer,
    restored on exit: with a `StepWindow`, the profiler's steps and the
    ``bench.*`` ranges; with a `StageLog` or a `MoeTap`, what they
    record.  The layer and MoE wrappers run when a step is captured as
    a CUDA graph, not when it is replayed, so the taps are installed
    before the warm-up, which captures it."""

    def __init__(self, window: Optional[devtrace.StepWindow],
                 moe: Optional[MoeTap], layer_log: Optional[StageLog]):
        self.window = window
        self.moe = moe
        self.layer_log = layer_log

    def __enter__(self):
        from repro_torch.models import ffn, lm
        self._lm, self._ffn = lm, ffn
        self._saved = (lm.decode_step, lm.layer_decode, ffn.moe_apply)
        real_step, real_layer, real_moe = self._saved
        window, moe, log = self.window, self.moe, self.layer_log

        def decode_step(*a, **k):
            if moe is not None:
                moe.collect()
            if log is not None:
                log.start_step()
            if window is None:
                out = real_step(*a, **k)
            else:
                window.step()
                if moe is not None:
                    moe.start_step(window)
                with torch.profiler.record_function("bench.decode_step"):
                    out = real_step(*a, **k)
            if log is not None:
                log.step_logits(out[0])
            return out

        def layer_decode(p, x, *a, **k):
            out = real_layer(p, x, *a, **k)
            log.layer_io(p, x, out[0])
            return out

        def moe_apply(params, x, cfg):
            with torch.profiler.record_function("bench.moe_apply"):
                return moe(real_moe, params, x, cfg)

        if window is not None or moe is not None or log is not None:
            lm.decode_step = decode_step
        if log is not None:
            lm.layer_decode = layer_decode
        if moe is not None:
            ffn.moe_apply = moe_apply
        return self

    def __exit__(self, *exc):
        (self._lm.decode_step, self._lm.layer_decode,
         self._ffn.moe_apply) = self._saved
        return False


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, control: bool = False) -> dict:
    """One run; returns the result line's fields (without `device`).
    With `control`, also the numbers compared and the control's beside
    them, under ``readings``."""
    result, run = execute(cell, seed, seconds, trace, device, t_start)
    t0 = time.perf_counter()
    got = check_mod.readings(cell, run, torch.device(device), control)
    print(f"check {time.perf_counter() - t0:.3f} s", file=sys.stderr)
    result.update(check_mod.judge(cell, got, len(run.requests)))
    if control:
        result["readings"] = got
    return result


def execute(cell: spec.Cell, seed: int, seconds: float, trace: bool,
            device: str, t_start: float):
    """Set-up, warm-up, the window and its metrics; returns (the result's
    fields so far, the `Run`), with the program's state freed."""
    from repro_torch.obs import trace as obs_trace
    from repro_torch.serve import engine
    dev = torch.device(device)
    mix, cfg = cell.mix, spec.port_config(cell.config)
    w = weights.build(cfg, seed, dev)
    slots, max_len = int(mix["slots"]), int(mix["max_len"])

    def serve(reqs, stats=None):
        return engine.serve_continuous(
            w.model, [engine.Request(r.prompt, r.steps) for r in reqs],
            slots=slots, max_len=max_len, stats=stats)

    reqs = traffic.requests(mix, seed, seconds, cfg.vocab)
    sched = schedule.simulate([(len(r.prompt), r.steps) for r in reqs],
                              slots)
    layer_log = StageLog(sched.steps, cfg.n_layers, dev) if \
        cell.limits.get("follow") == "stages" else None
    moe = MoeTap(PROFILED_STEPS, dev) if trace and any(
        f in ("moe", "moe_dense") for _, f in cfg.layer_kinds()) else None
    # the warm-up captures the step a replay runs: the taps go in first
    with _Wrapped(None, moe, layer_log):
        serve(traffic.warmup_requests(mix, cfg.vocab))
    _sync(dev)
    if layer_log is not None:
        layer_log.rewind()
    readers = [(m, cell.reader(m, trace)) for m in cell.metrics(trace)]
    spans_on = trace or any(getattr(r, "NEEDS_SPANS", False)
                            for _, r in readers)
    window = devtrace.StepWindow(
        max(0, sched.steps // 2 - PROFILED_STEPS // 2), PROFILED_STEPS, dev)
    obs_trace.configure(enabled=spans_on, capacity=SPAN_CAPACITY)
    obs_trace.get_tracer().clear()
    before = _counter_totals()
    stats: dict = {}
    setup_s = time.perf_counter() - t_start
    with _Wrapped(window if trace else None, moe, layer_log):
        _sync(dev)
        t0 = time.perf_counter()
        outputs = serve(reqs, stats)
        _sync(dev)
        window_s = time.perf_counter() - t0
    if moe is not None:
        moe.collect()
    after = _counter_totals()
    spans = [e for e in obs_trace.get_tracer().events()
             if e.track == obs_trace.WALL_TRACK] if spans_on else None
    obs_trace.configure(enabled=False)
    obs_trace.get_tracer().clear()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    run = Run(cell=cell, cfg=cfg, seed=seed, setup_s=setup_s,
              window_s=window_s, requests=reqs, outputs=outputs,
              stats=stats, sched=sched, projections=w.projections,
              counters={k: after.get(k, 0.0) - before.get(k, 0.0)
                        for k in after},
              spans=spans, trace=window.trace() if trace else None,
              moe_tap=moe, layer_log=layer_log,
              float_weights=w.float_weights,
              memory_peak_bytes=int(peak))
    metrics = {}
    for m, reader in readers:
        value = reader.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"metrics": metrics, "memory_peak_bytes": run.memory_peak_bytes}
    if trace and run.trace is not None:
        result["busy_s"] = run.trace.busy_s
        result["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    # free the program's state before the reference runs
    run.moe_tap = None
    del w.model, moe
    run.trace = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    print(f"window {window_s:.3f} s: {len(reqs)} requests, {run.tokens} "
          f"tokens, {stats.get('steps')} steps", file=sys.stderr)
    return result, run
