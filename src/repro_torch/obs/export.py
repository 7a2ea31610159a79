"""Exporters: Chrome trace-event JSON and flat metrics summaries (a copy of
`repro.obs.export`, kept in the port so that it imports nothing of the JAX
package).

`chrome_trace` converts the tracer's ring buffer into the Chrome
trace-event format (the JSON array flavour understood by Perfetto and
chrome://tracing).  Two synthetic processes separate the time domains:

  * pid 1, "wall-clock" - real microseconds, one tid per Python thread;
  * pid 2, "modeled-cycles (1 cycle = 1us)" - `Schedule` phase spans and
    other cycle-priced timelines, one tid per model track (e.g. per grid
    slot), with modeled cycles mapped 1:1 onto trace microseconds.

Open the file in https://ui.perfetto.dev: the load/compute/unload spans
of consecutive tiles visibly overlap on the model track (the paper's
Sec. IV-A LCU pipeline) while the wall-clock track shows what the
simulator paid to execute them.

The wall process's metadata carries the tracer's origin on the Unix
clock (``baseTimeNanoseconds`` in its ``process_name`` args), the clock
`torch.profiler` stamps its events on.  `merge_chrome_traces` uses it to
put the program's wall spans beside the profiler's host ops and device
kernels in one file: arm the tracer (``REPRO_TORCH_TRACE``), run the
work under `torch.profiler`, export both, merge.

`metrics_summary` flattens the metrics registry into the block embedded
in ``benchmarks/sim_speed.py --json`` (cache hit rates, host/device
crossings, per-engine dispatch counts) so the nightly artifact tracks
cache efficacy over time, not just wall-clock.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional

from . import metrics as metrics_mod
from . import trace as trace_mod

WALL_PID = 1
MODEL_PID = 2


def chrome_trace(events: Iterable[trace_mod.TraceEvent],
                 base_ns: Optional[int] = None) -> Dict:
    """Trace events -> a Chrome trace-event JSON object.

    Every span becomes a complete ("ph": "X") event, and an
    `async_span` a begin/end ("b"/"e") pair keyed by its ``async_id``,
    which viewers draw on a row of its own; metadata ("M") events name
    the two processes and their threads.  Wall tids (Python thread
    idents) are remapped to small stable integers in first-seen order
    so the JSON stays readable.  `base_ns`, the Unix time (ns) of the
    wall track's zero, goes into the wall process's metadata.
    """
    events = list(events)
    wall = {"name": "wall-clock"}
    if base_ns is not None:
        wall["baseTimeNanoseconds"] = int(base_ns)
    out: List[Dict] = [
        {"ph": "M", "pid": WALL_PID, "tid": 0, "name": "process_name",
         "args": wall},
        {"ph": "M", "pid": MODEL_PID, "tid": 0, "name": "process_name",
         "args": {"name": "modeled-cycles (1 cycle = 1us)"}},
    ]
    wall_tids: Dict[int, int] = {}
    model_tids = set()
    for ev in events:
        if ev.track == trace_mod.MODEL_TRACK:
            pid, tid = MODEL_PID, int(ev.tid)
            if tid not in model_tids:
                model_tids.add(tid)
                out.append({"ph": "M", "pid": pid, "tid": tid,
                            "name": "thread_name",
                            "args": {"name": f"model-track-{tid}"}})
        else:
            pid = WALL_PID
            tid = wall_tids.setdefault(ev.tid, len(wall_tids))
        entry = {"ph": "X", "pid": pid, "tid": tid, "name": ev.name,
                 "cat": ev.track, "ts": float(ev.ts)}
        if ev.async_id is None:
            entry["dur"] = float(ev.dur)
        else:
            entry.update(ph="b", id=_jsonable(ev.async_id))
            end = dict(entry, ph="e", ts=float(ev.ts + ev.dur))
        if ev.attrs:
            entry["args"] = {k: _jsonable(v) for k, v in ev.attrs.items()}
        out.append(entry)
        if ev.async_id is not None:
            out.append(end)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    try:
        return int(v)          # numpy scalars and friends
    except (TypeError, ValueError):
        return repr(v)


def write_chrome_trace(path: str,
                       events: Optional[Iterable] = None) -> str:
    """Serialize (default: the global tracer's buffer, with its origin)
    to ``path``."""
    base_ns = None
    if events is None:
        tracer = trace_mod.get_tracer()
        events, base_ns = tracer.events(), tracer.origin_unix_ns
    with open(path, "w") as f:
        json.dump(chrome_trace(events, base_ns), f, indent=1)
        f.write("\n")
    return path


def merge_chrome_traces(program: str, profiler: str, out: str) -> str:
    """Write to `out` the Chrome trace `profiler` (a `torch.profiler`
    export) with the events of the Chrome trace `program` (this module's
    export) added: the wall process's spans moved onto the profiler's
    clock, the model-cycle process's left as they are.  The program's
    processes take pids after the profiler's largest, so that they do not
    land on a device's row.  Raises ValueError when `program` carries no
    wall origin."""
    with open(program) as f:
        prog = json.load(f)["traceEvents"]
    with open(profiler) as f:
        merged = json.load(f)
    base = next((e["args"].get("baseTimeNanoseconds") for e in prog
                 if e.get("ph") == "M" and e.get("pid") == WALL_PID
                 and e.get("name") == "process_name"), None)
    if base is None:
        raise ValueError(f"{program}: no baseTimeNanoseconds in the "
                         "wall process's metadata")
    # the profiler writes ts relative to its own base (absent: Unix time)
    shift = (base - merged.get("baseTimeNanoseconds", 0)) / 1e3
    pids = [e["pid"] for e in merged["traceEvents"]
            if isinstance(e.get("pid"), int)]
    offset = max(pids, default=0)
    for e in prog:
        e = dict(e, pid=e["pid"] + offset)
        if e["pid"] == WALL_PID + offset:
            if e["ph"] == "M":      # now on the file's own base
                e["args"] = {k: v for k, v in e["args"].items()
                             if k != "baseTimeNanoseconds"}
            else:
                e["ts"] += shift
        merged["traceEvents"].append(e)
    with open(out, "w") as f:
        json.dump(merged, f)
        f.write("\n")
    return out


# ---------------------------------------------------------------------------
# metrics summaries (the `metrics` block of the nightly benchmark JSON)
# ---------------------------------------------------------------------------

def _series_total(snap: Dict, name: str, **labels) -> float:
    """Sum of a metric's series values matching the label subset."""
    entry = snap.get(name)
    if not entry:
        return 0
    want = {str(k): str(v) for k, v in labels.items()}
    total = 0
    for s in entry["series"]:
        if all(s["labels"].get(k) == v for k, v in want.items()):
            v = s["value"]
            total += v["sum"] if isinstance(v, dict) else v
    return total


def metrics_summary(snapshot: Optional[Dict] = None) -> Dict:
    """Flat counters plus a few derived health ratios.

    ``counters`` is the `metrics.flatten` view of the full snapshot;
    ``derived`` adds the rates dashboards actually chart: encode /
    device-matrix / specialization / plan cache hit rates, total
    host-boundary crossings, and the adaptive recode selection
    histogram (``{choice: count}`` of per-chunk winners).
    """
    snap = metrics_mod.snapshot() if snapshot is None else snapshot
    derived: Dict[str, object] = {}
    for rate, hit, miss in (
            ("encode_cache_hit_rate", "hits", "misses"),
            ("device_mat_cache_hit_rate", "device_hits", "device_misses")):
        h = _series_total(snap, "comefa.encode_cache", event=hit)
        m = _series_total(snap, "comefa.encode_cache", event=miss)
        if h + m:
            derived[rate] = h / (h + m)
    for rate, name in (("spec_cache_hit_rate", "comefa.spec_cache"),
                       ("plan_cache_hit_rate", "comefa.plan_cache")):
        h = _series_total(snap, name, event="hits")
        m = _series_total(snap, name, event="misses")
        if h + m:
            derived[rate] = h / (h + m)
    sel = snap.get("comefa.recode_selected")
    if sel and sel["series"]:
        derived["recode_selection"] = {
            s["labels"].get("choice", ""): s["value"] for s in sel["series"]}
    for name in ("comefa.host_syncs", "comefa.device_puts",
                 "comefa.dispatches", "comefa.dispatch_cycles"):
        total = _series_total(snap, name)
        if total:
            derived[f"{name.split('.', 1)[1]}_total"] = total
    return {"counters": metrics_mod.flatten(snap), "derived": derived}
