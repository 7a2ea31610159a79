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


def chrome_trace(events: Iterable[trace_mod.TraceEvent]) -> Dict:
    """Trace events -> a Chrome trace-event JSON object.

    Every span becomes a complete ("ph": "X") event; metadata ("M")
    events name the two processes and their threads.  Wall tids (Python
    thread idents) are remapped to small stable integers in first-seen
    order so the JSON stays readable.
    """
    events = list(events)
    out: List[Dict] = [
        {"ph": "M", "pid": WALL_PID, "tid": 0, "name": "process_name",
         "args": {"name": "wall-clock"}},
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
                 "cat": ev.track, "ts": float(ev.ts),
                 "dur": float(ev.dur)}
        if ev.attrs:
            entry["args"] = {k: _jsonable(v) for k, v in ev.attrs.items()}
        out.append(entry)
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
    """Serialize (default: the global tracer's buffer) to ``path``."""
    if events is None:
        events = trace_mod.get_tracer().events()
    with open(path, "w") as f:
        json.dump(chrome_trace(events), f, indent=1)
        f.write("\n")
    return path


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
