"""Structured counter/gauge/histogram registry (zero-dependency; a copy of
`repro.obs.metrics`, kept in the port so that it imports nothing of the JAX
package).

One process-wide default `Registry` holds every metric the CoMeFa stack
emits: encode-cache hits, host/device state crossings, per-engine
dispatch counts, serving steps.  Metrics are named, carry string labels
(``counter("comefa.dispatches").inc(kind="grid", engine="packed")``),
and are thread-safe behind one registry lock.

Two operations make the registry test- and benchmark-friendly:

  * ``snapshot()`` - a plain-dict copy of every series (JSON-ready; the
    nightly artifact embeds it via `obs.export.metrics_summary`);
  * ``reset()``    - zero every series while keeping the metric handles
    modules captured at import time valid.  Autouse-fixture friendly:
    the legacy module-level ``block.ENCODE_CACHE_STATS`` accumulated
    across tests with no reset path; registry-backed counters reset in
    one call.

Handles are cheap and idempotent: ``counter(name)`` returns the same
object for the same name, so instrumentation sites can either hold a
module-level handle (hot paths) or look up by name at call time.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict) -> LabelKey:
    """Canonical hashable form of a label set (sorted, stringified)."""
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Metric:
    """Base: one named metric holding per-label-set series."""

    kind = "metric"

    def __init__(self, name: str, registry: "Registry"):
        self.name = name
        self._lock = registry._lock
        self._series: Dict[LabelKey, object] = {}

    def _reset(self) -> None:
        with self._lock:
            self._series.clear()

    def label_sets(self) -> List[Dict[str, str]]:
        with self._lock:
            return [dict(k) for k in self._series]

    def series(self) -> Dict[LabelKey, object]:
        """Copy of the raw {label_key: value} mapping."""
        with self._lock:
            return dict(self._series)


class Counter(Metric):
    """Monotonically increasing count, one value per label set."""

    kind = "counter"

    def inc(self, value: float = 1, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0) + value

    def set(self, value: float, **labels) -> None:
        """Overwrite a series value.

        Exists for absorbing legacy mutable-dict stats (tests reset
        `ENCODE_CACHE_STATS` keys to 0 in place); new instrumentation
        should `inc` and use `Registry.reset` for zeroing.
        """
        with self._lock:
            self._series[_label_key(labels)] = value

    def value(self, **labels) -> float:
        with self._lock:
            return self._series.get(_label_key(labels), 0)


class Gauge(Metric):
    """Last-write-wins instantaneous value, one per label set."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._series[_label_key(labels)] = value

    def add(self, value: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0) + value

    def value(self, **labels) -> float:
        with self._lock:
            return self._series.get(_label_key(labels), 0)


class Histogram(Metric):
    """Running count/sum/min/max aggregate per label set.

    Deliberately bucket-free: the consumers here (nightly JSON, tests)
    want cheap summary stats, not quantile sketches.
    """

    kind = "histogram"

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            agg = self._series.get(key)
            if agg is None:
                self._series[key] = {"count": 1, "sum": value,
                                     "min": value, "max": value}
            else:
                agg["count"] += 1
                agg["sum"] += value
                agg["min"] = min(agg["min"], value)
                agg["max"] = max(agg["max"], value)

    def value(self, **labels) -> Dict[str, float]:
        with self._lock:
            agg = self._series.get(_label_key(labels))
            return dict(agg) if agg else {"count": 0, "sum": 0,
                                          "min": 0, "max": 0}


class Registry:
    """Named metrics, one lock, snapshot/reset lifecycle."""

    _KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[str, Metric] = {}

    def _get(self, name: str, cls) -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, self)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self) -> Dict[str, Dict]:
        """JSON-ready copy: {name: {"kind", "series": [{labels, value}]}}.

        Empty metrics (registered but never incremented, or reset) are
        omitted so the snapshot reflects what actually happened.
        """
        with self._lock:
            out: Dict[str, Dict] = {}
            for name in sorted(self._metrics):
                m = self._metrics[name]
                if not m._series:
                    continue
                out[name] = {
                    "kind": m.kind,
                    "series": [
                        {"labels": dict(k),
                         "value": (dict(v) if isinstance(v, dict) else v)}
                        for k, v in sorted(m._series.items())],
                }
            return out

    def reset(self) -> None:
        """Zero every series.  Metric handles stay valid."""
        with self._lock:
            for m in self._metrics.values():
                m._reset()


def flatten(snapshot: Dict[str, Dict]) -> Dict[str, object]:
    """Snapshot -> flat ``name{k=v,...}: value`` mapping (artifact rows)."""
    flat: Dict[str, object] = {}
    for name, entry in snapshot.items():
        for s in entry["series"]:
            labels = s["labels"]
            tag = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
            flat[f"{name}{{{tag}}}" if tag else name] = s["value"]
    return flat


# ---------------------------------------------------------------------------
# the process-wide default registry (what the CoMeFa stack reports through)
# ---------------------------------------------------------------------------

_DEFAULT = Registry()


def default_registry() -> Registry:
    return _DEFAULT


def counter(name: str) -> Counter:
    return _DEFAULT.counter(name)


def gauge(name: str) -> Gauge:
    return _DEFAULT.gauge(name)


def histogram(name: str) -> Histogram:
    return _DEFAULT.histogram(name)


def snapshot() -> Dict[str, Dict]:
    return _DEFAULT.snapshot()


def reset() -> None:
    _DEFAULT.reset()
