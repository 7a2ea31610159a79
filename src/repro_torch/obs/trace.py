"""Span-based tracing with a bounded ring buffer (a copy of `repro.obs.trace`,
kept in the port so that it imports nothing of the JAX package).

Two time domains share one event stream, mirroring how the repo models
CoMeFa (a wall-clock simulator of a cycle-priced machine):

  * **wall-clock spans** (`span(name, **attrs)`) - real microseconds of
    the Python process: program encode, engine dispatch, host-state
    syncs, serving steps.  Emitted by ``with`` context managers that
    record on exit (exceptions included - the span closes, tagged with
    the exception type, and nesting stays consistent).  An
    `async_span(name, key, ...)` is the same on a timeline of its own,
    keyed by `key`: spans that overlap without nesting (a serving
    request's life beside its neighbours').
  * **model-time spans** (`model_span(name, start, duration, ...)`) -
    *modeled hardware cycles*: the per-tile load/compute/unload phases
    of a `schedule.Schedule` timeline, per-slot GEMV makespans.  The
    Chrome exporter puts them on their own process track with the
    1 cycle == 1 us convention, so LCU overlap is visible next to the
    wall-clock track in Perfetto.

Tracing is OFF by default and must stay near-free when off: `span()`
returns a shared no-op context manager without touching the ring buffer
or the clock.  Arm it with the environment variable::

    REPRO_TORCH_TRACE=trace.json python ...

which enables the global tracer and registers an atexit flush of the
Chrome trace-event JSON to that path, or programmatically via
`configure(enabled=True, path=...)` + `flush()`.

The ring buffer (`collections.deque(maxlen=...)`) bounds memory: a
long-running traced sweep keeps the most recent `capacity` events.

Wall-clock times are microseconds from the tracer's origin, a reading of
`time.perf_counter_ns` taken beside one of `time.time_ns` (at
construction and at `Tracer.clear`).  The Unix reading,
`Tracer.origin_unix_ns`, places the spans on the clock `torch.profiler`
stamps its events on (`export.merge_chrome_traces`).
"""
from __future__ import annotations

import atexit
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

ENV_VAR = "REPRO_TORCH_TRACE"
DEFAULT_CAPACITY = 65536

WALL_TRACK = "wall"
MODEL_TRACK = "model"


class TraceEvent:
    """One completed span.  ``ts``/``dur`` are microseconds on the wall
    track and modeled cycles on the model track.  ``async_id`` is the
    key of an `async_span` (None for a nesting span)."""

    __slots__ = ("name", "track", "tid", "ts", "dur", "attrs", "async_id")

    def __init__(self, name: str, track: str, tid: int, ts: float,
                 dur: float, attrs: Optional[Dict] = None,
                 async_id=None):
        self.name = name
        self.track = track
        self.tid = tid
        self.ts = ts
        self.dur = dur
        self.attrs = attrs or {}
        self.async_id = async_id

    def __repr__(self):
        return (f"TraceEvent({self.name!r}, {self.track}, ts={self.ts:.1f},"
                f" dur={self.dur:.1f})")


class _NullSpan:
    """The disabled-mode span: enters, exits, records nothing.

    One shared instance serves every disabled `span()` call - no
    allocation, no clock read, no attribute storage.
    """

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def set(self, **attrs):
        return self


NULL_SPAN = _NullSpan()


class _Span:
    """A live wall-clock span; records into the tracer on exit."""

    __slots__ = ("_tracer", "name", "attrs", "_start", "_async_id")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict,
                 async_id=None):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self._async_id = async_id

    def __enter__(self):
        self._start = time.perf_counter_ns()
        return self

    def set(self, **attrs):
        """Attach attributes mid-span (e.g. a cycle count known at end)."""
        self.attrs.update(attrs)
        return self

    def __exit__(self, exc_type, exc, tb):
        # record even when unwinding: the span closed, nesting holds,
        # and the event carries the exception type for the timeline
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        self._tracer._record(self.name, self._start,
                             time.perf_counter_ns(), self.attrs,
                             self._async_id)
        return False


class Tracer:
    """A bounded ring buffer of spans plus the enabled/off switch."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 enabled: bool = False):
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=capacity)
        self.enabled = enabled
        self.path: Optional[str] = None
        self._set_origin()

    def _set_origin(self) -> None:
        """The origin pair: `time.time_ns` between two reads of
        `time.perf_counter_ns`, whose midpoint is the origin."""
        before = time.perf_counter_ns()
        self.origin_unix_ns = time.time_ns()
        self._t0 = (before + time.perf_counter_ns()) // 2

    @property
    def capacity(self) -> int:
        return self._events.maxlen

    def set_capacity(self, capacity: int) -> None:
        with self._lock:
            self._events = deque(self._events, maxlen=capacity)

    # -- emission ----------------------------------------------------------
    def span(self, name: str, **attrs):
        """Wall-clock span context manager (no-op singleton when off)."""
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, attrs)

    def async_span(self, name: str, key, **attrs):
        """A wall-clock span that need not nest in the spans open around
        it: opened and closed on its own (``__enter__``/``__exit__``),
        and exported on a timeline of its own keyed by `key`."""
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, attrs, key)

    def _record(self, name: str, start: int, end: int, attrs: Dict,
                async_id=None) -> None:
        ev = TraceEvent(name, WALL_TRACK, threading.get_ident(),
                        (start - self._t0) / 1e3, (end - start) / 1e3,
                        attrs, async_id)
        with self._lock:
            self._events.append(ev)

    def model_span(self, name: str, start: float, duration: float,
                   track_id: int = 0, **attrs) -> None:
        """Cycle-domain span (ts/dur in modeled cycles, not seconds).

        ``track_id`` separates concurrent model timelines - e.g. one
        lane per grid slot so per-slot schedules render side by side.
        """
        if not self.enabled:
            return
        ev = TraceEvent(name, MODEL_TRACK, track_id, float(start),
                        float(duration), attrs)
        with self._lock:
            self._events.append(ev)

    # -- consumption -------------------------------------------------------
    def events(self) -> List[TraceEvent]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        """Drop every event and take a new origin."""
        with self._lock:
            self._events.clear()
            self._set_origin()

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)


# ---------------------------------------------------------------------------
# the global tracer + env/config plumbing
# ---------------------------------------------------------------------------

_TRACER = Tracer()
_atexit_registered = False


def get_tracer() -> Tracer:
    return _TRACER


def enabled() -> bool:
    return _TRACER.enabled


def span(name: str, **attrs):
    """Module-level shortcut onto the global tracer (hot-path form)."""
    t = _TRACER
    if not t.enabled:
        return NULL_SPAN
    return _Span(t, name, attrs)


def async_span(name: str, key, **attrs):
    """Module-level shortcut onto the global tracer's `async_span`."""
    return _TRACER.async_span(name, key, **attrs)


def model_span(name: str, start: float, duration: float,
               track_id: int = 0, **attrs) -> None:
    t = _TRACER
    if t.enabled:
        t.model_span(name, start, duration, track_id=track_id, **attrs)


def configure(enabled: Optional[bool] = None, path: Optional[str] = None,
              capacity: Optional[int] = None) -> Tracer:
    """Adjust the global tracer; returns it.

    ``path`` sets where `flush()` (and the atexit hook, when armed via
    the env var) writes the Chrome trace.  Passing ``enabled=False``
    also keeps the buffer intact - call `Tracer.clear` to drop events.
    """
    if capacity is not None:
        _TRACER.set_capacity(capacity)
    if path is not None:
        _TRACER.path = path
    if enabled is not None:
        _TRACER.enabled = enabled
    return _TRACER


def configure_from_env() -> bool:
    """Arm the global tracer from ``REPRO_TORCH_TRACE``, if set.

    Returns True when tracing was enabled.  Registers a single atexit
    flush so a traced process writes its Chrome trace on clean exit
    without any code changes at the call sites.
    """
    global _atexit_registered
    path = os.environ.get(ENV_VAR, "").strip()
    if not path:
        return False
    configure(enabled=True, path=path)
    if not _atexit_registered:
        atexit.register(_flush_at_exit)
        _atexit_registered = True
    return True


def _flush_at_exit() -> None:  # pragma: no cover - process teardown
    try:
        if _TRACER.enabled and _TRACER.path:
            flush()
    except Exception:
        pass


def flush(path: Optional[str] = None) -> Optional[str]:
    """Write the buffered events as Chrome trace JSON; returns the path.

    Uses ``path``, else the configured tracer path; no-op (returns
    None) when neither is set.  The buffer is left intact so repeated
    flushes during a long sweep produce progressively fuller traces.
    """
    from . import export
    path = path or _TRACER.path
    if not path:
        return None
    export.write_chrome_trace(path)
    return path


# arm from the environment at import: any process started with
# REPRO_TORCH_TRACE=... traces from its first dispatch
configure_from_env()
