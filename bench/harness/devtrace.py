"""The device trace of a traced run: `torch.profiler` over whole batched
steps in the middle of the window.

The profiler records every host op and every device operation, so it
runs over `count` steps only (a whole window of eager decode steps holds
millions of events), started and stopped at step boundaries by a wrapper
around the port's `models.lm.decode_step`, with the device synchronised
at both ends (the engine reads each step's tokens back, so the device is
idle there anyway).  The harness opens `torch.profiler.record_function`
ranges named ``bench.*`` around the calls it wraps; a kernel is tied to
the range by the interval the profiler gives that range on the device.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

from ..metrics import arith

ANNOTATION = "bench."


class DeviceTrace:
    """What the profiled steps ran on the device.

    The profiler also puts each ``bench.*`` range on the device's
    timeline, from the first kernel launched inside it to the end of the
    last; a kernel lies in a range when it ran inside that interval.
    """

    def __init__(self, events, window_s: float, steps: int,
                 first_step: int):
        from torch.autograd import DeviceType
        self.window_s = window_s
        self.steps = steps
        self.first_step = first_step        # 0-based step index
        self.ops: List[Tuple[str, float, float]] = []
        self.ranges: Dict[str, List[Tuple[float, float]]] = defaultdict(
            list)
        host = []
        for e in events:
            s, t = e.time_range.start, e.time_range.end
            if e.device_type == DeviceType.CUDA:
                if e.name.startswith(ANNOTATION):
                    self.ranges[e.name].append((s, t))
                else:
                    self.ops.append((e.name, s, t))
            elif e.device_type == DeviceType.CPU and not e.is_async and (
                    e.cpu_parent is None or
                    e.cpu_parent.name.startswith(ANNOTATION)) and \
                    not e.name.startswith(ANNOTATION):
                host.append((s, t, e.name))
        self.ops.sort(key=lambda o: o[1])
        for v in self.ranges.values():
            v.sort()
        self.host = sorted(host)
        self.kernels = [o for o in self.ops if not o[0].startswith(
            ("Memcpy", "Memset"))]
        self.busy_s = arith.busy_union((s, e) for _, s, e in
                                       self.ops) / 1e6

    def time_s(self, names: Tuple[str, ...]) -> Tuple[int, float]:
        """(launches, device seconds) of the kernels whose name contains
        one of `names`."""
        hits = [o for o in self.kernels if any(n in o[0] for n in names)]
        return len(hits), sum(e - s for _, s, e in hits) / 1e6

    @staticmethod
    def _inside(spans, s: float, e: float) -> bool:
        i = bisect.bisect_right(spans, (s, float("inf"))) - 1
        return i >= 0 and spans[i][0] <= s and e <= spans[i][1]

    def within(self, annotation: str) -> Tuple[int, float]:
        """(launches, device seconds) of the kernels that ran inside the
        device interval of a range called `annotation`."""
        spans = self.ranges.get(annotation, [])
        hits = [o for o in self.kernels if self._inside(spans, o[1], o[2])]
        return len(hits), sum(e - s for _, s, e in hits) / 1e6

    def _label(self, t0: float, t1: float) -> str:
        """Where an idle gap [t0, t1) sits: the innermost range whose
        device interval holds it, and the top-level host op running at
        its middle ("python" between ops)."""
        inner = "(between steps)"
        for name in ("bench.decode_step", "bench.moe_apply"):
            if self._inside(self.ranges.get(name, []), t0, t1):
                inner = name
        mid = 0.5 * (t0 + t1)
        i = bisect.bisect_right(self.host, (mid, float("inf"), "")) - 1
        op = self.host[i][2] if i >= 0 and self.host[i][1] >= mid \
            else "python"
        return f"{inner} > {op}"

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time, and the idle gaps
        summed by where they sit (`_label`)."""
        by_op: Dict[str, float] = defaultdict(float)
        for name, s, e in self.ops:
            by_op[name[:120]] += (e - s) / 1e6
        by_gap: Dict[str, float] = defaultdict(float)
        for g0, g1 in arith.idle_gaps((s, e) for _, s, e in self.ops):
            by_gap[self._label(g0, g1)[:120]] += (g1 - g0) / 1e6
        rank = lambda d: [[k, v] for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(by_op), "idle_gaps": rank(by_gap)}


class StepWindow:
    """Starts the profiler before step `first` (0-based) and stops it
    before step `first + count`; `step()` is called at each step's
    start."""

    def __init__(self, first: int, count: int, device: torch.device):
        self.first, self.count = first, count
        self.device = device
        self.seen = 0
        self.prof = None
        self.t0 = self.t1 = None

    @property
    def active(self) -> bool:
        return self.prof is not None and self.t1 is None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self) -> None:
        if self.seen == self.first:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._sync()
            self.prof = profile(activities=acts)
            self.prof.start()
            self.t0 = time.perf_counter()
        elif self.seen == self.first + self.count and self.active:
            self.stop()
        self.seen += 1

    def stop(self) -> None:
        if self.active:
            self._sync()
            self.t1 = time.perf_counter()
            self.prof.stop()

    def trace(self) -> Optional[DeviceTrace]:
        if self.prof is None:
            return None
        self.stop()
        steps = min(self.count, self.seen - self.first)
        return DeviceTrace(self.prof.events(), self.t1 - self.t0, steps,
                           self.first)
