"""The phases of the window's serving steps, from the port's spans inside
`serve_continuous`: ``serve.admit``, ``serve.batch_step``,
``serve.readback`` and ``serve.advance``, each carrying the 1-based
``step`` of the ``serve.batch_step`` it belongs to.  Read by
`decode.dispatch_ms_per_step`, `decode.wait_ms_per_step` and
`serve.engine_ms_per_step`."""
from __future__ import annotations

from typing import List, Optional


def steps(run) -> List[int]:
    """The 0-based steps the means run over, as `decode_work.mfu` takes
    them: each step whose next one started in the window, less the steps
    the profiler ran over and the one that stopped it."""
    starts = run.step_starts()
    skip = range(0)
    if run.trace is not None:
        a = run.trace.first_step
        skip = range(a, a + run.trace.steps + 1)
    return [j for j in sorted(starts) if j + 1 in starts and j not in skip]


def ms_per_step(run, *names: str) -> Optional[float]:
    """The sum over `names` of each span's mean duration (ms) over the
    steps of `steps(run)`; None where one of them has no span there (a
    program that does not record it)."""
    keep = set(steps(run))
    total = 0.0
    for name in names:
        found = [s.dur for s in run.spans_named(name)
                 if int(s.attrs["step"]) - 1 in keep]
        if not found:
            return None
        total += sum(found) / len(found) / 1e3
    return total
