"""The 95th percentile (nearest rank) of the time every request of the
window took from its admission to a slot to its retirement, from the
durations of the port's `serve.request` spans."""
from bench.metrics import arith

NEEDS_SPANS = True


def read(run):
    durations = [s.dur / 1e6 for s in run.spans_named("serve.request")]
    if not durations:
        return None
    return arith.percentile(durations, 95)
