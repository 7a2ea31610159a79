"""The serving engine's own host time a step (ms): the mean durations of
the port's ``serve.admit`` spans (admission, each admitted row's state
reset) and ``serve.advance`` spans (the per-row loop: next prompt token,
emission, retirement), summed, over the window's steps, the profiled
ones left out (`step_phases`)."""
from bench.metrics import step_phases


def read(run):
    return step_phases.ms_per_step(run, "serve.admit", "serve.advance")
