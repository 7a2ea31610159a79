"""Host time a step spends issuing the model step's kernels (ms): the mean
duration of the port's ``serve.batch_step`` spans (staging the tokens and
positions, and the eager decode call) over the window's steps, the
profiled ones left out (`step_phases`)."""
from bench.metrics import step_phases


def read(run):
    return step_phases.ms_per_step(run, "serve.batch_step")
