"""Host time a step waits for the device (ms): the mean duration of the
port's ``serve.readback`` spans (the greedy tokens copied to the host,
which waits there for the step's queued kernels) over the window's
steps, the profiled ones left out (`step_phases`)."""
from bench.metrics import step_phases


def read(run):
    return step_phases.ms_per_step(run, "serve.readback")
