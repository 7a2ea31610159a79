"""Share of the window's batched steps that replayed a captured CUDA
graph of the decode step (%): 100 x the port's counter
``serve.decode_steps{mode=graph}`` over ``serve.decode_steps``.  Nothing
is read where the program counts no steps."""


def read(run):
    steps = run.counter("serve.decode_steps")
    if steps <= 0:
        return None
    return 100.0 * run.counter("serve.decode_steps{mode=graph}") / steps
