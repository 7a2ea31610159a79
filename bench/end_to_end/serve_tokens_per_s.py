"""Tokens emitted by `serve_continuous` over all of the window's time,
the window being the whole call over the run's requests."""


def read(run):
    return run.tokens / run.window_s
