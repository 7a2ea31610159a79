"""The served model's FLOPs a second over the bf16 peak (%), on the
bit-plane path (`decode_work.mfu`)."""
from bench.metrics import decode_work


def read(run):
    return decode_work.mfu(run)
