"""The absorbed MLA decode kernel's share of its roofline (%): over the
profiled steps, the least time the card could take for each MLA layer's
call (`mla_work.bound_s`: each slot's cached rows 0..pos read once for
all heads, the queries and outputs, against 2 x heads x (latent + rope +
latent) operations a row), over the device time of the kernels named
``mla_decode*``.  Nothing is read unless the launches are a whole
multiple of the profiled steps times the model's MLA layers (a program
without the kernel launches none)."""
from bench.metrics import mla_work

KERNELS = ("mla_decode",)


def read(run):
    t = run.trace
    m = run.cell.config["model"]
    if t is None or not t.steps or "kv_lora_rank" not in m:
        return None
    launches, seconds = t.time_s(KERNELS)
    calls = t.steps * mla_work.mla_layers(m)
    if not launches or launches % calls or seconds <= 0:
        return None
    return 100.0 * mla_work.bound_s(run, t.first_step, t.steps) / seconds
