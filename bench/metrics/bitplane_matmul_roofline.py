"""The bit-plane kernel's share of its roofline (%): over the profiled
steps, the least time the card could take for every packed projection
of every step (`arith.bitplane_bound_s` at M = the slots the step
multiplies) over the device time of the kernel's launches
(`bitplane_gemv_kernel*`, `bitplane_mma_kernel*`).  Nothing is read
unless the kernel ran once a projection a step."""
from bench.metrics import arith

KERNELS = ("bitplane_gemv_kernel", "bitplane_mma_kernel")


def read(run):
    t = run.trace
    if t is None or not t.steps:
        return None
    launches, seconds = t.time_s(KERNELS)
    if launches != t.steps * len(run.projections) or seconds <= 0:
        return None
    bits = int(run.cell.config["model"]["quant_bits"])
    bound = t.steps * sum(arith.bitplane_bound_s(run.slots, k, n, bits)
                          for _, k, n in run.projections)
    return 100.0 * bound / seconds
