"""Set-up time: from the start of the process to the window's start
(imports, weights made on the device, the port's packing, the warm-up,
which builds the kernels where the checkout has not built them yet)."""


def read(run):
    return run.setup_s
