"""The benchmark harness of the PyTorch/CUDA port: it finds a cell's
configuration, traffic, limits and metric readers by name, runs the
cell through the port's serving entry point, reads its metrics and
judges its output against the plain reference."""
