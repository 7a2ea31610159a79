"""Analytical Arria-10-like FPGA model: resources, throughput, perf, energy, area."""
from . import area, energy, perf, resources, throughput

__all__ = ["area", "energy", "perf", "resources", "throughput"]
