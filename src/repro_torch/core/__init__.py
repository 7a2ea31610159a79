"""Core models: the CoMeFa compute-in-memory RAM (`comefa`) and the
analytical Arria-10-like FPGA model (`fpga_model`)."""
from . import comefa, fpga_model

__all__ = ["comefa", "fpga_model"]
