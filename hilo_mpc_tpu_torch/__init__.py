"""hilo_mpc_tpu_torch — the PyTorch/CUDA port of hilo_mpc_tpu.

Same flat names as the JAX package for the ported slice (the batched NMPC
solve); every Pallas kernel on that path is a CUDA kernel written by hand for
Hopper (ops/cuda_kernels.py, csrc/). Device and dtype are explicit arguments
of ``Model.setup`` and ``NMPC.setup``; importing the package needs neither a
GPU nor ``nvcc``. See README.md, "PyTorch / H100 port".
"""
from . import library
from .control.nmpc import NMPC
from .core.model import Model
from .core.series import TimeSeries
from .ops.ip_solver import (IPOptions, OCPBounds, OCPDims, OCPFunctions,
                            OCPSolution)

__version__ = "0.8.3"

__all__ = ["Model", "NMPC", "TimeSeries", "library", "IPOptions", "OCPBounds",
           "OCPDims", "OCPFunctions", "OCPSolution"]
