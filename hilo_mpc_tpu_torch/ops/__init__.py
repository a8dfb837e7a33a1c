from .ip_solver import (IPOptions, OCPBounds, OCPDims, OCPFunctions, OCPSolution,
                        default_bounds, solve_ocp)
from .riccati import LQSolution, make_lq_solver, solve_lq

__all__ = [
    "IPOptions", "OCPBounds", "OCPDims", "OCPFunctions", "OCPSolution",
    "default_bounds", "solve_ocp", "LQSolution", "make_lq_solver", "solve_lq",
]
