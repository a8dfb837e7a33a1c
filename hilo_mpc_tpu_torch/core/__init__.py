from .model import Model
from .series import TimeSeries
from .variables import VarSpec
from .integrators import ERK_METHODS, IntegratorSpec, make_step

__all__ = ["Model", "TimeSeries", "VarSpec", "IntegratorSpec", "ERK_METHODS",
           "make_step"]
