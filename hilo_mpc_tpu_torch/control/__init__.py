from .nmpc import NMPC, OCP, OptimalControlProblem
from .pid import PID
from .costs import GenericConstraint, GenericCost, QuadraticCost
