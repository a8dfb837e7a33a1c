from .nmpc import NMPC
from .costs import GenericConstraint, GenericCost, QuadraticCost
