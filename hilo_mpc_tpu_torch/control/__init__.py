from .nmpc import NMPC
from .costs import QuadraticCost
