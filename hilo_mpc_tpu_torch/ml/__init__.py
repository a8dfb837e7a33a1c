from .nn import ArtificialNeuralNetwork, Dense, Dropout, Layer
from .hybrid import hybridize, substitute_from
from .hyperparameters import Hyperparameter
from .priors import DeltaPrior, GaussianPrior, LaplacePrior, Prior, StudentsTPrior

ANN = ArtificialNeuralNetwork
