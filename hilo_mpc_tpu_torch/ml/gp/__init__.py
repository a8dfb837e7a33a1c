from .gp import GaussianProcess, GPArray
from .inference import (ExactInference, ExpectationPropagation,
                        KullbackLeibler, Laplace, SparseFITC, SparseVFE,
                        StochasticVariational, VariationalBayes)
from .likelihood import (Gaussian, Laplacian, Likelihood, Logistic, Probit,
                         StudentsT)
from .kernels import (ConstantKernel, DotProductKernel, ExponentialKernel,
                      GammaExponentialKernel, Kernel, LinearKernel, Matern32Kernel,
                      Matern52Kernel, MaternKernel, NeuralNetworkKernel,
                      PeriodicKernel, PiecewisePolynomialKernel, PolynomialKernel,
                      RationalQuadraticKernel, SquaredExponentialKernel, Warp)
from .means import (ConstantMean, LinearMean, Mean, OneMean, PolynomialMean,
                    ZeroMean)
