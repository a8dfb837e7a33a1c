"""hilo_mpc_tpu_torch — the PyTorch/CUDA port of hilo_mpc_tpu.

Same flat names as the JAX package for the ported slices (the batched NMPC
solve, with the whole-solve interior point behind ``pallas_full``, and its
real-time iteration and discrete inputs; the open-loop OCP; linear models,
LMPC with its condensed fast-gradient path, LQR, PID; moving-horizon
estimation, the Kalman filters and the particle filter; ``SimpleControlLoop``
and the batched closed loops of ``parallel``; neural networks (``ANN``),
hybrid physics+ANN models, data sets and the TensorBoard event writer);
Gaussian processes (kernels, means, likelihoods, the seven inference
methods, ``GPArray``'s batched fit) and stochastic MPC (``SMPC``); dense
programs (``LP``, ``QP``, ``NLP``, batched over programs); batches over
devices and processes (``parallel``: meshes, sharded solves, process
groups); the embedded C99 export (``embedded``); ``OptimizationSeries``;
and the host utilities: ``Session`` (the kernel build cache and its guard,
utils/session.py, utils/cache_guard.py), the registry that same-configuration
controllers share (``clear_trace_registry``, ``trace_registry_stats``),
profiling (utils/profiling.py), the export of a model step or a batched NMPC
solve with ``torch.export`` (utils/aot.py) and plotting
(``set_plot_backend``, ``get_plot_backend``; matplotlib, bokeh and pgfplots,
imported only to draw). Every module of the JAX package has its
counterpart here, and every Pallas kernel of the JAX package is a CUDA
kernel written by hand for Hopper (ops/cuda_kernels.py, ops/whole_ip.py,
csrc/), the Riccati kernels registered as operators. Device and dtype are explicit arguments of
``Model.setup``, ``NMPC.setup``, ``LMPC.setup``, ``LQR.setup``, each
estimator's ``setup`` and the ``GaussianProcess`` constructor; the device
is ``"cuda"`` unless the caller passes ``device="cpu"``, and a missing card is
an error. Importing the package needs neither a GPU nor ``nvcc``. See
README.md, "PyTorch / H100 port".
"""
from . import library
from .control.lmpc import LMPC
from .control.lqr import LinearQuadraticRegulator
from .control.nmpc import NMPC, OCP, OptimalControlProblem
from .control.pid import PID
from .control.smpc import SMPC
from .control_loop import SimpleControlLoop
from .core.model import Model
from .core.series import OptimizationSeries, TimeSeries
from .estimation.kf import (ExtendedKalmanFilter, KalmanFilter,
                            UnscentedKalmanFilter)
from .estimation.mhe import MovingHorizonEstimator
from .estimation.pf import ParticleFilter
from .ml.gp import (ConstantKernel, ConstantMean, DotProductKernel,
                    ExactInference, ExpectationPropagation, ExponentialKernel,
                    GammaExponentialKernel, Gaussian, GaussianProcess, GPArray,
                    Kernel, KullbackLeibler, Laplace, Laplacian, Likelihood,
                    LinearKernel, LinearMean, Logistic, Matern32Kernel,
                    Matern52Kernel, MaternKernel, Mean, NeuralNetworkKernel,
                    OneMean, PeriodicKernel, PiecewisePolynomialKernel,
                    PolynomialKernel, PolynomialMean, Probit,
                    RationalQuadraticKernel, SparseFITC, SparseVFE,
                    SquaredExponentialKernel, StochasticVariational, StudentsT,
                    VariationalBayes, Warp, ZeroMean)
from .ml.nn import ArtificialNeuralNetwork, Dense, Dropout, Layer
from .ops.ip_solver import (IPOptions, OCPBounds, OCPDims, OCPFunctions,
                            OCPSolution)
from .ops.programs import (LinearProgram, NonlinearProgram,
                           QuadraticProgram)
from .utils.data import DataGenerator, DataSet
from .utils.plotting import get_plot_backend, set_plot_backend
from .utils.session import Session
from .utils.tb_events import EventFileWriter, TensorBoardSupervisor
from .utils.trace_cache import clear_trace_registry, trace_registry_stats

LQR = LinearQuadraticRegulator
MHE = MovingHorizonEstimator
KF = KalmanFilter
EKF = ExtendedKalmanFilter
UKF = UnscentedKalmanFilter
PF = ParticleFilter
ANN = ArtificialNeuralNetwork
GP = GaussianProcess
LP = LinearProgram
QP = QuadraticProgram
NLP = NonlinearProgram

__version__ = "0.8.3"

__all__ = ["Model", "NMPC", "OCP", "OptimalControlProblem", "PID",
           "SimpleControlLoop", "LMPC", "LQR", "LinearQuadraticRegulator",
           "MHE", "MovingHorizonEstimator", "KF", "KalmanFilter", "EKF",
           "ExtendedKalmanFilter", "UKF", "UnscentedKalmanFilter", "PF",
           "ParticleFilter", "TimeSeries", "library", "IPOptions", "OCPBounds",
           "OCPDims", "OCPFunctions", "OCPSolution", "ANN",
           "ArtificialNeuralNetwork", "Layer", "Dense", "Dropout", "DataSet",
           "DataGenerator", "EventFileWriter", "TensorBoardSupervisor", "SMPC",
           "GP", "GaussianProcess", "GPArray", "Mean", "ZeroMean", "OneMean",
           "ConstantMean", "LinearMean", "PolynomialMean", "Kernel",
           "ConstantKernel", "SquaredExponentialKernel", "MaternKernel",
           "Matern32Kernel", "Matern52Kernel", "ExponentialKernel",
           "GammaExponentialKernel", "RationalQuadraticKernel",
           "PiecewisePolynomialKernel", "DotProductKernel", "PolynomialKernel",
           "LinearKernel", "NeuralNetworkKernel", "PeriodicKernel", "Warp",
           "ExactInference", "ExpectationPropagation", "KullbackLeibler",
           "Laplace", "SparseFITC", "SparseVFE", "StochasticVariational",
           "VariationalBayes", "Likelihood", "Gaussian", "Logistic", "Probit",
           "StudentsT", "Laplacian", "LP", "QP", "NLP", "LinearProgram",
           "QuadraticProgram", "NonlinearProgram", "OptimizationSeries", "Session",
           "set_plot_backend", "get_plot_backend", "clear_trace_registry",
           "trace_registry_stats"]
