"""Carry solver state between the JAX package and this port.

``to_torch`` maps NamedTuples of arrays (the JAX side's ``OCPBounds``,
``OCPSolution``, ``LQSolution``, and the ``(theta_B, xs0_B, X_B, U_B)`` tuple
from ``NMPC.prepare_batch``) onto this package's NamedTuples of tensors;
``to_numpy`` maps them back to NamedTuples of numpy arrays. NamedTuples are
matched by class name. Anything numpy can convert is accepted as an array, so
this module needs no JAX: a test hands both solvers identical inputs.

``linear_model_from``, ``lmpc_from`` and ``lqr_from`` rebuild a JAX-side
state-space model, LMPC or LQR in the port from its numpy matrices, names,
weights and bounds (read by attribute, again without importing JAX), so both
sides of a test start from the same numbers; ``model_from`` a model declared
by equation text or matrices (with ``learned=``, a hybrid model: the
physics model composed with networks or GPs), ``estimator_from`` an MHE,
KF, EKF, UKF or PF, ``pid_from`` a PID, ``ann_from`` a network and
``gp_from`` a Gaussian process or a ``GPArray`` (kernel tree, mean,
likelihood, inference and its options, hyperparameter values with their
flags, bounds and priors, training data).
"""
from __future__ import annotations

import numpy as np
import torch

from ..control.lmpc import LMPC
from ..control.lqr import LinearQuadraticRegulator
from ..control.pid import PID
from ..core.model import Model
from ..estimation.kf import (ExtendedKalmanFilter, KalmanFilter,
                             UnscentedKalmanFilter)
from ..estimation.mhe import MovingHorizonEstimator
from ..estimation.pf import ParticleFilter
from ..ml import priors as _priors
from ..ml.gp import kernels as _kernels
from ..ml.gp import likelihood as _likelihoods
from ..ml.gp import means as _means
from ..ml.gp.gp import GaussianProcess, GPArray
from ..ml.nn import ArtificialNeuralNetwork, Layer
from ..ops.ip_solver import OCPBounds, OCPSolution
from ..ops.riccati import LQSolution

_PORT_TYPES = {cls.__name__: cls for cls in (OCPBounds, OCPSolution, LQSolution)}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def to_torch(tree, device="cuda", dtype=torch.float64):
    """Arrays -> tensors on ``device``; floating arrays are cast to ``dtype``,
    integer and boolean arrays keep their type."""
    if _is_namedtuple(tree):
        cls = _PORT_TYPES.get(type(tree).__name__, type(tree))
        return cls(*[to_torch(v, device, dtype) for v in tree])
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_torch(v, device, dtype) for v in tree)
    if tree is None:
        return None
    arr = np.asarray(tree)
    t = torch.as_tensor(arr.copy(), device=device)
    return t.to(dtype) if t.is_floating_point() else t


def to_numpy(tree):
    """Tensors -> numpy arrays, keeping NamedTuple and tuple structure."""
    if _is_namedtuple(tree):
        return type(tree)(*[to_numpy(v) for v in tree])
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_numpy(v) for v in tree)
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    return tree


def linear_model_from(src) -> Model:
    """The port's twin of a state-space model of the JAX package: same name,
    time base, variable names and A/B/C/D."""
    if src.A is None:
        raise ValueError(f"{src!r} is not declared by set_state_space")
    m = Model(name=src.name, discrete=src.discrete, time_unit=src.time_unit)
    m.set_dynamical_states(list(src.dynamical_states))
    if src.n_u:
        m.set_inputs(list(src.inputs))
    if src.C is not None or src.D is not None:
        m.set_measurements(list(src.measurements))
    return m.set_state_space(A=src.A, B=src.B, C=src.C, D=src.D)


def lmpc_from(src) -> LMPC:
    """The port's twin of a JAX-side LMPC (not set up): its model, horizon,
    Q/R/P, box bounds and references."""
    dst = LMPC(linear_model_from(src._model))
    dst.horizon = src.horizon
    dst.Q, dst.R = src.Q, src.R
    if src.P is not None:
        dst.P = src.P
    dst.set_box_constraints(x_lb=src._x_lb, x_ub=src._x_ub, u_lb=src._u_lb,
                            u_ub=src._u_ub)
    return dst.set_reference(src._x_ref, src._u_ref)


def lqr_from(src) -> LinearQuadraticRegulator:
    """The port's twin of a JAX-side LQR (not set up): its model, horizon,
    Q, R and sampling time."""
    dst = LinearQuadraticRegulator(linear_model_from(src._model))
    dst.horizon = src.horizon
    if src.Q is not None:
        dst.Q = src.Q
    if src.R is not None:
        dst.R = src.R
    dst._dt = src._dt
    return dst


def model_from(src, learned=()) -> Model:
    """The port's twin of a JAX-side model declared by the equation DSL (its
    text) or by state-space matrices. ``learned``: JAX-side networks, GPs or
    GP arrays (one or a sequence) substituted into the twin in order
    (``ann_from`` / ``gp_from`` each), as ``substitute_from`` made a hybrid
    model of ``src``; a JAX hybrid model keeps no record of its parts, so
    pass its physics model and learned components.
    A model given as Python callables cannot be carried across: build the
    port's twin by hand."""
    text = getattr(src, "_equations_src", None)
    if text is None:
        if src.A is None:
            raise ValueError(f"{src!r} was given as callables (or is a hybrid "
                             f"model); pass the port's twin of the model, or the "
                             f"physics model and learned=, instead")
        m = linear_model_from(src)
    else:
        m = Model(name=src.name, discrete=src.discrete, time_unit=src.time_unit)
        m.set_equations(text)
    # one network, GP or GP array, or a sequence of them
    single = any(hasattr(learned, a) for a in ("_layers", "kernel", "_gps"))
    for part in ([learned] if single else learned):
        m.substitute_from(ann_from(part, device="cpu") if hasattr(part, "_layers")
                          else gp_from(part, device="cpu"))
    return m


def ann_from(src, device="cuda", dtype=torch.float64) -> ArtificialNeuralNetwork:
    """The port's twin of a JAX-side ANN, set up on ``device`` in ``dtype``:
    its features, labels, name, seed, layers, weights, scalers and
    history (``src`` must be set up)."""
    if src._params is None:
        raise ValueError(f"{src.name!r} is not set up")
    dst = ArtificialNeuralNetwork(list(src.features), list(src.labels), name=src.name,
                                  seed=int(src._seed))
    dst.add_layers([Layer(kind=l.kind, units=l.units, activation=l.activation,
                          rate=l.rate) for l in src._layers])
    dst.setup(normalize=bool(src._normalize), device=device, dtype=dtype)
    dst._params = [{k: np.asarray(p[k]) for k in ("W", "b")} for p in src._params]
    for k in ("_scaler_mean", "_scaler_scale", "_label_mean", "_label_scale"):
        v = getattr(src, k)
        setattr(dst, k, None if v is None else np.array(v, dtype=float))
    dst.history = {k: list(v) for k, v in src.history.items()}
    return dst


_ESTIMATORS = {cls.__name__: cls for cls in (
    MovingHorizonEstimator, KalmanFilter, ExtendedKalmanFilter,
    UnscentedKalmanFilter, ParticleFilter)}
# the IPOptions fields MovingHorizonEstimator.setup reads from its options
_MHE_OPTIONS = ("max_iter", "tol", "mu_init", "n_linesearch", "mehrotra",
                "convexify", "early_exit", "const_cost_hessian")


def estimator_from(src, device="cuda", dtype=torch.float64, model=None,
                   options=None):
    """The port's twin of a JAX-side MHE, KF, EKF, UKF or PF: its Q, R, P0,
    parameter values and initial guess; for an MHE also the horizon, the
    weights, the bounds and the estimated parameters with their guess and
    arrival weight; for a UKF alpha, beta, kappa; for a Kalman filter its
    current covariance; for a PF its settings and particles. A set-up ``src`` gives a twin set up on ``device`` in
    ``dtype`` with the same sampling time (an MHE also with the solver
    options and the fast-path decision of ``src``). ``model`` is the port's
    model, by default ``model_from(src._model)``. The JAX estimators keep
    no record of their integrator, so ``options`` gives the twin's
    (``integration_method``, ``degree``, ``substeps``), as ``src`` was set
    up with them: for an MHE merged into its options, for a filter passed
    to its ``setup``."""
    cls = _ESTIMATORS.get(type(src).__name__)
    if cls is None:
        raise TypeError(f"no estimator of the port mirrors {type(src).__name__}")
    model = model_from(src._model) if model is None else model
    if cls is UnscentedKalmanFilter:
        dst = cls(model, alpha=src.alpha, beta=src.beta, kappa=src.kappa)
    elif cls is ParticleFilter:
        dst = cls(model, n_particles=src.n_particles, roughening=src.roughening,
                  roughening_tuning=src.roughening_tuning, seed=int(src._seed))
    else:
        dst = cls(model)
    dst.Q, dst.R, dst.P0 = src._Q, src._R, src._P0
    if src._p_values is not None:
        dst.set_initial_parameter_values(src._p_values)
    if cls is MovingHorizonEstimator:
        dst.horizon = src.horizon
        for cost in ("quad_stage_cost", "quad_arrival_cost"):
            for name in ("W_meas", "W_noise", "W_arrival_x", "W_arrival_p"):
                W = getattr(getattr(src, cost), name)
                setattr(getattr(dst, cost), name, None if W is None else np.array(W))
        dst._est_params = list(src._est_params)
        if src._p_guess is not None:
            dst._p_guess = np.array(src._p_guess)
        dst.set_box_constraints(x_lb=src._x_lb, x_ub=src._x_ub, p_lb=src._p_lb,
                                p_ub=src._p_ub, w_bound=src._w_bound)
        if src._setup_done:
            opts = {k: getattr(src._ip_opts, k) for k in _MHE_OPTIONS}
            opts["fast_path"] = src.fast_path
            dst.setup(dt=src._dt, options={**opts, **(options or {})}, device=device,
                      dtype=dtype)
    elif src._setup_done:
        dst.setup(dt=src._dt, device=device, dtype=dtype, **(options or {}))
    if src._x0 is not None:
        dst.set_initial_guess(src._x0)
    if cls is ParticleFilter and src._particles is not None:
        dst._particles = np.array(src._particles)
    if getattr(src, "_P", None) is not None:
        # a Kalman filter's current covariance (setup takes it from P0, and a
        # later set_initial_guess(P0=...) leaves it)
        dst._P = np.array(src._P)
    return dst


def pid_from(src) -> PID:
    """The port's twin of a JAX-side PID: its loops, options, tunings,
    output limits and set points; set up with the same dt if ``src`` is."""
    dst = PID(n_set_points=src.n_set_points, name=src.name, k_p=src.k_p,
              t_i=src.t_i, t_d=src.t_d,
              proportional_on_process_value=src._p_on_pv,
              derivative_on_process_value=src._d_on_pv)
    dst.set_output_limits(*src._u_bounds)
    if src.is_setup():
        dst.setup(dt=src._dt)
    dst.set_point = src.set_point
    return dst


def _hp_from(src, dst):
    """Copy a hyperparameter's value, flags, bounds and prior."""
    dst.positive = bool(src.positive)
    dst.value = np.array(src.value, dtype=float)
    dst.fixed = bool(src.fixed)
    dst.bounds = None if src.bounds is None else tuple(src.bounds)
    prior = src.prior
    if prior is not None:
        cls = getattr(_priors, type(prior).__name__)
        dst.prior = cls.__new__(cls)
        dst.prior.__dict__.update(vars(prior))
    else:
        dst.prior = None


def _copy_hps(src, dst):
    for a, b in zip(src._hyperparameters, dst._hyperparameters):
        _hp_from(a, b)
    return dst


_TORCH_WARPS = ("log1p", "log", "exp", "expm1", "tanh", "sin", "cos", "sqrt",
                "sinh", "arcsinh", "asinh", "sigmoid", "abs")


def _warp_from(fn, warps):
    if warps:
        return warps.pop(0)
    name = getattr(fn, "__name__", "")
    if name in _TORCH_WARPS:
        return getattr(torch, {"arcsinh": "asinh"}.get(name, name))
    raise ValueError(f"the warp {fn!r} cannot be carried across: pass the port's "
                     f"batch-first warp functions as warps=[...], in tree order")


def _kernel_from(src, warps):
    name = type(src).__name__
    cls = getattr(_kernels, name, None)
    if cls is None or not isinstance(cls, type):
        raise TypeError(f"no kernel of the port mirrors {name}")
    ad = src.active_dims
    if name in ("Sum", "Product"):
        dst = cls(_kernel_from(src.kernel_1, warps), _kernel_from(src.kernel_2, warps))
    elif name == "Scale":
        dst = cls(_kernel_from(src.kernel_1, warps), float(np.ravel(src.scale.value)[0]))
    elif name == "Power":
        dst = cls(_kernel_from(src.kernel_1, warps), src.power)
    elif name == "Warp":
        dst = cls(_kernel_from(src.kernel_1, warps), _warp_from(src.warp, warps))
    elif name == "MaternKernel":
        dst = cls(nu=src.nu, active_dims=ad)
    elif name == "PiecewisePolynomialKernel":
        dst = cls(q=src.q, active_dims=ad)
    elif name == "PolynomialKernel":
        dst = cls(src.degree, active_dims=ad)
    elif name == "GammaExponentialKernel":
        dst = cls(active_dims=ad, gamma=float(np.ravel(src.gamma.value)[0]))
    else:
        dst = cls(active_dims=ad)
    return _copy_hps(src, dst)


def _mean_from(src):
    name = type(src).__name__
    cls = getattr(_means, name, None)
    if cls is None or not isinstance(cls, type):
        raise TypeError(f"no mean of the port mirrors {name}")
    if name in ("MeanSum", "MeanProduct"):
        dst = cls(_mean_from(src.mean_1), _mean_from(src.mean_2))
    elif name == "MeanScale":
        dst = cls(_mean_from(src.mean_1), src.scale)
    elif name == "MeanPower":
        dst = cls(_mean_from(src.mean_1), src.power)
    elif name == "PolynomialMean":
        dst = cls(degree=src.degree, active_dims=src.active_dims)
    else:
        dst = cls(active_dims=src.active_dims)
    return _copy_hps(src, dst)


def _likelihood_from(src):
    name = type(src).__name__
    cls = getattr(_likelihoods, name, None)
    if cls is None or not isinstance(cls, type):
        raise TypeError(f"no likelihood of the port mirrors {name}")
    return cls(src.df) if name == "StudentsT" else cls()


def gp_from(src, device="cuda", dtype=torch.float64, warps=None):
    """The port's twin of a JAX-side GaussianProcess, or of a GPArray (each
    GP carried across), on ``device`` in ``dtype``: its features, labels,
    kernel tree (composites and ``Warp``), mean, likelihood, inference and
    options, solver, name, hyperparameters (values, fixed flags, bounds,
    priors; the inducing points and SVGP variational parameters too) and
    training data, set up if ``src`` is. A warp that is a numpy/JAX
    elementwise function (``log1p``, ``tanh``, ...) becomes torch's; any
    other warp needs the port's function in ``warps`` (a list in the
    order the tree is walked, kernel_1 before kernel_2)."""
    if type(src).__name__ == "GPArray":
        dst = GPArray(len(src))
        for i, gp in enumerate(src):
            dst[i] = gp_from(gp, device=device, dtype=dtype, warps=warps)
        return dst
    if type(src).__name__ != "GaussianProcess":
        raise TypeError(f"no GP of the port mirrors {type(src).__name__}")
    warps = list(warps or [])
    dst = GaussianProcess(list(src.features), list(src.labels),
                          kernel=_kernel_from(src.kernel, warps),
                          mean=_mean_from(src.mean),
                          noise_variance=float(np.ravel(src.noise_variance.value)[0]),
                          inference=src.inference,
                          likelihood=_likelihood_from(src.likelihood),
                          solver=src.solver,
                          inference_options=dict(src.inference_options),
                          name=src.name, device=device, dtype=dtype)
    _hp_from(src.noise_variance, dst.noise_variance)
    if src.X_train is not None:
        dst.set_training_data(np.array(src.X_train), np.array(src.y_train))
        for key in ("_z_hp", "_svgp_mv", "_svgp_lraw"):
            if getattr(src, key, None) is not None:
                _hp_from(getattr(src, key), getattr(dst, key))
        if src._state is not None or src._setup_done:
            dst.setup()
            dst._setup_done = bool(src._setup_done)
    return dst
