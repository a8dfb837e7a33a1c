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
physics model composed with networks), ``estimator_from`` an MHE, KF,
EKF, UKF or PF, ``pid_from`` a PID, and ``ann_from`` a network.
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
    text) or by state-space matrices. ``learned``: JAX-side networks (one or
    a sequence) substituted into the twin in order (``ann_from`` each), as
    ``substitute_from`` made a hybrid model of ``src``; a JAX hybrid model
    keeps no record of its parts, so pass its physics model and networks.
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
    for net in ([learned] if hasattr(learned, "_layers") else learned):
        m.substitute_from(ann_from(net, device="cpu"))
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
