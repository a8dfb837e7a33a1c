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
sides of a test start from the same numbers.
"""
from __future__ import annotations

import numpy as np
import torch

from ..control.lmpc import LMPC
from ..control.lqr import LinearQuadraticRegulator
from ..core.model import Model
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
