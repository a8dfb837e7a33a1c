"""Fixed-step ODE integrators.

PyTorch port of ``hilo_mpc_tpu/core/integrators.py``, explicit Runge-Kutta
methods only. Everything is batch-first: ``x`` has shape ``(..., nx)`` and the
time arguments ``t``/``dt`` are numbers or tensors broadcastable against
``x[..., 0]``, so one step advances every scenario and stage at once.

Conventions:
  - ``ode(x, z, u, p, t) -> dx``   shape (..., nx)
    (for a discrete-time model: the next state)
  - ``step(x, z, u, p, t, dt) -> (x_next, z_next)``

Implicit integrators (collocation, Newton-solved DAE stages) are not ported
yet: ROADMAP.md §A.3.4.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

_ERK_TABLEAUS = {
    # name: (A, b, c)
    "euler": ([[0.0]], [1.0], [0.0]),
    "rk1": ([[0.0]], [1.0], [0.0]),
    "midpoint": ([[0.0, 0.0], [0.5, 0.0]], [0.0, 1.0], [0.0, 0.5]),
    "heun": ([[0.0, 0.0], [1.0, 0.0]], [0.5, 0.5], [0.0, 1.0]),
    "rk2": ([[0.0, 0.0], [0.5, 0.0]], [0.0, 1.0], [0.0, 0.5]),
    "ralston": ([[0.0, 0.0], [2 / 3, 0.0]], [0.25, 0.75], [0.0, 2 / 3]),
    "heun3": (
        [[0.0, 0.0, 0.0], [1 / 3, 0.0, 0.0], [0.0, 2 / 3, 0.0]],
        [0.25, 0.0, 0.75],
        [0.0, 1 / 3, 2 / 3],
    ),
    "rk3": (
        [[0.0, 0.0, 0.0], [0.5, 0.0, 0.0], [-1.0, 2.0, 0.0]],
        [1 / 6, 2 / 3, 1 / 6],
        [0.0, 0.5, 1.0],
    ),
    "ssprk3": (
        [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.25, 0.25, 0.0]],
        [1 / 6, 1 / 6, 2 / 3],
        [0.0, 1.0, 0.5],
    ),
    "rk4": (
        [
            [0.0, 0.0, 0.0, 0.0],
            [0.5, 0.0, 0.0, 0.0],
            [0.0, 0.5, 0.0, 0.0],
            [0.0, 0.0, 1.0, 0.0],
        ],
        [1 / 6, 1 / 3, 1 / 3, 1 / 6],
        [0.0, 0.5, 0.5, 1.0],
    ),
    "rk38": (
        [
            [0.0, 0.0, 0.0, 0.0],
            [1 / 3, 0.0, 0.0, 0.0],
            [-1 / 3, 1.0, 0.0, 0.0],
            [1.0, -1.0, 1.0, 0.0],
        ],
        [1 / 8, 3 / 8, 3 / 8, 1 / 8],
        [0.0, 1 / 3, 2 / 3, 1.0],
    ),
}

ERK_METHODS = tuple(sorted(_ERK_TABLEAUS))

_NOT_PORTED = ("{what} is not ported to the PyTorch package yet — "
                  "ROADMAP.md §A.3.4")


def erk_tableau(method: str):
    try:
        A, b, c = _ERK_TABLEAUS[method]
    except KeyError:
        raise ValueError(
            f"unknown explicit RK method {method!r}; available: {ERK_METHODS}"
        ) from None
    return np.asarray(A), np.asarray(b), np.asarray(c)


def _col(v):
    """A per-scenario time value as a column that broadcasts against (..., n)."""
    return v.unsqueeze(-1) if torch.is_tensor(v) and v.ndim > 0 else v


def newton_solve(*args, **kwargs):
    raise NotImplementedError(
        _NOT_PORTED.format(what="newton_solve (implicit stages)"))


def make_erk_step(
    ode: Callable,
    alg: Optional[Callable] = None,
    nz: int = 0,
    method: str = "rk4",
    newton_iters: int = 8,
) -> Callable:
    """Build ``step(x, z, u, p, t, dt) -> (x_next, z_next)`` for an explicit RK method."""
    if alg is not None and nz:
        raise NotImplementedError(
            _NOT_PORTED.format(what="DAE algebraic states"))
    A, b, c = erk_tableau(method)
    A = [[float(v) for v in row] for row in A]
    b = [float(v) for v in b]
    c = [float(v) for v in c]
    s = len(b)

    def step(x, z, u, p, t, dt):
        h = _col(dt)
        ks = []
        for i in range(s):
            xi = x
            for j in range(i):
                if A[i][j] != 0.0:
                    xi = xi + h * A[i][j] * ks[j]
            ti = t + c[i] * dt
            ks.append(ode(xi, z, u, p, ti))
        x_next = x
        for i in range(s):
            if b[i] != 0.0:
                x_next = x_next + h * b[i] * ks[i]
        return x_next, z

    return step


def make_discrete_step(f: Callable, alg: Optional[Callable] = None, nz: int = 0,
                       newton_iters: int = 8) -> Callable:
    """Wrap an already-discrete map x+ = f(x, z, u, p, t) as a step function."""
    if alg is not None and nz:
        raise NotImplementedError(
            _NOT_PORTED.format(what="DAE algebraic states"))

    def step(x, z, u, p, t, dt):
        return f(x, z, u, p, t), z

    return step


def with_substeps(step: Callable, substeps: int) -> Callable:
    """Divide each dt into ``substeps`` equal integrator steps."""
    if substeps <= 1:
        return step

    def stepped(x, z, u, p, t, dt):
        h = dt / substeps
        for i in range(substeps):
            x, z = step(x, z, u, p, t + float(i) * h, h)
        return x, z

    return stepped


class IntegratorSpec(NamedTuple):
    """Static description of an integrator configuration."""

    method: str = "rk4"  # erk name | 'discrete'
    degree: int = 3
    scheme: str = "radau"
    substeps: int = 1
    newton_iters: int = 8


def make_step(
    ode: Callable,
    alg: Optional[Callable],
    nx: int,
    nz: int,
    spec: IntegratorSpec,
) -> Callable:
    """Dispatch to the right step factory. Returns step(x, z, u, p, t, dt)."""
    m = spec.method.lower()
    if m in ("collocation", "irk", "cvodes", "idas"):
        raise NotImplementedError(
            _NOT_PORTED.format(what=f"integration_method={spec.method!r}"))
    if m == "discrete":
        base = make_discrete_step(ode, alg, nz=nz, newton_iters=spec.newton_iters)
    else:
        base = make_erk_step(ode, alg, nz=nz, method=m,
                             newton_iters=spec.newton_iters)
    return with_substeps(base, spec.substeps)
