"""Fixed-step ODE/DAE integrators.

PyTorch port of ``hilo_mpc_tpu/core/integrators.py``: explicit Runge-Kutta
methods, Radau IIA / Gauss-Legendre collocation of any degree, and discrete
maps, each with semi-explicit DAE algebraic states. Implicit stages (the
algebraic states of an ERK or discrete step, the collocation equations) are
solved by a fixed number of Newton steps whose derivatives follow the
implicit function theorem (``newton_solve``). Everything is batch-first:
``x`` has shape ``(..., nx)`` and the time arguments ``t``/``dt`` are numbers
or tensors broadcastable against ``x[..., 0]``, so one step advances every
scenario and stage at once.

Conventions:
  - ``ode(x, z, u, p, t) -> dx``         shape (..., nx)
    (for a discrete-time model: the next state)
  - ``alg(x, z, u, p, t) -> residual``   shape (..., nz), 0 = g(...)
  - ``step(x, z, u, p, t, dt) -> (x_next, z_next)``
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.func import jvp, vmap

from ..ops.smallalg import solve_small

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
# the methods make_step builds as collocation steps
IMPLICIT_METHODS = ("collocation", "irk", "cvodes", "idas")

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


def _detach(v):
    return v.detach() if torch.is_tensor(v) else v


def _residual_jacobian(res_fn, w, params):
    """(res, d res / d w) of a batch-first residual, (..., m) and (..., m, m):
    the basis tangents pushed through ``jvp`` under one ``vmap``."""
    J = vmap(lambda v: jvp(lambda ww: res_fn(ww, *params), (w,), (v,))[1])(
        _basis(w))
    return res_fn(w, *params), J.movedim(0, -1)


def _basis(w):
    """One-hot tangents over the last dim of ``w``: (m, *w.shape)."""
    m = w.shape[-1]
    eye = torch.eye(m, dtype=w.dtype, device=w.device)
    return eye.reshape((m,) + (1,) * (w.dim() - 1) + (m,)).expand((m,) + w.shape)


def newton_solve(res_fn: Callable, w0: torch.Tensor, *params, iters: int = 8,
                 res_jac_fn: Optional[Callable] = None) -> torch.Tensor:
    """Solve ``res_fn(w, *params) = 0`` for w (batch-first, (..., m)) by
    ``iters`` undamped Newton steps from ``w0``.

    The value is that of the ``iters`` steps. Its derivative with respect to
    ``params`` is the implicit function theorem's, -J⁻¹·∂res/∂θ at the
    returned point, as ``lax.custom_root`` gives in the JAX package: the
    steps run on detached values (under ``vmap`` of tangents they are not
    batched over the tangents), and only one last correction
    ``c = J⁻¹·res(w, *params)``, whose value is zero at the returned point
    up to rounding and is subtracted as ``c - c.detach()``, carries the
    parameters' tangents. This holds under ``jvp``, ``vmap`` of ``jvp`` and
    ``grad`` alike. The parameters are explicit arguments because a closure
    would capture them with their tangents; ``w0`` carries none.
    ``res_jac_fn(w, *params) -> (res, J)`` may give the residual and its
    Jacobian together; by default J is ``jvp`` of ``res_fn`` over the basis
    tangents.
    """
    if res_jac_fn is None:
        res_jac_fn = lambda w, *a: _residual_jacobian(res_fn, w, a)  # noqa: E731
    # a broadcast guess (an expanded z0) may share memory between elements
    w = w0.detach().contiguous()
    frozen = tuple(_detach(v) for v in params)
    for _ in range(iters):
        r, J = res_jac_fn(w, *frozen)
        w = w - solve_small(J, r)
    J = res_jac_fn(w, *frozen)[1]
    c = solve_small(J, res_fn(w, *params))
    return w - (c - c.detach())


# ---------------------------------------------------------------------------
# Collocation basis (Radau IIA / Gauss-Legendre, arbitrary degree)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def collocation_points(degree: int, scheme: str = "radau") -> Tuple[float, ...]:
    """Collocation nodes on (0, 1], excluding the left endpoint 0."""
    if degree < 1:
        raise ValueError("collocation degree must be >= 1")
    if scheme == "legendre":
        pts = 0.5 * (np.polynomial.legendre.leggauss(degree)[0] + 1.0)
    elif scheme == "radau":
        # Radau IIA nodes: roots of P_d(2t-1) - P_{d-1}(2t-1) on (0, 1]; t=1 included
        poly = (np.polynomial.legendre.Legendre.basis(degree)
                - np.polynomial.legendre.Legendre.basis(degree - 1))
        pts = np.sort(np.real(0.5 * (poly.roots() + 1.0)))
    else:
        raise ValueError(f"unknown collocation scheme {scheme!r} (radau|legendre)")
    return tuple(float(t) for t in pts)


@functools.lru_cache(maxsize=None)
def collocation_coefficients(degree: int, scheme: str = "radau"):
    """Lagrange-basis collocation matrices over nodes tau_0=0 < tau_1 < ... < tau_d,
    in float64 numpy.

    Returns (C, D, B, taus):
      C[j, r] = dL_r/dtau (tau_j)  for j=1..d       (d, d+1) derivative matrix
      D[r]    = L_r(1)                              (d+1,)   continuity weights
      B[r]    = ∫_0^1 L_r dtau                      (d+1,)   quadrature weights
    """
    taus = (0.0,) + collocation_points(degree, scheme)
    n = degree + 1
    C = np.zeros((degree, n))
    D = np.zeros(n)
    B = np.zeros(n)
    for r in range(n):
        poly = np.poly1d([1.0])
        for s in range(n):
            if s != r:
                poly *= np.poly1d([1.0, -taus[s]]) / (taus[r] - taus[s])
        D[r] = poly(1.0)
        dpoly = np.polyder(poly)
        for j in range(1, n):
            C[j - 1, r] = dpoly(taus[j])
        B[r] = np.polyint(poly)(1.0)
    return C, D, B, np.asarray(taus)


# ---------------------------------------------------------------------------
# Step factories
# ---------------------------------------------------------------------------


def make_erk_step(
    ode: Callable,
    alg: Optional[Callable] = None,
    nz: int = 0,
    method: str = "rk4",
    newton_iters: int = 8,
) -> Callable:
    """Build ``step(x, z, u, p, t, dt) -> (x_next, z_next)`` for an explicit RK method.

    For semi-explicit DAEs the algebraic states are solved by Newton at every
    stage and at x_next (index-1 assumption), the guess carried from stage
    to stage.
    """
    A, b, c = erk_tableau(method)
    A = [[float(v) for v in row] for row in A]
    b = [float(v) for v in b]
    c = [float(v) for v in c]
    s = len(b)

    def alg_res(zz, xs, u, p, ts):
        return alg(xs, zz, u, p, ts)

    def stage_z(x_stage, z_guess, u, p, t_stage):
        if alg is None or nz == 0:
            return z_guess
        return newton_solve(alg_res, z_guess, x_stage, u, p, t_stage,
                            iters=newton_iters)

    def step(x, z, u, p, t, dt):
        h = _col(dt)
        ks = []
        z_cur = z
        for i in range(s):
            xi = x
            for j in range(i):
                if A[i][j] != 0.0:
                    xi = xi + h * A[i][j] * ks[j]
            ti = t + c[i] * dt
            z_cur = stage_z(xi, z_cur, u, p, ti)
            ks.append(ode(xi, z_cur, u, p, ti))
        x_next = x
        for i in range(s):
            if b[i] != 0.0:
                x_next = x_next + h * b[i] * ks[i]
        return x_next, stage_z(x_next, z_cur, u, p, t + dt)

    return step


def make_collocation_step(
    ode: Callable,
    alg: Optional[Callable] = None,
    nx: int = 0,
    nz: int = 0,
    degree: int = 3,
    scheme: str = "radau",
    newton_iters: int = 8,
) -> Callable:
    """Build an implicit collocation step (Radau IIA by default: stiffly
    accurate, the stand-in for IDAS on DAEs and stiff ODEs).

    The unknowns are the node states and algebraic states, node-major:
    w = (X_1, Z_1, ..., X_d, Z_d), (..., d·(nx + nz)). The residual asks
    Σ_r C[j, r] X_r = dt·f(X_j, Z_j) and g(X_j, Z_j) = 0 at every node j
    (X_0 = x), every node evaluated in one call of ``ode`` and ``alg`` over
    a node axis; then x_next = Σ_r D_r X_r and z_next = Z_d. The Newton
    Jacobian is assembled from the nodes' own Jacobians ((nx + nz) basis
    tangents, not d·(nx + nz)): the constant C[j, r]·I on the state rows
    plus the block diagonal of [-dt·f_x, -dt·f_z; g_x, g_z]. C and D are
    built once in float64 numpy and cast to the step's dtype and device, so
    a float32 step stays float32."""
    C, D, _, taus = collocation_coefficients(degree, scheme)
    d, nv = degree, nx + nz
    Kc = np.zeros((d, nv, d, nv))
    for j in range(d):
        for r in range(d):
            for a in range(nx):
                Kc[j, a, r, a] = C[j, r + 1]
    Kc = Kc.reshape(d * nv, d * nv)

    def node_values(W, zn, un, pn, tn):
        """(f, g) at every node: (..., d, nv)."""
        X = W[..., :nx]
        Z = W[..., nx:] if nz else zn
        F = ode(X, Z, un, pn, tn)
        return torch.cat([F, alg(X, Z, un, pn, tn)], dim=-1) if nz else F

    def residual(w, x, zn, un, pn, tn, h, Cm, Kj, Id):
        W = w.unflatten(-1, (d, nv))
        V = node_values(W, zn, un, pn, tn)
        Xall = torch.cat([x[..., None, :], W[..., :nx]], dim=-2)
        rx = torch.einsum("jr,...rn->...jn", Cm, Xall) - h * V[..., :nx]
        return (torch.cat([rx, V[..., nx:]], dim=-1) if nz else rx).flatten(-2)

    def res_jac(w, x, zn, un, pn, tn, h, Cm, Kj, Id):
        W = w.unflatten(-1, (d, nv))
        dV = vmap(lambda v: jvp(lambda WW: node_values(WW, zn, un, pn, tn),
                                (W,), (v,))[1])(_basis(W)).movedim(0, -1)
        S = torch.cat([-h[..., None] * dV[..., :nx, :], dV[..., nx:, :]], dim=-2) \
            if nz else -h[..., None] * dV
        J = Kj + (S[..., :, :, None, :] * Id).reshape(w.shape + (w.shape[-1],))
        return residual(w, x, zn, un, pn, tn, h, Cm, Kj, Id), J

    def step(x, z, u, p, t, dt):
        lead = torch.broadcast_shapes(x.shape[:-1], z.shape[:-1], u.shape[:-1],
                                      p.shape[:-1])
        x, z, u, p = (v.expand(lead + v.shape[-1:]) for v in (x, z, u, p))
        kw = dict(dtype=x.dtype, device=x.device)
        nodes = lead + (d,)
        tn = (torch.as_tensor(t, **kw)[..., None]
              + torch.as_tensor(dt, **kw)[..., None]
              * torch.as_tensor(taus[1:], **kw)).expand(nodes)
        zn, un, pn = (v[..., None, :].expand(nodes + v.shape[-1:]) for v in (z, u, p))
        h = torch.as_tensor(dt, **kw)[..., None, None]
        consts = (torch.as_tensor(C, **kw), torch.as_tensor(Kc, **kw),
                  torch.eye(d, **kw)[:, None, :, None])
        w0 = (torch.cat([x, z], dim=-1) if nz else x)[..., None, :].expand(
            nodes + (nv,)).flatten(-2)
        w = newton_solve(residual, w0, x, zn, un, pn, tn, h, *consts,
                         iters=newton_iters, res_jac_fn=res_jac)
        W = w.unflatten(-1, (d, nv))
        Xall = torch.cat([x[..., None, :], W[..., :nx]], dim=-2)
        x_next = torch.einsum("r,...rn->...n", torch.as_tensor(D, **kw), Xall)
        return x_next, (W[..., -1, nx:] if nz else z)

    return step


def make_discrete_step(f: Callable, alg: Optional[Callable] = None, nz: int = 0,
                       newton_iters: int = 8) -> Callable:
    """Wrap an already-discrete map x+ = f(x, z, u, p, t) as a step function;
    algebraic states are solved by Newton at x+ and t + dt."""

    def alg_res(zz, xn, u, p, tn):
        return alg(xn, zz, u, p, tn)

    def step(x, z, u, p, t, dt):
        x_next = f(x, z, u, p, t)
        if alg is not None and nz:
            z = newton_solve(alg_res, z, x_next, u, p, t + dt, iters=newton_iters)
        return x_next, z

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

    method: str = "rk4"  # erk name | 'collocation' | 'irk' | 'cvodes' | 'idas' | 'discrete'
    degree: int = 3
    scheme: str = "radau"  # collocation family
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
    if m in ("collocation", "irk"):
        base = make_collocation_step(
            ode, alg, nx=nx, nz=nz, degree=spec.degree, scheme=spec.scheme,
            newton_iters=spec.newton_iters)
    elif m in ("cvodes", "idas"):
        # the adaptive SUNDIALS integrators map to Radau collocation of degree
        # at least 3, as in the JAX package
        base = make_collocation_step(
            ode, alg, nx=nx, nz=nz, degree=max(spec.degree, 3), scheme="radau",
            newton_iters=spec.newton_iters)
    elif m == "discrete":
        base = make_discrete_step(ode, alg, nz=nz, newton_iters=spec.newton_iters)
    else:
        base = make_erk_step(ode, alg, nz=nz, method=m,
                             newton_iters=spec.newton_iters)
    return with_substeps(base, spec.substeps)
