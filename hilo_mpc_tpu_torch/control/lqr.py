"""Finite/infinite-horizon discrete-time LQR.

PyTorch port of ``hilo_mpc_tpu/control/lqr.py``: the finite-horizon gain
comes from the backward Riccati sweep (``ops/riccati.py:lqr_backward``), the
infinite-horizon one from the DARE fixed point (``dare_solve``), both on the
device and in the dtype given to ``setup``; the control law u = -K x is
evaluated on the host.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.model import Model, resolve_device
from ..ops.riccati import dare_solve, lqr_backward
from ..ops.smallalg import solve_psd_small


def _check_psd(M, name):
    M = np.asarray(M)
    if np.iscomplexobj(M):
        raise ValueError(f"{name} must be real-valued")
    M = np.asarray(M, dtype=float)
    if M.ndim <= 1:
        M = np.diag(np.atleast_1d(M))   # a vector sets the diagonal
    if not np.allclose(M, M.T, atol=1e-10):
        raise ValueError(f"{name} must be symmetric")
    if np.any(np.linalg.eigvalsh(M) < -1e-10):
        raise ValueError(f"{name} must be positive semi-definite")
    return M


class LinearQuadraticRegulator:
    """u = -K x for a discrete-time linear model."""

    _controller_type = "LQR"

    def __init__(self, model: Model, id: Optional[str] = None,
                 name: Optional[str] = None):
        if not model.is_linear:
            raise ValueError("LQR requires a linear model")
        self._model = model.copy(keep_solution=False)
        self.name = name or f"lqr_{self._model.name}"
        self._horizon: Optional[int] = None
        self._Q: Optional[np.ndarray] = None
        self._R: Optional[np.ndarray] = None
        self._K: Optional[np.ndarray] = None
        self._P: Optional[np.ndarray] = None
        self._setup_done = False
        self._dt = model.dt or 1.0
        self._device = torch.device("cpu")
        self._dtype = torch.float32

    @property
    def horizon(self):
        return self._horizon

    @horizon.setter
    def horizon(self, N):
        if N is not None and int(N) < 1:
            raise ValueError("horizon must be >= 1 (or None for infinite horizon)")
        self._horizon = None if N is None else int(N)

    @property
    def Q(self):
        return self._Q

    @Q.setter
    def Q(self, val):
        Q = _check_psd(val, "Q")
        if Q.shape != (self._model.n_x, self._model.n_x):
            raise ValueError(f"Q shape {Q.shape}, expected "
                             f"{(self._model.n_x, self._model.n_x)}")
        self._Q = Q
        if self._setup_done and self._R is not None:
            self._compute_gain()

    @property
    def R(self):
        return self._R

    @R.setter
    def R(self, val):
        R = _check_psd(val, "R")
        if np.any(np.linalg.eigvalsh(R) <= 0):
            raise ValueError("R must be positive definite")
        if R.shape != (self._model.n_u, self._model.n_u):
            raise ValueError(f"R shape {R.shape}, expected "
                             f"{(self._model.n_u, self._model.n_u)}")
        self._R = R
        if self._setup_done and self._Q is not None:
            self._compute_gain()

    @property
    def K(self):
        """Feedback gain (after setup)."""
        return None if self._K is None else np.array(self._K)

    feedback_gain = K

    @property
    def P(self):
        """Riccati matrix of the gain: the DARE solution (infinite horizon)
        or P_0 of the backward sweep (finite horizon)."""
        return None if self._P is None else np.array(self._P)

    def _discrete_AB(self, p=None):
        m = self._model
        if p is not None:
            p = np.broadcast_to(np.atleast_1d(np.asarray(p, dtype=float)), (m.n_p,))
        if m.discrete:
            if m.A is not None and p is None:
                return m.A, m.B
            # linear but declared by equations (possibly parameter-dependent):
            # the Jacobians at the given parameter values
            return tuple(j.cpu().numpy() for j in m.jacobians(
                np.zeros(m.n_x), np.zeros(m.n_u), p=p))
        # continuous linear model: zero-order-hold discretization (matrix exp)
        import scipy.linalg

        A, B = (j.cpu().numpy() for j in m.jacobians(
            np.zeros(m.n_x), np.zeros(m.n_u), p=p))
        nx, nu = m.n_x, m.n_u
        M = np.zeros((nx + nu, nx + nu))
        M[:nx, :nx] = A
        M[:nx, nx:] = B
        E = scipy.linalg.expm(M * self._dt)
        return E[:nx, :nx], E[:nx, nx:]

    def _compute_gain(self, p=None):
        kw = dict(dtype=self._dtype, device=self._device)
        A, B = (torch.as_tensor(np.asarray(m, dtype=float), **kw)
                for m in self._discrete_AB(p=p))
        Q = torch.as_tensor(self._Q, **kw)
        R = torch.as_tensor(self._R, **kw)
        if self._horizon is None:
            K, P = dare_solve(A, B, Q, R)
        else:
            _, P = lqr_backward(A, B, Q, R, horizon=self._horizon)
            # the gain of the fully iterated Riccati matrix P_0
            K = solve_psd_small(R + B.T @ P @ B, B.T @ P @ A)
        self._K = K.cpu().numpy()
        self._P = P.cpu().numpy()

    def setup(self, dt: Optional[float] = None, device="cuda",
              dtype=torch.float32, **kwargs):
        """Compute the gain on ``device`` in ``dtype`` (``device="cpu"`` runs
        on the CPU; a CUDA device PyTorch cannot see raises)."""
        self._device = resolve_device(device)
        self._dtype = dtype
        if dt is not None:
            self._dt = float(dt)
        if self._Q is not None and self._R is not None:
            self._compute_gain()
        self._setup_done = True
        return self

    def is_setup(self):
        return self._setup_done

    def call(self, x=None, p=None, **kwargs):
        if not self._setup_done:
            raise RuntimeError(
                "LQR is not set up. Run LQR.setup(...) before calling the LQR.")
        if self._Q is None:
            raise RuntimeError(
                "Matrix Q is not set properly. To ensure that a unique solution "
                "exists, the matrix Q needs to be symmetric, real-valued and "
                "positive semidefinite.")
        if self._R is None:
            raise RuntimeError(
                "Matrix R is not set properly. To ensure that a unique solution "
                "exists, the matrix R needs to be symmetric, real-valued and "
                "positive definite.")
        if x is None:
            raise ValueError("No state information was supplied to the LQR!")
        if p is not None or self._K is None:
            # parameter-dependent dynamics: the gain at the given parameters
            self._compute_gain(p=p)
        x = np.asarray(x, dtype=float).ravel()
        return -(self._K @ x)

    optimize = call
    __call__ = call
