"""Shared estimator machinery: noise covariances, initial guesses, solution
storage.

PyTorch port of ``hilo_mpc_tpu/estimation/base.py``. The covariances and
guesses are host numpy (float64); each estimator's ``setup`` takes the
device and dtype it computes in, ``"cuda"`` unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.model import Model
from ..core.series import TimeSeries


def _as_cov(val, n: int, name: str) -> np.ndarray:
    """A scalar (times I), a diagonal or a symmetric (n, n) matrix as an
    (n, n) float64 array."""
    M = np.asarray(val, dtype=float)
    if M.ndim == 0:
        M = np.eye(n) * float(M)
    elif M.ndim == 1:
        if M.size != n:
            raise ValueError(f"{name}: got {M.size} diagonal entries for size {n}")
        M = np.diag(M)
    if M.shape != (n, n):
        raise ValueError(f"{name}: shape {M.shape}, expected {(n, n)}")
    if not np.allclose(M, M.T, atol=1e-12):
        raise ValueError(f"{name} must be symmetric")
    return M


class Estimator:
    """Base class: holds the model, covariances, initial guess, and solution."""

    _estimator_type = "estimator"

    def __init__(self, model: Model, id: Optional[str] = None,
                 name: Optional[str] = None, plot_backend=None):
        self._model = model.copy(keep_solution=False)
        self.name = name or f"{self._estimator_type}_{self._model.name}"
        nx, ny = self._model.n_x, self._model.n_y
        self._Q = np.eye(nx) * 1e-4
        self._R = np.eye(ny) * 1e-2
        self._P0 = np.eye(nx)
        self._x0: Optional[np.ndarray] = None
        self._p_values: Optional[np.ndarray] = None
        self._setup_done = False
        self._dt: Optional[float] = None
        self._time = 0.0
        self.solution: Optional[TimeSeries] = None

    @property
    def n_x(self): return self._model.n_x
    @property
    def n_y(self): return self._model.n_y
    @property
    def n_u(self): return self._model.n_u

    @property
    def Q(self): return np.array(self._Q)

    @Q.setter
    def Q(self, val):
        self._Q = _as_cov(val, self._model.n_x, "Q")

    process_noise_covariance = Q

    @property
    def R(self): return np.array(self._R)

    @R.setter
    def R(self, val):
        self._R = _as_cov(val, self._model.n_y, "R")

    measurement_noise_covariance = R

    @property
    def P0(self): return np.array(self._P0)

    @P0.setter
    def P0(self, val):
        self._P0 = _as_cov(val, self._model.n_x, "P0")

    initial_covariance = P0

    def set_initial_guess(self, x0, P0=None):
        self._x0 = np.asarray(x0, dtype=float).ravel()
        if self._x0.size != self._model.n_x:
            raise ValueError(f"x0 has {self._x0.size} entries, expected "
                             f"{self._model.n_x}")
        if P0 is not None:
            self.P0 = P0
        return self

    def set_initial_parameter_values(self, p):
        self._p_values = np.asarray(p, dtype=float).ravel()
        return self

    def is_setup(self):
        return self._setup_done

    def _tensor(self, a):
        """``a`` (numpy or a tensor) as a tensor in the dtype and on the
        device given to setup."""
        if not torch.is_tensor(a):
            a = np.asarray(a, dtype=float)
        return torch.as_tensor(a, dtype=self._dtype, device=self._device)

    def _p_or_default(self, p):
        if p is not None:
            return np.asarray(p, dtype=float).ravel()
        if self._p_values is not None:
            return self._p_values
        if self._model.n_p == 0:
            return np.zeros(0)
        raise ValueError("model has parameters; pass p= or call "
                         "set_initial_parameter_values")

    def _register_solution(self):
        self.solution = TimeSeries(self._model.time_unit)
        self.solution.register("x", self._model.dynamical_states)
        self.solution.register("y", self._model.measurements)
        self.solution.register("P", [f"P_{i}{j}" for i in range(self.n_x)
                                     for j in range(self.n_x)])
