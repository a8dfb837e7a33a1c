"""Kalman filters: linear KF, extended KF, unscented KF.

PyTorch port of ``hilo_mpc_tpu/estimation/kf.py``. The predict step is the
model's discrete step function, and P propagates with the exact discrete-time
Jacobian A = ∂F/∂x (``torch.func.jacfwd`` through the integrator); the update
uses the Joseph form. One filter step is a function of tensors (``step_fn``).
The filters run no kernel: their algebra is a few (nx, nx) products per step,
plain PyTorch on the device and dtype given to ``setup`` (``"cuda"`` unless
the caller passes ``device="cpu"``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.func import jacfwd

from ..core.integrators import IntegratorSpec, make_step
from ..core.model import records_setup, resolve_device
from ..ops.smallalg import chol_small, solve_psd_small
from .base import Estimator


class _KalmanFilterBase(Estimator):
    def __init__(self, model, **kwargs):
        super().__init__(model, **kwargs)
        self._P: Optional[np.ndarray] = None

    @records_setup
    def setup(self, dt: Optional[float] = None, integration_method: str = "rk4",
              device="cuda", dtype=torch.float32, **options):
        """Build the filter step on ``device`` in ``dtype``. A CUDA device
        that PyTorch cannot see raises; pass ``device="cpu"`` to run on the
        CPU."""
        m = self._model
        self._dt = float(dt if dt is not None else (m.dt or 1.0))
        self._device = resolve_device(device)
        self._dtype = dtype
        method = "discrete" if m.discrete else integration_method
        spec = IntegratorSpec(method=method,
                              degree=options.get("degree", 3),
                              substeps=options.get("substeps", 1))
        core = make_step(m.ode_fn(), m.alg_fn(), m.n_x, m.n_z, spec)
        meas = m.meas_fn()
        nz = m.n_z
        h = self._dt

        def F(x, u, p, t):
            x_next, _ = core(x, x.new_zeros(x.shape[:-1] + (nz,)), u, p, t, h)
            return x_next

        def H(x, u, p, t):
            return meas(x, x.new_zeros(x.shape[:-1] + (nz,)), u, p, t)

        self._F, self._H = F, H
        self._build_step()
        self._register_solution()
        self._P = np.array(self._P0)
        self._time = 0.0
        self._setup_done = True
        return self

    def step_fn(self):
        """Filter step: (x, P, u, p, y, t) -> (x+, P+, y_pred), tensors."""
        if not self._setup_done:
            raise RuntimeError("call setup() first")
        return self._step

    def predict(self, x=None, P=None, u=None, p=None, t: Optional[float] = None):
        """Prediction step only: (x, P) -> (x_pred, P_pred). Pure — does not
        advance the filter state."""
        if not self._setup_done:
            raise RuntimeError("call setup() first")
        x = self._tensor(self._x_current() if x is None else x)
        P = self._tensor(self._P if P is None else P)
        u = self._tensor(np.zeros(self.n_u) if u is None else u)
        p_vec = self._tensor(self._p_or_default(p))
        t = self._time if t is None else float(t)
        x_pr, P_pr = self._predict_impl(x, P, u, p_vec, t)
        return x_pr.cpu().numpy(), P_pr.cpu().numpy()

    def update(self, x_pred, P_pred, y, u=None, p=None,
               t: Optional[float] = None):
        """Measurement update only: (x_pred, P_pred, y) ->
        (x_new, P_new, y_pred). Pure — does not advance the filter state."""
        if not self._setup_done:
            raise RuntimeError("call setup() first")
        u = self._tensor(np.zeros(self.n_u) if u is None else u)
        p_vec = self._tensor(self._p_or_default(p))
        t = self._time if t is None else float(t)
        x_new, P_new, y_pr = self._update_impl(
            self._tensor(x_pred), self._tensor(P_pred),
            self._tensor(np.atleast_1d(y)), u, p_vec, t)
        return x_new.cpu().numpy(), P_new.cpu().numpy(), y_pr.cpu().numpy()

    def estimate(self, y, u=None, p=None):
        """One (or several) filter updates from measurement(s) y."""
        if not self._setup_done:
            raise RuntimeError("call setup() first")
        if self._x0 is None:
            raise ValueError("call set_initial_guess(x0) first")
        y = np.atleast_2d(np.asarray(y, dtype=float))
        if y.shape[1] != self.n_y:
            y = y.T
        steps = y.shape[0]
        if u is None:
            u = np.zeros((steps, self.n_u))
        else:
            u = np.atleast_2d(np.asarray(u, dtype=float))
            if u.shape[0] == 1:
                u = np.tile(u, (steps, 1))
            if u.shape[1] != self.n_u and u.shape[0] == self.n_u:
                u = u.T
        p_vec = self._tensor(self._p_or_default(p))

        x = self._tensor(self._x_current())
        for k in range(steps):
            x, P, y_pred = self._step(x, self._tensor(self._P), self._tensor(u[k]),
                                      p_vec, self._tensor(y[k]), self._time)
            self._P = P.cpu().numpy()
            self._time += self._dt
            self.solution.append(self._time, x=x.cpu().numpy(),
                                 y=y_pred.cpu().numpy(), P=self._P.ravel())
        return x.cpu().numpy()

    def _x_current(self):
        if self.solution is not None and self.solution.n_samples:
            return self.solution["x:f"]
        return self._x0


class KalmanFilter(_KalmanFilterBase):
    """Linear / extended Kalman filter (reference: kf.py:328,370): the
    Jacobians come from forward-mode differentiation, so the two classes
    share one step; KalmanFilter asserts linearity."""

    _estimator_type = "KF"

    def __init__(self, model, **kwargs):
        if type(self) is KalmanFilter and not model.is_linear:
            raise ValueError("KalmanFilter requires a linear model; use "
                             "ExtendedKalmanFilter for nonlinear models")
        super().__init__(model, **kwargs)

    def _build_step(self):
        F, H = self._F, self._H
        nx = self.n_x

        def predict(x, P, u, p, t):
            Q = torch.as_tensor(self._Q, dtype=x.dtype, device=x.device)
            A = jacfwd(F, argnums=0)(x, u, p, t)
            x_pr = F(x, u, p, t)
            P_pr = A @ P @ A.T + Q
            return x_pr, P_pr

        def update(x_pr, P_pr, y, u, p, t):
            R = torch.as_tensor(self._R, dtype=x_pr.dtype, device=x_pr.device)
            C = jacfwd(H, argnums=0)(x_pr, u, p, t)
            y_pr = H(x_pr, u, p, t)
            S = C @ P_pr @ C.T + R
            K = solve_psd_small(S, (P_pr @ C.T).T).T
            x_new = x_pr + K @ (y - y_pr)
            I_KC = torch.eye(nx, dtype=x_pr.dtype, device=x_pr.device) - K @ C
            P_new = I_KC @ P_pr @ I_KC.T + K @ R @ K.T   # Joseph form
            return x_new, 0.5 * (P_new + P_new.T), y_pr

        def step(x, P, u, p, y, t):
            x_pr, P_pr = predict(x, P, u, p, t)
            return update(x_pr, P_pr, y, u, p, t + self._dt)

        self._predict_impl, self._update_impl, self._step = predict, update, step


class ExtendedKalmanFilter(KalmanFilter):
    """EKF — the same linearized step, nonlinear models allowed (reference:
    kf.py:370)."""

    _estimator_type = "EKF"

    def __init__(self, model, **kwargs):
        _KalmanFilterBase.__init__(self, model, **kwargs)


class UnscentedKalmanFilter(_KalmanFilterBase):
    """Sigma-point filter with alpha/beta/kappa scaling (reference:
    kf.py:413-646)."""

    _estimator_type = "UKF"

    def __init__(self, model, alpha: float = 1e-3, beta: float = 2.0,
                 kappa: float = 0.0, **kwargs):
        super().__init__(model, **kwargs)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.kappa = float(kappa)

    @property
    def alpha(self):
        return self._alpha

    @alpha.setter
    def alpha(self, v):
        if not 0 < v <= 1:
            raise ValueError("alpha must be in (0, 1]")
        self._alpha = float(v)

    @property
    def beta(self):
        return self._beta

    @beta.setter
    def beta(self, v):
        self._beta = float(v)

    @property
    def kappa(self):
        return self._kappa

    @kappa.setter
    def kappa(self, v):
        if v < 0:
            raise ValueError("kappa must be >= 0")
        self._kappa = float(v)

    def _weights(self, n, dtype, device="cpu"):
        lam = self._alpha ** 2 * (n + self._kappa) - n
        wm = torch.full((2 * n + 1,), 1.0 / (2 * (n + lam)), dtype=dtype,
                        device=device)
        wm[0] = lam / (n + lam)
        wc = wm.clone()
        wc[0] += 1 - self._alpha ** 2 + self._beta
        return lam, wm, wc

    def _build_step(self):
        F, H = self._F, self._H
        nx = self.n_x

        def sigma_points(x, P, lam):
            eye = torch.eye(nx, dtype=x.dtype, device=x.device)
            L = chol_small((nx + lam) * (P + 1e-12 * eye))
            return torch.cat([x[None, :], x[None, :] + L.T, x[None, :] - L.T], dim=0)

        def each(fn, sig, u, p, t):
            n = sig.shape[0]
            return fn(sig, u.expand(n, -1), p.expand(n, -1), t)

        def predict(x, P, u, p, t):
            Q = torch.as_tensor(self._Q, dtype=x.dtype, device=x.device)
            lam, wm, wc = self._weights(nx, x.dtype, x.device)
            sig_pr = each(F, sigma_points(x, P, lam), u, p, t)
            x_pr = torch.einsum("i,in->n", wm, sig_pr)
            dX = sig_pr - x_pr
            P_pr = torch.einsum("i,in,im->nm", wc, dX, dX) + Q
            return x_pr, P_pr

        def update(x_pr, P_pr, y, u, p, t):
            R = torch.as_tensor(self._R, dtype=x_pr.dtype, device=x_pr.device)
            lam, wm, wc = self._weights(nx, x_pr.dtype, x_pr.device)
            # re-draw sigma points about the predicted mean for the update
            sig2 = sigma_points(x_pr, P_pr, lam)
            ysig = each(H, sig2, u, p, t)
            y_pr = torch.einsum("i,in->n", wm, ysig)
            dY = ysig - y_pr
            dX2 = sig2 - x_pr
            P_yy = torch.einsum("i,in,im->nm", wc, dY, dY) + R
            P_xy = torch.einsum("i,in,im->nm", wc, dX2, dY)
            K = solve_psd_small(P_yy, P_xy.T).T
            x_new = x_pr + K @ (y - y_pr)
            P_new = P_pr - K @ P_yy @ K.T
            return x_new, 0.5 * (P_new + P_new.T), y_pr

        def step(x, P, u, p, y, t):
            x_pr, P_pr = predict(x, P, u, p, t)
            return update(x_pr, P_pr, y, u, p, t + self._dt)

        self._predict_impl, self._update_impl, self._step = predict, update, step
