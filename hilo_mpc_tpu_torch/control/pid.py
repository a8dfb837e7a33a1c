"""Incremental (velocity-form) PID controller.

PyTorch port of ``hilo_mpc_tpu/control/pid.py``: multi-loop diagonal gains,
a three-sample window of process values and set points,
proportional-on-process-value and derivative-on-process-value options, the
velocity form

    u+ = u + Kp [ (e_k - e_{k-1}) + dt/Ti * e_k + Td/dt * (e_k - 2 e_{k-1} + e_{k-2}) ]

clipped to the output limits. ``call`` is the stateful host-side update
(numpy); ``step_fn`` the same update as a function of tensors, batch-first
(every tensor of the carry is (..., n)), for closed loops that run B
scenarios at once on the device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.series import TimeSeries


class PID:
    """Velocity-form (incremental) PID controller with multi-loop diagonal
    tunings, P-on-PV/D-on-PV options, and windowed set points."""

    _controller_type = "PID"

    def __init__(self, n_set_points: int = 1, id: Optional[str] = None,
                 name: Optional[str] = None, k_p=None, t_i=None, t_d=None,
                 proportional_on_process_value: bool = False,
                 derivative_on_process_value: bool = False, plot_backend=None):
        self.name = name or "pid"
        self._n = int(n_set_points)
        self.k_p = np.ones(self._n) if k_p is None else k_p
        self.t_i = np.full(self._n, np.inf) if t_i is None else t_i
        self.t_d = np.zeros(self._n) if t_d is None else t_d
        self._p_on_pv = bool(proportional_on_process_value)
        self._d_on_pv = bool(derivative_on_process_value)
        self._set_point = np.zeros(self._n)
        self._u_bounds = (-np.inf, np.inf)
        self._dt = 1.0
        self._setup_done = False
        self._pv_window = np.zeros((self._n, 3))
        self._sp_window = np.zeros((self._n, 3))
        self._u = np.zeros(self._n)
        self.solution: Optional[TimeSeries] = None

    def _diag(self, value):
        v = np.asarray(value, dtype=float)
        if v.ndim == 2:
            if not np.allclose(v, np.diag(np.diag(v))):
                raise ValueError("coupled multi-variable PID is not supported; "
                                 "the tuning matrix must be diagonal")
            v = np.diag(v)
        return np.broadcast_to(np.atleast_1d(v), (self._n,)).copy()

    @property
    def n_set_points(self):
        return self._n

    @property
    def set_point(self):
        return np.array(self._set_point)

    @set_point.setter
    def set_point(self, val):
        v = np.asarray(val, dtype=float).ravel()
        if v.size not in (1, self._n):
            raise ValueError(
                f"Dimension mismatch. Supplied dimension for the set point is "
                f"{v.size}x1, but required dimension is {self._n}x1.")
        self._set_point = np.broadcast_to(v, (self._n,)).copy()

    # the tunings broadcast a scalar, take only diagonal matrices, and derive
    # k_i = k_p/t_i and k_d = k_p*t_d
    @property
    def k_p(self):
        return np.array(self._k_p)

    @k_p.setter
    def k_p(self, val):
        self._k_p = self._diag(val)

    @property
    def t_i(self):
        return np.array(self._t_i)

    @t_i.setter
    def t_i(self, val):
        self._t_i = self._diag(val)

    @property
    def t_d(self):
        return np.array(self._t_d)

    @t_d.setter
    def t_d(self, val):
        self._t_d = self._diag(val)

    @property
    def k_i(self):
        return self.k_p / self.t_i

    @property
    def k_d(self):
        return self.k_p * self.t_d

    @property
    def tunings(self):
        return self.k_p, self.t_i, self.t_d

    @tunings.setter
    def tunings(self, vals):
        self.k_p, self.t_i, self.t_d = vals

    def set_output_limits(self, lb=-np.inf, ub=np.inf):
        self._u_bounds = (lb, ub)
        return self

    def setup(self, dt: float = 1.0, **kwargs):
        self._dt = float(dt)
        self._setup_done = True
        self._pv_window = np.zeros((self._n, 3))
        self._sp_window = np.zeros((self._n, 3))
        self._u = np.zeros(self._n)
        self.solution = TimeSeries()
        self.solution.register("x", [f"pv_{i}" for i in range(self._n)])
        self.solution.register("u", [f"u_{i}" for i in range(self._n)])
        self._time = 0.0
        return self

    def is_setup(self):
        return self._setup_done

    def step_fn(self):
        """The update as a function of tensors: step(carry, pv, sp) ->
        (carry, u), carry = (u, pv1, pv2, sp1, sp2), each (..., n) like pv
        and sp. The set points are windowed like the process values, so each
        error pairs a pv with the set point active when it was measured."""
        k_p, t_i, t_d = self._k_p, self._t_i, self._t_d
        dt = self._dt
        p_on_pv, d_on_pv = self._p_on_pv, self._d_on_pv
        lb, ub = self._u_bounds

        def step(carry, pv, sp):
            u, pv1, pv2, sp1, sp2 = carry

            def c(v):
                return torch.as_tensor(np.asarray(v, dtype=float), dtype=pv.dtype,
                                       device=pv.device)

            kp, ti, td = c(k_p), c(t_i), c(t_d)
            e = sp - pv
            e1 = sp1 - pv1
            e2 = sp2 - pv2
            delta = -(pv - pv1) if p_on_pv else e - e1
            delta = delta + dt / ti * e
            if d_on_pv:
                delta = delta - td / dt * (pv - 2 * pv1 + pv2)
            else:
                delta = delta + td / dt * (e - 2 * e1 + e2)
            u_new = torch.clamp(u + kp * delta, min=c(lb), max=c(ub))
            return (u_new, pv, pv1, sp, sp1), u_new

        return step

    def call(self, pv, set_point=None, **kwargs):
        """One control update from the measured process value."""
        if not self._setup_done:
            raise RuntimeError("call setup() first")
        if set_point is not None:
            self.set_point = set_point
        pv = np.broadcast_to(np.asarray(pv, dtype=float).ravel(), (self._n,))
        self._pv_window = np.roll(self._pv_window, -1, axis=1)
        self._pv_window[:, -1] = pv
        self._sp_window = np.roll(self._sp_window, -1, axis=1)
        self._sp_window[:, -1] = self._set_point
        pv_k, pv_1, pv_2 = (self._pv_window[:, 2], self._pv_window[:, 1],
                            self._pv_window[:, 0])
        e_k = self._sp_window[:, 2] - pv_k
        e_1 = self._sp_window[:, 1] - pv_1
        e_2 = self._sp_window[:, 0] - pv_2
        delta = -(pv_k - pv_1) if self._p_on_pv else e_k - e_1
        delta = delta + self._dt / self.t_i * e_k
        if self._d_on_pv:
            delta = delta - self.t_d / self._dt * (pv_k - 2 * pv_1 + pv_2)
        else:
            delta = delta + self.t_d / self._dt * (e_k - 2 * e_1 + e_2)
        self._u = np.clip(self._u + self.k_p * delta, *self._u_bounds)
        self._time += self._dt
        if self.solution is not None:
            self.solution.append(self._time, x=pv_k, u=self._u)
        return self._u.copy()

    optimize = call
    __call__ = call
