"""Stochastic NMPC with GP uncertainty propagation.

PyTorch port of ``hilo_mpc_tpu/control/smpc.py``. A deterministic surrogate
model carries the mean states mu and the covariance states vec(P); the
covariance propagates through the linearized closed loop

    P+ = A_cl P A_clᵀ + Bw Kd0(mu, u) Bwᵀ,   A_cl = Fx - Fu K_fb,

where F(x, u) = f(x, u) + Bw d(x, u) is the whole mean map (the nominal
step plus the GP posterior means mixed in by the disturbance matrix Bw) and
Kd0 the diagonal of the GP posterior variances at the predicted mean. The
Jacobians of F are taken by ``jvp`` along basis tangents under ``vmap``
(``ops/ip_solver.py:_jacobian``), through the GP means, so the GP/state
cross-covariance and the input-dependent GP output covariance are exact.
Chance constraints use the erfinv back-off: Pr(x_i <= ub) >= p  ⇔
mu_i + κ_p sqrt(P_ii) <= ub, κ_p = sqrt(2) erfinv(2p - 1).

The surrogate is a batch-first discrete Model over [mu; vec(P)], given as a
callable (``Model.set_dynamical_equations``), so the stochastic controller
is an NMPC: the interior point's KKT sweeps run the Riccati kernel at
(nx + nx², nu), and the batch entry points take (B, nx + nx²) states. With
chance constraints the whole-solve kernel declines the problem (generic
rows), as JAX's gate does; without them ``pallas_full`` takes it: the
trace of the surrogate (ops/codegen_fx.py) flattens the mean step's nested
Jacobian into plain ops and emits the GP variance's triangular solve as a
substitution. A float32 controller's kernel computes in float32, so it
takes a float32 GP; a float64 GP predicts in float64 (ml/gp/gp.py:
predict_fn), which the gate declines, naming the cast.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..core.integrators import IntegratorSpec, make_step
from ..core.model import Model, _device_matrix, records_setup
from ..ops.ip_solver import _jacobian
from .nmpc import NMPC


def chance_backoff(level: float) -> float:
    """kappa_p = sqrt(2) * erfinv(2p - 1)."""
    from scipy.special import erfinv

    if not 0.5 <= level < 1.0:
        raise ValueError("chance constraint level must be in [0.5, 1)")
    return float(np.sqrt(2.0) * erfinv(2.0 * level - 1.0))


class SMPC(NMPC):
    """Stochastic MPC: NMPC over a mean+covariance surrogate of ``model``.

    ``gps``: a dict mapping a state name to a fitted GaussianProcess that
    models an additive discrete-time disturbance on that state, or a list of
    GPs mixed by ``disturbance_matrix`` (n_x, n_gps), x+ = f(x, u) + B d(x, u);
    the GPs' features are model states or inputs. ``feedback_gain``: an
    optional (n_u, n_x) ancillary gain K (u = u_ff - K (x - mu)) tightening the
    predicted covariance."""

    _controller_type = "SMPC"

    def __init__(self, model: Model, gps: Optional[Dict[str, object]] = None,
                 feedback_gain=None, dt: Optional[float] = None,
                 integration_method: str = "rk4", disturbance_matrix=None, **kwargs):
        self._base_model = model.copy(keep_solution=False)
        nx = model.n_x
        if isinstance(gps, dict) or gps is None:
            self._gps = list((gps or {}).values())
            rows = []
            for nm in (gps or {}):
                if nm not in model.dynamical_states:
                    raise ValueError(f"{nm!r} is not a model state")
                rows.append(model.dynamical_states.index(nm))
            if disturbance_matrix is None:
                B_w = np.zeros((nx, len(rows)))
                for j, i in enumerate(rows):
                    B_w[i, j] = 1.0
            else:
                B_w = np.atleast_2d(np.asarray(disturbance_matrix, dtype=float))
        else:
            self._gps = list(gps)
            if disturbance_matrix is None:
                raise ValueError("a list of GPs requires disturbance_matrix (n_x, n_gps)")
            B_w = np.atleast_2d(np.asarray(disturbance_matrix, dtype=float))
        if self._gps and B_w.shape != (nx, len(self._gps)):
            raise ValueError(f"disturbance_matrix shape {B_w.shape}, expected "
                             f"{(nx, len(self._gps))}")
        self._B_w = B_w
        self._K_fb = (None if feedback_gain is None
                      else np.atleast_2d(np.asarray(feedback_gain, dtype=float)))
        self._chance_specs = []
        self._surrogate_cfg = (dt, integration_method)
        super().__init__(self._build_surrogate_model(dt, integration_method), **kwargs)

    # -- surrogate construction ------------------------------------------------
    def _build_surrogate_model(self, dt, integration_method) -> Model:
        base = self._base_model
        nx, nu, n_p = base.n_x, base.n_u, base.n_p
        state_names = base.dynamical_states
        gp_fns = []
        for gp in self._gps:
            feat_idx = []
            for f in gp.features:
                if f in state_names:
                    feat_idx.append((0, state_names.index(f)))
                elif f in base.inputs:
                    feat_idx.append((1, base.inputs.index(f)))
                else:
                    raise ValueError(f"GP feature {f!r} is not a model state/input")
            gp_fns.append((gp.predict_fn(), feat_idx))

        spec = IntegratorSpec(method="discrete" if base.discrete else integration_method)
        core = make_step(base.ode_fn(), base.alg_fn(), nx, base.n_z, spec)
        B_w = _device_matrix(self._B_w)
        K_fb = None if self._K_fb is None else _device_matrix(self._K_fb)
        h = dt if dt is not None else 1.0

        def gp_eval(x, u):
            """The GP posterior means d(x, u) and variances, (..., n_gps) each."""
            cols = (x, u)
            mus, vs = [], []
            for fn, feat_idx in gp_fns:
                feats = torch.stack(torch.broadcast_tensors(
                    *[cols[k][..., i] for k, i in feat_idx]), dim=-1)
                mu, var = fn(feats)
                mus.append(mu)
                vs.append(var)
            return torch.stack(mus, dim=-1), torch.stack(vs, dim=-1)

        def mean_step(x, u, p, t):
            xn, _ = core(x, x.new_zeros(x.shape[:-1] + (base.n_z,)), u, p, t, h)
            if gp_fns:
                xn = xn + gp_eval(x, u)[0] @ B_w(x).mT
            return xn

        def gp_cov(x, u):
            """Bw Kd0 Bwᵀ, the exogenous part of the covariance update."""
            Bx = B_w(x)
            if not gp_fns:
                return x.new_zeros(x.shape[:-1] + (nx, nx))
            vs = gp_eval(x, u)[1]
            return (Bx * vs[..., None, :]) @ Bx.mT

        def disc_map(x, z, u, p, t):
            mu = x[..., :nx]
            P = x[..., nx:].reshape(x.shape[:-1] + (nx, nx))
            mu_next = mean_step(mu, u, p, t)
            A = _jacobian(lambda m: mean_step(m, u, p, t), (mu,))
            if K_fb is not None:
                B = _jacobian(lambda uu: mean_step(mu, uu, p, t), (u,))
                A = A - B @ K_fb(x)
            P_next = A @ P @ A.mT + gp_cov(mu, u)
            P_next = 0.5 * (P_next + P_next.mT)
            return torch.cat([mu_next, P_next.reshape(x.shape[:-1] + (nx * nx,))], dim=-1)

        meas = base.meas_fn()
        surrogate = Model(name=f"{base.name}_smpc_surrogate", discrete=True,
                          time_unit=base.time_unit)
        surrogate.set_dynamical_states(list(state_names) + [
            f"P_{i}_{j}" for i in range(nx) for j in range(nx)])
        if nu:
            surrogate.set_inputs(base.inputs)
        if n_p:
            surrogate.set_parameters(base.parameters)
        surrogate.set_measurements(base.measurements)
        surrogate.set_dynamical_equations(disc_map)
        surrogate.set_measurement_equations(
            lambda x, z, u, p, t: meas(x[..., :nx], z, u, p, t))
        return surrogate

    def set_box_constraints(self, x_lb=None, x_ub=None, **kwargs):
        """Hard box bounds on the physical states (covariance states unbounded)."""
        nx = self._base_model.n_x
        ns = self._model.n_x

        def pad(v, fill):
            if v is None:
                return None
            v = np.broadcast_to(np.asarray(v, dtype=float).ravel(), (nx,))
            return np.concatenate([v, np.full(ns - nx, fill)])

        return super().set_box_constraints(x_lb=pad(x_lb, -np.inf),
                                           x_ub=pad(x_ub, np.inf), **kwargs)

    # -- chance constraints ----------------------------------------------------
    def set_box_chance_constraints(self, x_lb=None, x_ub=None, level: float = 0.95):
        """Pr(lb <= x <= ub) >= level by the mean and a back-off, as stage
        constraint rows."""
        kappa = chance_backoff(level)
        nx = self._base_model.n_x
        lb = (np.full(nx, -np.inf) if x_lb is None
              else np.broadcast_to(np.asarray(x_lb, float).ravel(), (nx,)).copy())
        ub = (np.full(nx, np.inf) if x_ub is None
              else np.broadcast_to(np.asarray(x_ub, float).ravel(), (nx,)).copy())
        rows_ub = np.where(np.isfinite(ub))[0]
        rows_lb = np.where(np.isfinite(lb))[0]
        n_rows = len(rows_ub) + len(rows_lb)
        if n_rows == 0:
            return self

        def g(x, u):
            mu = x[..., :nx]
            diag = x[..., nx:nx + nx * nx][..., ::nx + 1]
            # smooth: a clip would zero the gradient in the covariance
            # states below the floor and stall the interior point; at
            # P_ii = 0 the maximum's derivative splits evenly, as JAX's does
            sig = torch.sqrt(torch.maximum(diag, diag.new_tensor(0.0)) + 1e-10)
            rows = [mu[..., i] + kappa * sig[..., i] - float(ub[i]) for i in rows_ub]
            rows += [float(lb[i]) - (mu[..., i] - kappa * sig[..., i]) for i in rows_lb]
            return torch.stack(rows, dim=-1)

        self.add_stage_constraint(g, ub=np.zeros(n_rows), n=n_rows,
                                  name=f"chance_{level}")
        self._chance_specs.append((lb, ub, level))
        return self

    @records_setup
    def setup(self, options: Optional[dict] = None, **kwargs):
        """NMPC.setup of the surrogate, rebuilt first when ``options['dt']``
        differs from the dt it was built with (the mean step bakes dt in)."""
        options = dict(options or {})
        dt = options.get("dt", self._surrogate_cfg[0])
        if dt is None:
            raise ValueError("pass dt via SMPC(..., dt=) or setup options")
        if dt != self._surrogate_cfg[0]:
            self._surrogate_cfg = (dt, self._surrogate_cfg[1])
            new_surrogate = self._build_surrogate_model(*self._surrogate_cfg)
            new_surrogate._x.scaling = self._model._x.scaling
            self._model = new_surrogate
        options["integration_method"] = "discrete"
        options["dt"] = dt
        return super().setup(options=options, **kwargs)

    # -- the user gives the physical x0; the covariance starts at P0 ----------
    def set_initial_covariance(self, P0):
        nx = self._base_model.n_x
        P0 = np.atleast_2d(np.asarray(P0, dtype=float))
        if P0.shape != (nx, nx):
            if P0.size == nx:
                P0 = np.diag(P0.ravel())
            else:
                raise ValueError(f"P0 shape {P0.shape}, expected {(nx, nx)}")
        self._P0_smpc = P0
        return self

    def optimize(self, x0, **kwargs):
        nx = self._base_model.n_x
        x0 = np.asarray(x0, dtype=float).ravel()
        if x0.size == nx:
            P0 = getattr(self, "_P0_smpc", np.zeros((nx, nx)))
            x0 = np.concatenate([x0, P0.ravel()])
        return super().optimize(x0, **kwargs)
