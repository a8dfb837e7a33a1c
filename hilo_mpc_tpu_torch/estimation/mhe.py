"""Moving-horizon estimation.

PyTorch port of ``hilo_mpc_tpu/estimation/mhe.py``. The window NLP — decision
variables x_0..N, process noise w_0..N-1 and optionally estimated parameters;
arrival, measurement and state-noise costs — is solved by the port's batched
interior point (ops/ip_solver.py) with ``fix_x0=False``: each Newton step is
one Riccati solve whose free initial state the solve picks itself, on CUDA
tensors one launch of the hand-written kernel in its free-x0 mode
(``riccati_lq_cuda`` / ``riccati_lq_wide_cuda``). Estimated parameters ride as
constant-dynamics state augmentations. NaN entries in a measurement mark
missing values: a per-channel validity mask rides in theta and zeroes their
error terms. Every problem function is batch-first over windows and stages.

Entry points: ``setup(dt, options, device=..., dtype=...)`` (explicit device
and dtype, ``"cuda"`` unless the caller passes ``device="cpu"``);
``estimate`` for one closed-loop step (``runs > 1``: multi-start, all runs
as one batch); ``estimate_batch`` for B independent windows, with
``mesh=`` split over devices (parallel/sharding.py). Same-configuration
estimators share the canonical problem objects through the registry of
utils/trace_cache.py (its MHE weights in the key, as in JAX).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Optional

import numpy as np
import torch
from torch.func import jacfwd, jacrev

from ..core.integrators import IntegratorSpec, make_step
from ..core.model import records_setup, resolve_device
from ..ops.ip_solver import (IPOptions, OCPBounds, OCPDims, OCPFunctions,
                             _check_supported, solve_ocp)
from ..utils.trace_cache import arr_key, registry_lookup, registry_store
from .base import Estimator, _as_cov


class MHEQuadraticCost:
    """Accumulates MHE cost terms (reference: MHEQuadraticCost,
    util/modeling.py:533-818)."""

    def __init__(self, model):
        self._model = model
        self.W_meas: Optional[np.ndarray] = None       # measurement weight (R^-1-ish)
        self.W_noise: Optional[np.ndarray] = None      # state-noise weight (Q^-1-ish)
        self.W_arrival_x: Optional[np.ndarray] = None  # arrival state weight
        self.W_arrival_p: Optional[np.ndarray] = None  # arrival parameter weight

    def add_measurements(self, weights=None, names=None):
        n = self._model.n_y
        self.W_meas = _as_cov(weights if weights is not None else 1.0, n, "W_meas")
        return self

    def add_state_noise(self, weights=None, names=None):
        n = self._model.n_x
        self.W_noise = _as_cov(weights if weights is not None else 1.0, n, "W_noise")
        return self


def _with_estimated(p, xs, nx, pe_idx):
    """The full parameter vector (..., n_p): p with the entries ``pe_idx``
    taken from the augmented states xs[..., nx:], built out of place (the
    torch.func transforms refuse in-place writes into captured tensors)."""
    if not pe_idx:
        return p
    pos = {i: j for j, i in enumerate(pe_idx)}
    return torch.stack([xs[..., nx + pos[i]] if i in pos else p[..., i]
                        for i in range(p.shape[-1])], dim=-1)


def _quad(e, W):
    """eᵀ W e over the trailing axis, batch-first."""
    return torch.einsum("...i,ij,...j->...", e, W, e)


class MovingHorizonEstimator(Estimator):
    """Moving-horizon estimator: window NLP with free arrival state, arrival
    cost updates, optional parameter estimation, and batched windows."""

    _estimator_type = "MHE"

    def __init__(self, model, **kwargs):
        super().__init__(model, **kwargs)
        self._horizon: Optional[int] = None
        self.quad_stage_cost = MHEQuadraticCost(self._model)
        self.quad_arrival_cost = MHEQuadraticCost(self._model)
        self._est_params: List[str] = []
        self._p_guess: Optional[np.ndarray] = None
        self._x_lb = np.full(self._model.n_x, -np.inf)
        self._x_ub = np.full(self._model.n_x, np.inf)
        self._p_lb = None
        self._p_ub = None
        self._w_bound = np.inf
        self._y_history: deque = deque()
        self._u_history: deque = deque()
        self._setup_done = False

    @property
    def horizon(self):
        return self._horizon

    @horizon.setter
    def horizon(self, N):
        if int(N) < 1:
            raise ValueError("horizon must be >= 1")
        self._horizon = int(N)

    def set_box_constraints(self, x_lb=None, x_ub=None, p_lb=None, p_ub=None,
                            w_bound=None):
        nx = self._model.n_x
        if x_lb is not None:
            self._x_lb = np.broadcast_to(np.asarray(x_lb, float).ravel(), (nx,)).copy()
        if x_ub is not None:
            self._x_ub = np.broadcast_to(np.asarray(x_ub, float).ravel(), (nx,)).copy()
        if p_lb is not None:
            self._p_lb = np.asarray(p_lb, dtype=float).ravel()
        if p_ub is not None:
            self._p_ub = np.asarray(p_ub, dtype=float).ravel()
        if w_bound is not None:
            self._w_bound = float(w_bound)
        return self

    def set_estimated_parameters(self, names, guess=None, arrival_weight=None):
        """Declare model parameters to be estimated alongside the states."""
        if isinstance(names, str):
            names = [names]
        for nm in names:
            if nm not in self._model.parameters:
                raise ValueError(f"{nm!r} is not a model parameter")
        self._est_params = list(names)
        if guess is not None:
            self._p_guess = np.asarray(guess, dtype=float).ravel()
        if arrival_weight is not None:
            self.quad_arrival_cost.W_arrival_p = _as_cov(
                arrival_weight, len(names), "arrival_p")
        return self

    def _detect_affine_measurement(self, meas, nz, nx, pe_idx, n_p, nu):
        """True iff the measurement map is affine in [x; p_est].

        An affine map has an identically-zero Hessian, so probing it at a few
        random points (CPU, float64, ``torch.func.jacrev`` and ``jacfwd``) is
        exact; any nonlinearity, NaN or failure returns False, which only
        keeps the conservative solver defaults."""
        f64 = torch.float64
        p_base = torch.as_tensor(
            np.asarray(self._p_values, float).ravel()
            if self._p_values is not None and len(self._p_values) == n_p
            else np.ones(n_p), dtype=f64)
        nxs = nx + len(pe_idx)

        def g(xs, u, t):
            p = _with_estimated(p_base, xs, nx, pe_idx)
            return meas(xs[:nx], torch.zeros(nz, dtype=f64), u, p, t).reshape(-1)

        jac = jacrev(g, argnums=0)
        hess = jacfwd(jac, argnums=0)
        rng = np.random.default_rng(0)
        try:
            for scale in (0.7, 1.9):
                xs = torch.as_tensor(scale * rng.standard_normal(nxs), dtype=f64)
                u = torch.as_tensor(rng.standard_normal(nu), dtype=f64)
                t = float(rng.random())
                H = hess(xs, u, t).detach().numpy()
                J = jac(xs, u, t).detach().numpy()
                if not (np.all(np.isfinite(H)) and np.all(np.isfinite(J))):
                    return False
                if np.max(np.abs(H), initial=0.0) > \
                        1e-6 * (1.0 + np.max(np.abs(J), initial=0.0)):
                    return False
        except Exception:  # a measurement map that fails at a probe point
            return False   # is not known to be affine
        return True

    # -- setup ----------------------------------------------------------------
    @records_setup
    def setup(self, dt: Optional[float] = None, options: Optional[dict] = None,
              device="cuda", dtype=torch.float32):
        """Build the window problem on ``device`` in ``dtype``. A CUDA device
        that PyTorch cannot see raises; pass ``device="cpu"`` to run on the
        CPU."""
        options = dict(options or {})
        if self._horizon is None:
            raise ValueError("set mhe.horizon before setup()")
        m = self._model
        N = self._horizon
        self._dt = float(dt if dt is not None else
                         options.get("dt", m.dt or 1.0))
        self._device = resolve_device(device)
        self._dtype = dtype
        kw = dict(dtype=dtype, device=self._device)
        nx, nu, ny, n_p = m.n_x, m.n_u, m.n_y, m.n_p
        n_pe = len(self._est_params)
        pe_idx = [m.parameters.index(nm) for nm in self._est_params]

        method = options.get("integration_method",
                             "discrete" if m.discrete else "rk4")
        spec = IntegratorSpec(method=method, degree=options.get("degree", 3),
                              substeps=options.get("substeps", 1))
        core = make_step(m.ode_fn(), m.alg_fn(), nx, m.n_z, spec)
        meas = m.meas_fn()
        nz = m.n_z
        h = self._dt

        # default weights from covariances if not set explicitly
        W_meas = (self.quad_stage_cost.W_meas if self.quad_stage_cost.W_meas
                  is not None else np.linalg.inv(self._R))
        W_noise = (self.quad_stage_cost.W_noise if self.quad_stage_cost.W_noise
                   is not None else np.linalg.inv(self._Q))
        W_arr_x = (self.quad_arrival_cost.W_arrival_x
                   if self.quad_arrival_cost.W_arrival_x is not None
                   else np.linalg.inv(self._P0))
        W_arr_p = (self.quad_arrival_cost.W_arrival_p
                   if self.quad_arrival_cost.W_arrival_p is not None
                   else np.eye(n_pe))
        Wm, Wn, Wax, Wap = (torch.as_tensor(W, **kw)
                            for W in (W_meas, W_noise, W_arr_x, W_arr_p))

        # theta layout per node k: [t, u_k (nu), y_k (ny), p_full (n_p),
        # arrival_x_bar (nx), arrival_p_bar (n_pe), y_mask (ny), arrival flag]
        off_u = 1
        off_y = off_u + nu
        off_p = off_y + ny
        off_ax = off_p + n_p
        off_ap = off_ax + nx
        off_m = off_ap + n_pe
        flag_col = off_m + ny
        self._n_theta = flag_col + 1
        self._offsets = (off_u, off_y, off_p, off_ax, off_ap)
        self._off_mask = off_m

        def full_p(xs, theta):
            return _with_estimated(theta[..., off_p:off_p + n_p], xs, nx, pe_idx)

        def meas_error(xs, theta):
            x = xs[..., :nx]
            y_pred = meas(x, x.new_zeros(x.shape[:-1] + (nz,)),
                          theta[..., off_u:off_u + nu], full_p(xs, theta), theta[..., 0])
            return (theta[..., off_y:off_y + ny] - y_pred) * theta[..., off_m:off_m + ny]

        def dyn(xs, w, theta):
            x = xs[..., :nx]
            x_next, _ = core(x, x.new_zeros(x.shape[:-1] + (nz,)),
                             theta[..., off_u:off_u + nu], full_p(xs, theta),
                             theta[..., 0], h)
            return torch.cat([x_next + w, xs[..., nx:]], dim=-1)

        def stage_cost(xs, w, theta):
            c = _quad(meas_error(xs, theta), Wm) + _quad(w, Wn)
            # the arrival cost on the node whose flag column is 1 (node 0)
            flag = theta[..., flag_col]
            c = c + flag * _quad(xs[..., :nx] - theta[..., off_ax:off_ax + nx], Wax)
            if n_pe:
                c = c + flag * _quad(xs[..., nx:] - theta[..., off_ap:off_ap + n_pe],
                                     Wap)
            return c

        def term_cost(xs, theta):
            return _quad(meas_error(xs, theta), Wm)

        dims = OCPDims(nx=nx + n_pe, nu=nx, N=N)
        funcs = OCPFunctions(dyn=dyn, stage_cost=stage_cost, term_cost=term_cost)

        # fast path: the window cost is a sum of fixed quadratic forms in the
        # residuals, so its Hessian is point-independent, and the problem
        # convex, exactly when the measurement map is affine in [x; p_est];
        # then one line-search candidate, no convexification and a constant
        # cost Hessian are exact (the JAX package's option sets,
        # hilo_mpc_tpu/estimation/mhe.py:277-293)
        fast = options.get("fast_path", "auto")
        if isinstance(fast, str):
            fast = self._detect_affine_measurement(meas, m.n_z, nx, pe_idx, n_p, nu)
        self.fast_path = bool(fast)
        if self.fast_path:
            _d = dict(n_linesearch=1, convexify=False, max_iter=25,
                      const_cost_hessian=True)
        else:
            _d = dict(n_linesearch=10, convexify=True, max_iter=40,
                      const_cost_hessian=False)

        lbx = np.tile(self._x_lb, (N + 1, 1))
        ubx = np.tile(self._x_ub, (N + 1, 1))
        if n_pe:
            p_lb = (self._p_lb if self._p_lb is not None
                    else np.full(n_pe, -np.inf))
            p_ub = (self._p_ub if self._p_ub is not None
                    else np.full(n_pe, np.inf))
            lbx = np.concatenate([lbx, np.tile(p_lb, (N + 1, 1))], axis=1)
            ubx = np.concatenate([ubx, np.tile(p_ub, (N + 1, 1))], axis=1)
        self._bounds = OCPBounds(
            lbx=torch.as_tensor(lbx, **kw), ubx=torch.as_tensor(ubx, **kw),
            lbu=torch.full((N, nx), -self._w_bound, **kw),
            ubu=torch.full((N, nx), self._w_bound, **kw))
        self._dims = dims
        self._funcs = funcs
        # 1e-7 KKT is unreachable in f32; pick the default by solver dtype
        default_tol = 1e-7 if dtype == torch.float64 else 1e-4
        self._ip_opts = IPOptions(
            max_iter=options.get("max_iter", _d["max_iter"]),
            tol=options.get("tol", default_tol),
            mu_init=options.get("mu_init", 1e-2),
            n_linesearch=options.get("n_linesearch", _d["n_linesearch"]),
            mehrotra=options.get("mehrotra", False),
            convexify=options.get("convexify", _d["convexify"]),
            early_exit=options.get("early_exit", True),
            parallel_riccati=options.get("parallel_riccati", False),
            const_cost_hessian=options.get("const_cost_hessian",
                                           _d["const_cost_hessian"]))
        _check_supported(funcs, dims, self._ip_opts)
        # same-configuration estimators adopt the canonical objects: the key
        # holds everything baked into the functions above (JAX's, with the
        # device and dtype in place of the x64 flag)
        msig, keep = m.trace_signature()
        sig = ("mhe", msig, N, float(self._dt),
               (spec.method, spec.degree, spec.scheme, spec.substeps, spec.newton_iters),
               tuple(pe_idx), arr_key(W_meas), arr_key(W_noise), arr_key(W_arr_x),
               arr_key(W_arr_p), tuple(dataclasses.astuple(self._ip_opts)),
               str(self._device), str(dtype))
        ent = registry_lookup(sig)
        if ent is not None:
            self._funcs, self._dims, self._ip_opts = ent["funcs"], ent["dims"], ent["ip_opts"]
        else:
            ent = registry_store(sig, {"funcs": funcs, "dims": dims,
                                       "ip_opts": self._ip_opts, "keep": keep})
        self._trace_entry = ent
        self._register_solution()
        self.solution.register("w", [f"w_{n}" for n in m.dynamical_states])
        if n_pe:
            self.solution.register("p_est", self._est_params)
        self._x_arrival: Optional[np.ndarray] = None
        self._p_arrival = (self._p_guess if self._p_guess is not None
                           else np.zeros(n_pe))
        self._warm = None
        self._time = 0.0
        self._setup_done = True
        return self

    def _solve(self, theta, xs0, X_init, U_init):
        """The window solves, batch-first (numpy or tensors in; tensors out)."""
        return solve_ocp(self._funcs, self._dims, self._bounds,
                         *(self._tensor(a) for a in (theta, xs0, X_init, U_init)),
                         options=self._ip_opts, fix_x0=False)

    def _p_vector(self, p):
        m = self._model
        if (p is None and self._p_values is None
                and len(self._est_params) == m.n_p):
            # every parameter is estimated: the theta placeholder values are
            # overwritten by the augmented states anyway
            return np.zeros(m.n_p)
        return self._p_or_default(p)

    # -- measurement buffering -------------------------------------------------
    def add_measurements(self, y, u=None):
        y = np.asarray(y, dtype=float).ravel()
        if y.size != self.n_y:
            raise ValueError(f"y has {y.size} entries, expected {self.n_y}")
        self._y_history.append(y)
        self._u_history.append(
            np.zeros(self.n_u) if u is None
            else np.asarray(u, dtype=float).ravel())
        max_len = (self._horizon or 0) + 1
        while len(self._y_history) > max_len:
            self._y_history.popleft()
            self._u_history.popleft()
        return self

    @property
    def window_full(self) -> bool:
        return len(self._y_history) >= (self._horizon or 0) + 1

    # -- batched windows -----------------------------------------------------
    def _theta_batch(self, Ys, Us, x_arrivals, p_vec, t0=0.0):
        """theta (B, N+1, n_theta) of B windows: float64 numpy from numpy
        inputs; from tensors a tensor of Ys's dtype and device (the fused
        MHE loop assembles its windows on the device)."""
        as_np = not isinstance(Ys, torch.Tensor)
        if as_np:
            Ys, Us, x_arrivals, p_vec = (torch.as_tensor(np.asarray(a, dtype=float))
                                         for a in (Ys, Us, x_arrivals, p_vec))
        m = self._model
        B, N = Ys.shape[0], self._horizon
        nx, n_pe = m.n_x, len(self._est_params)
        off_u, off_y, off_p, off_ax, off_ap = self._offsets
        theta = Ys.new_zeros(B, N + 1, self._n_theta)
        theta[:, :, 0] = t0 + self._dt * torch.arange(N + 1, dtype=Ys.dtype,
                                                      device=Ys.device)
        # interval input for node k -> k+1 is the u applied AFTER y_k was
        # measured, i.e. row k+1's (rows pair (y_{j+1}, u_j) like the filters)
        theta[:, :, off_u:off_u + m.n_u] = torch.cat([Us[:, 1:], Us[:, -1:]], dim=1)
        theta[:, :, off_y:off_y + m.n_y] = torch.nan_to_num(Ys, nan=0.0)
        theta[:, :, off_p:off_p + m.n_p] = p_vec
        theta[:, :, off_ax:off_ax + nx] = x_arrivals[:, None, :]
        if n_pe:
            theta[:, :, off_ap:off_ap + n_pe] = torch.as_tensor(
                self._p_arrival, dtype=Ys.dtype, device=Ys.device)
        # NaN marks a missing measurement: its error term is masked out
        theta[:, :, self._off_mask:self._off_mask + m.n_y] = torch.isfinite(Ys).to(Ys.dtype)
        theta[:, 0, -1] = 1.0   # arrival-cost indicator
        return theta.numpy() if as_np else theta

    def estimate_batch(self, Ys, Us=None, x_arrivals=None, p=None, mesh=None):
        """Solve B independent MHE windows at once.

        Ys: (B, N+1, n_y) measurement windows; Us: (B, N+1, n_u) inputs, paired
        like estimate(): row k's input is the one whose application produced
        row k's measurement. x_arrivals: (B, nx) arrival means.
        Returns (x_est (B, nx) numpy, OCPSolution of tensors on the
        estimator's device).

        With ``mesh`` (``parallel/sharding.py:make_mesh``; its first axis
        splits the batch) each shard of windows is solved on its own device
        (this estimator set up there, ``on_device``); the solution's fields
        are then ShardedTensors and x_est is gathered in the windows'
        order."""
        if not self._setup_done:
            raise RuntimeError("call setup() first")
        m = self._model
        N = self._horizon
        nx, n_pe = m.n_x, len(self._est_params)
        Ys = np.asarray(Ys, dtype=float)
        B = Ys.shape[0]
        if Ys.shape[1:] != (N + 1, m.n_y):
            raise ValueError(f"Ys shape {Ys.shape}, expected "
                             f"(B, {N + 1}, {m.n_y})")
        Us = (np.zeros((B, N + 1, m.n_u)) if Us is None
              else np.asarray(Us, dtype=float))
        if x_arrivals is None:
            x_arrivals = np.tile(
                (self._x0 if self._x0 is not None else np.zeros(nx)), (B, 1))
        x_arrivals = np.asarray(x_arrivals, dtype=float)
        theta = self._theta_batch(Ys, Us, x_arrivals, self._p_vector(p))
        xs0 = np.concatenate(
            [x_arrivals, np.tile(self._p_arrival[:n_pe], (B, 1))], axis=1)
        X_init = np.tile(xs0[:, None, :], (1, N + 1, 1))
        U_init = np.zeros((B, N, nx))
        if mesh is not None:
            return self._estimate_sharded(mesh, theta, xs0, X_init, U_init)
        sol = self._solve(theta, xs0, X_init, U_init)
        x_est = sol.X[:, -1, :nx].detach().cpu().numpy()
        return x_est, sol

    def _estimate_sharded(self, mesh, *windows):
        """The window solves split over the mesh's first axis, each shard on
        its device."""
        from ..parallel.sharding import map_shards, on_device, shard_batch

        args = shard_batch(tuple(torch.as_tensor(a, dtype=self._dtype) for a in windows),
                           mesh, mesh.axis_names[0])
        sol = map_shards(lambda theta, xs0, X_init, U_init, device: on_device(
            self, device)._solve(theta, xs0, X_init, U_init), args, args[1])
        nx = self._model.n_x
        x_est = np.concatenate([x[:, -1, :nx].detach().cpu().numpy()
                                for x in sol.X.shards])
        return x_est, sol

    # -- solve -----------------------------------------------------------------
    def estimate(self, y=None, u=None, p=None, runs: int = 1,
                 pert_factor: float = 0.1, seed: int = 0):
        """Add an optional new measurement, then solve the window problem.
        Returns the current state estimate (and parameter estimates if any), or
        None while the window is still filling.

        ``runs > 1`` enables multi-start (reference: the ``runs`` kwarg with
        multiplicatively perturbed initial guesses, mhe.py:386-399): all
        perturbed window guesses are solved as one batch and the best
        converged objective wins. ``pert_factor`` scales the relative
        perturbation like the reference's kwarg."""
        if not self._setup_done:
            raise RuntimeError("call setup() first")
        if y is not None:
            self.add_measurements(y, u)
        if not self.window_full:
            return None
        m = self._model
        N = self._horizon
        nx, n_pe = m.n_x, len(self._est_params)
        p_vec = self._p_vector(p)
        if self._x_arrival is None:
            self._x_arrival = (self._x0 if self._x0 is not None
                               else np.zeros(nx))

        ys = np.stack(list(self._y_history))      # (N+1, ny): y_k at node k
        us = np.stack(list(self._u_history))      # (N+1, nu): u applied after y_k
        theta = self._theta_batch(ys[None], us[None], self._x_arrival[None],
                                  p_vec, t0=self._time)[0]
        xs0 = np.concatenate([self._x_arrival, self._p_arrival[:n_pe]])
        if self._warm is not None:
            X_init, U_init = self._warm
            X_init = np.vstack([X_init[1:], X_init[-1:]])
            U_init = np.vstack([U_init[1:], U_init[-1:]])
        else:
            X_init = np.tile(xs0[None, :], (N + 1, 1))
            U_init = np.zeros((N, nx))
        if runs > 1:
            # multi-start: perturb the state-trajectory guess multiplicatively
            # (plus an absolute floor so zero guesses still move) and the noise
            # guess additively; solve all runs as one batch
            rng = np.random.default_rng(seed)
            scale = np.abs(X_init) + 1.0
            X_pert = np.tile(X_init[None], (runs, 1, 1))
            U_pert = np.tile(U_init[None], (runs, 1, 1))
            X_pert[1:] += (pert_factor * scale[None]
                           * (1.0 - 2.0 * rng.random((runs - 1,) + X_init.shape)))
            U_pert[1:] += (pert_factor
                           * (1.0 - 2.0 * rng.random((runs - 1,) + U_init.shape)))
            sols = self._solve(np.tile(theta[None], (runs, 1, 1)),
                               np.tile(xs0[None], (runs, 1)), X_pert, U_pert)
            # best converged objective; unconverged runs are penalized, run 0
            # (the unperturbed warm guess) wins ties
            score = np.where(sols.converged.cpu().numpy(),
                             sols.objective.detach().cpu().numpy(), np.inf)
            best = int(np.argmin(score)) if np.isfinite(score).any() else 0
        else:
            sols = self._solve(theta[None], xs0[None], X_init[None], U_init[None])
            best = 0
        sol = type(sols)(*[a[best] for a in sols])
        X = sol.X.detach().cpu().numpy()
        W = sol.U.detach().cpu().numpy()
        self._warm = (X, U_init if not np.all(np.isfinite(W)) else W)
        # arrival update: next window starts one step later
        self._x_arrival = X[1, :nx]
        if n_pe:
            self._p_arrival = X[-1, nx:]
        x_est = X[-1, :nx]
        self._time += self._dt
        self.stats = {
            "iterations": int(sol.iterations),
            "kkt_error": float(sol.kkt_error),
            "objective": float(sol.objective),
            "converged": bool(sol.converged),
            "fast_path": self.fast_path,
        }
        f64 = torch.float64
        y_pred = m.meas_fn()(
            torch.as_tensor(x_est, dtype=f64), torch.zeros(m.n_z, dtype=f64),
            torch.as_tensor(us[-1], dtype=f64), torch.as_tensor(p_vec, dtype=f64),
            0.0).reshape(-1).numpy()
        kwargs = dict(x=x_est, y=y_pred, w=W[-1])
        if n_pe:
            kwargs["p_est"] = self._p_arrival
        self.solution.append(self._time, **kwargs)
        if n_pe:
            return x_est, np.array(self._p_arrival)
        return x_est
