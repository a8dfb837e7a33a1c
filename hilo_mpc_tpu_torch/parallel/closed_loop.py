"""Closed loops of B scenarios on the device: controller solve, plant step
and observer step for the whole batch at once.

PyTorch port of ``hilo_mpc_tpu/parallel/closed_loop.py``, which runs each
loop as one ``jit(vmap(scan))``. Here the loop runs over the steps in
Python, and every step advances all B scenarios together: one batched
``solve_ocp`` call of the controller (its Riccati step the hand-written
kernel on CUDA tensors, one launch per Newton step), one batched plant step
(``Model.step_fn``) and, where there is one, one batched observer step (the
MHE window's ``solve_ocp`` with a free initial state, the Riccati kernel's
free-x0 mode; or the filter's ``step_fn`` under ``torch.func.vmap``). Warm
starts are each scenario's own solution shifted by one stage, on the device,
and the results stay there until the loop ends. The only host syncs are
the interior point's own early-exit tests, one per iteration. Every solve
uses the controller's (and the estimator's) IPOptions with their own
``mu_init``, as the JAX loops do, and theta is assembled once and reused at
every step: references and parameters are held over the run.

Noise takes one ``torch.Generator`` on the loop's device (``generator=``) in
place of the JAX loops' per-scenario PRNG keys; a noise std without a
generator is refused, as JAX refuses one without a key.

A batch from ``parallel/sharding.py:shard_batch`` runs shard by shard:
each shard's loop on its own device, with the controller, the plant and
the observer set up there (``on_device``), and the result's fields are
ShardedTensors in the batch's order. With noise, ``generator`` is then
one generator per shard (a list), or one shared by shards on one device.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.func import vmap

from ..core.model import one_row_last
from ..ops.ip_solver import solve_ocp
from .sharding import (ShardedTensor, _norm, on_device, regroup, run_shards,
                       shard_batch)


class ClosedLoopResult(NamedTuple):
    X: torch.Tensor           # (B, steps+1, nx) plant states
    U: torch.Tensor           # (B, steps, nu) applied inputs
    converged: torch.Tensor   # (B, steps) per-step solver convergence
    iterations: torch.Tensor  # (B, steps)


class ClosedLoopMHEResult(NamedTuple):
    X: torch.Tensor           # (B, steps+1, nx) TRUE plant states
    X_est: torch.Tensor       # (B, steps, nx) MHE estimates fed back
    U: torch.Tensor           # (B, steps, nu) applied inputs
    converged: torch.Tensor   # (B, steps) controller solves
    mhe_converged: torch.Tensor  # (B, steps) window solves
    # not in the JAX result: each solve's interior-point iterations
    iterations: torch.Tensor      # (B, steps) controller solves
    mhe_iterations: torch.Tensor  # (B, steps) window solves


class ClosedLoopEKFResult(NamedTuple):
    X: torch.Tensor           # (B, steps+1, nx) TRUE plant states
    X_est: torch.Tensor       # (B, steps, nx) filter estimates fed back
    U: torch.Tensor           # (B, steps, nu) applied inputs
    converged: torch.Tensor   # (B, steps)
    iterations: torch.Tensor  # (B, steps)


def _check_generator(generator, has_noise: bool):
    """With noise every scenario draws its own values from ``generator``;
    without one they would all need a stream that does not exist."""
    if has_noise and generator is None:
        raise ValueError(
            "a noise std was supplied but generator=None: pass a torch.Generator "
            "on the loop's device (torch.Generator(device).manual_seed(seed)) "
            "to the run function")


class _Controller:
    """What every loop needs of the NMPC and the plant: the batched
    controller solve, the solver's x0, the plant step, checks."""

    def __init__(self, nmpc, plant_model, plant_p):
        if not nmpc.is_setup():
            raise RuntimeError("nmpc must be set up")
        if not plant_model.is_setup():
            raise RuntimeError("plant model must be set up (plant.setup(dt=...))")
        if plant_model.n_p and plant_p is None:
            raise ValueError("plant model has parameters; pass plant_p=")
        self.nmpc = nmpc
        self.dtype, self.device = nmpc.dtype, nmpc.device
        self.kw = dict(dtype=self.dtype, device=self.device)
        # the history is the interior point's debugging aid: none in a loop
        self.opts = dataclasses.replace(nmpc._ip_opts, record_iterates=False)
        self.theta = nmpc._tensor(nmpc._assemble_theta(None, None, None))
        self.plant_step = plant_model.step_fn
        self.p_plant = self.tensor(plant_p if plant_p is not None
                                   else np.zeros(plant_model.n_p))
        self.dt = plant_model.dt
        self.nx, self.nu, self.nz = plant_model.n_x, plant_model.n_u, plant_model.n_z
        self.sx = self.tensor(nmpc._x_scaling)
        self.su = self.tensor(nmpc._u_scaling)

    def tensor(self, a):
        """numpy data or a tensor in the loop's dtype, on its device."""
        if torch.is_tensor(a):
            return a.to(**self.kw)
        return torch.as_tensor(np.asarray(a, dtype=float), **self.kw)

    def solver_x0(self, x, u_old):
        n = self.nmpc
        parts = [x / self.sx]
        if n._augment_du:
            parts.append(u_old / self.su)
        if n._path_following:
            parts.append(x.new_zeros(x.shape[0], 1))
        if n._min_time is not None:
            parts.append(x.new_full((x.shape[0], 1), n._dt))
        return torch.cat(parts, dim=-1)

    def start(self, x_ctrl0):
        """The controller's cold start: the solver's x0 with u_old = 0, and
        the rollout of zero controls (B, N+1, nxs), zero U (B, N, nus)."""
        B = x_ctrl0.shape[0]
        d = self.nmpc._dims
        xs0 = self.solver_x0(x_ctrl0, x_ctrl0.new_zeros(B, self.nu))
        U0 = x_ctrl0.new_zeros(B, d.N, d.nu)
        th = self.theta_batch(B)
        X = [xs0]
        for k in range(d.N):
            X.append(self.nmpc._funcs.dyn(X[-1], U0[:, k], th[:, k]))
        return torch.stack(X, dim=1), U0

    def theta_batch(self, B):
        return self.theta.expand((B,) + tuple(self.theta.shape))

    def solve(self, x_ctrl, u_old, Xw, Uw):
        """One batched controller solve at x_ctrl, warm from (Xw, Uw): the
        solution, the applied move u0 (B, nu) and the next warm start."""
        n = self.nmpc
        xs0 = self.solver_x0(x_ctrl, u_old)
        Xw = torch.cat([xs0[:, None], Xw[:, 1:]], dim=1)
        sol = solve_ocp(n._funcs, n._dims, n._bounds, self.theta_batch(xs0.shape[0]),
                        xs0, Xw, Uw, options=self.opts, fix_x0=True)
        nx, nu = self.nx, self.nu
        u0 = (sol.X[:, 1, nx:nx + nu] if n._augment_du else sol.U[:, 0, :nu]) * self.su
        return sol, u0, (_shift(sol.X), _shift(sol.U))

    def time(self, k):
        """k·dt in the loop's dtype, as the JAX scan's float step counter."""
        return torch.as_tensor(float(k), **self.kw) * self.dt

    def plant(self, x, u0, k):
        B = x.shape[0]
        x_next, _, _, _ = self.plant_step(x, x.new_zeros(B, self.nz), u0,
                                          self.p_plant.expand(B, -1), self.time(k),
                                          self.dt)
        return x_next

    def noise(self, std, like, generator):
        return like + std * torch.randn(like.shape, generator=generator, **self.kw)


def _shift(V):
    """(B, N, ...) -> each scenario's trajectory moved one stage ahead, its
    last stage repeated."""
    return torch.cat([V[:, 1:], V[:, -1:]], dim=1)


def _placed(device, *objs):
    """The loop's objects, or their copies set up on ``device``."""
    return objs if device is None else tuple(on_device(o, device) for o in objs)


def _shardable(build, n_batch):
    """The run function of a loop built by ``build(device)`` (None: the
    objects as given). A ShardedTensor first argument runs each shard's
    loop on its device: the first ``n_batch(args)`` arguments are the
    batch, split like it; the result's fields are ShardedTensors."""
    run0 = build(None)
    runs = {}

    def run(*args, generator=None):
        if not isinstance(args[0], ShardedTensor):
            return run0(*args, generator=generator)
        like = args[0]
        nb = n_batch(args)
        batch = [shard_batch(a, like.mesh) for a in args[:nb]]
        n = len(like.shards)
        gens = (list(generator) if isinstance(generator, (list, tuple))
                else [generator] * n)

        def one(i):
            d = _norm(like.devices[i])
            if d not in runs:
                runs[d] = build(d)
            return runs[d](*[a.shards[i] for a in batch], *args[nb:], generator=gens[i])

        outs = run_shards(one, n, like.devices)
        return type(outs[0])(*(regroup(parts, like) for parts in zip(*outs)))

    return run


def fused_closed_loop_fn(nmpc, plant_model, steps: int,
                         plant_p: Optional[np.ndarray] = None,
                         process_noise_std: Optional[np.ndarray] = None):
    """Build run(x0_batch, generator=None) -> ClosedLoopResult.

    Each step re-solves every scenario's OCP (warm-started from its own
    previous shifted solution) and steps its plant with the first move.
    ``x0_batch`` (B, nx), numpy or a tensor; the results are tensors on the
    controller's device."""
    def build(device):
        c = _Controller(*_placed(device, nmpc, plant_model), plant_p)
        w_std = None if process_noise_std is None else c.tensor(process_noise_std)

        def run(x0_batch, generator=None) -> ClosedLoopResult:
            _check_generator(generator, w_std is not None)
            x = c.tensor(x0_batch)
            B = x.shape[0]
            Xw, Uw = c.start(x)
            u_old = x.new_zeros(B, c.nu)
            X, U, conv, iters = [x], [], [], []
            for k in range(steps):
                sol, u_old, (Xw, Uw) = c.solve(x, u_old, Xw, Uw)
                x = c.plant(x, u_old, k)
                if w_std is not None:
                    x = c.noise(w_std, x, generator)
                X.append(x)
                U.append(u_old)
                conv.append(sol.converged)
                iters.append(sol.iterations)
            return ClosedLoopResult(X=torch.stack(X, 1), U=torch.stack(U, 1),
                                    converged=torch.stack(conv, 1),
                                    iterations=torch.stack(iters, 1))

        return run

    return _shardable(build, lambda args: 1)


def fused_closed_loop_mhe_fn(nmpc, plant_model, mhe, steps: int,
                             plant_p: Optional[np.ndarray] = None,
                             process_noise_std: Optional[np.ndarray] = None,
                             meas_noise_std: Optional[np.ndarray] = None):
    """A loop with a moving-horizon estimator in the feedback path: each
    step solves the controller at the estimate, steps the plant, measures,
    shifts the measurement window and solves the window problem with a free
    initial state — two batched interior-point solves per step.

    ``mhe`` must be a set-up MovingHorizonEstimator on the controller's model
    without estimated parameters. The window starts full: the run function
    takes ``y_window0 (B, N_w+1, ny)``, ``u_window0 (B, N_w+1, nu)`` and the
    arrival states ``x_arrival0 (B, nx)``, e.g. from a short recorded start.

    Returns run(x0_true, y_window0, u_window0, x_arrival0, generator=None)
    -> ClosedLoopMHEResult."""
    def build(device):
        nmpc_d, plant_d, mhe_d = _placed(device, nmpc, plant_model, mhe)
        c = _Controller(nmpc_d, plant_d, plant_p)
        if not mhe_d.is_setup():
            raise RuntimeError("mhe must be set up")
        if mhe_d._est_params:
            raise NotImplementedError(
                "fused MHE loop supports state estimation only (no estimated "
                "parameters); use the host-driven loop for joint estimation")
        m_opts = dataclasses.replace(mhe_d._ip_opts, record_iterates=False)
        meas_fn = plant_d.meas_fn()
        p_mhe = c.tensor(mhe_d._p_or_default(None))
        nx, nu = c.nx, c.nu
        ny = len(plant_d.measurements)
        Nw = mhe_d.horizon
        w_std = None if process_noise_std is None else c.tensor(process_noise_std)
        v_std = None if meas_noise_std is None else c.tensor(meas_noise_std)

        def run(x0_true, y_window0, u_window0, x_arrival0, generator=None):
            _check_generator(generator, w_std is not None or v_std is not None)
            x_true, Ys, Us, x_arr = (c.tensor(a) for a in (x0_true, y_window0, u_window0,
                                                           x_arrival0))
            B = x_true.shape[0]
            x_est = x_arr
            Xc, Uc = c.start(x_est)
            Xm = x_arr[:, None, :].expand(B, Nw + 1, nx).contiguous()
            Wm = x_arr.new_zeros(B, Nw, mhe_d._dims.nu)
            t_m = torch.zeros((), **c.kw)
            u_old = x_true.new_zeros(B, nu)
            X, Xe, U, conv, conv_m, iters, iters_m = [x_true], [], [], [], [], [], []
            for k in range(steps):
                sol, u_old, (Xc, Uc) = c.solve(x_est, u_old, Xc, Uc)
                x_true = c.plant(x_true, u_old, k)
                if w_std is not None:
                    x_true = c.noise(w_std, x_true, generator)
                y = one_row_last(meas_fn(x_true, x_true.new_zeros(B, c.nz), u_old,
                                         c.p_plant.expand(B, -1), c.time(k + 1)),
                                 x_true, ny)
                if v_std is not None:
                    y = c.noise(v_std, y, generator)
                Ys = torch.cat([Ys[:, 1:], y[:, None]], dim=1)
                Us = torch.cat([Us[:, 1:], u_old[:, None]], dim=1)
                th_m = mhe_d._theta_batch(Ys, Us, x_arr, p_mhe, t0=t_m)
                sol_m = solve_ocp(mhe_d._funcs, mhe_d._dims, mhe_d._bounds, th_m, x_arr,
                                  _shift(Xm), _shift(Wm), options=m_opts, fix_x0=False)
                x_est, x_arr = sol_m.X[:, -1, :nx], sol_m.X[:, 1, :nx]
                Xm, Wm = sol_m.X, sol_m.U
                t_m = t_m + c.dt
                X.append(x_true)
                Xe.append(x_est)
                U.append(u_old)
                conv.append(sol.converged)
                conv_m.append(sol_m.converged)
                iters.append(sol.iterations)
                iters_m.append(sol_m.iterations)
            return ClosedLoopMHEResult(X=torch.stack(X, 1), X_est=torch.stack(Xe, 1),
                                       U=torch.stack(U, 1), converged=torch.stack(conv, 1),
                                       mhe_converged=torch.stack(conv_m, 1),
                                       iterations=torch.stack(iters, 1),
                                       mhe_iterations=torch.stack(iters_m, 1))

        return run

    return _shardable(build, lambda args: 4)


def fused_closed_loop_ekf_fn(nmpc, plant_model, ekf, steps: int,
                             plant_p: Optional[np.ndarray] = None,
                             process_noise_std: Optional[np.ndarray] = None,
                             meas_noise_std: Optional[np.ndarray] = None):
    """A loop with a Kalman filter in the feedback path: controller solve,
    plant step, measurement and filter predict/update each step. The
    controller only sees the estimate; the true state is returned too.

    ``ekf`` is any set-up KF/EKF/UKF: its per-scenario step
    (x, P, u, p, y, t) -> (x+, P+, y_pred) runs over the batch under
    ``torch.func.vmap``. Returns run(x0_batch, x_est0, P0, generator=None)
    -> ClosedLoopEKFResult; x0_batch is the TRUE initial state batch, P0
    (nx, nx) shared or (B, nx, nx)."""
    def build(device):
        nmpc_d, plant_d, ekf_d = _placed(device, nmpc, plant_model, ekf)
        c = _Controller(nmpc_d, plant_d, plant_p)
        meas_fn = plant_d.meas_fn()
        ekf_step = vmap(ekf_d.step_fn(), in_dims=(0, 0, 0, None, 0, None))
        p_ekf = c.tensor(ekf_d._p_or_default(None))
        nx, nu = c.nx, c.nu
        ny = len(plant_d.measurements)
        w_std = None if process_noise_std is None else c.tensor(process_noise_std)
        v_std = None if meas_noise_std is None else c.tensor(meas_noise_std)

        def run(x0_batch, x_est0_batch, P0, generator=None) -> ClosedLoopEKFResult:
            _check_generator(generator, w_std is not None or v_std is not None)
            x_true, x_est, P = (c.tensor(a) for a in (x0_batch, x_est0_batch, P0))
            B = x_true.shape[0]
            if P.dim() == 2:
                P = P.expand(B, nx, nx)
            Xw, Uw = c.start(x_est)
            u_old = x_true.new_zeros(B, nu)
            X, Xe, U, conv, iters = [x_true], [], [], [], []
            for k in range(steps):
                sol, u_old, (Xw, Uw) = c.solve(x_est, u_old, Xw, Uw)
                x_true = c.plant(x_true, u_old, k)
                if w_std is not None:
                    x_true = c.noise(w_std, x_true, generator)
                y = one_row_last(meas_fn(x_true, x_true.new_zeros(B, c.nz), u_old,
                                         c.p_plant.expand(B, -1), c.time(k + 1)),
                                 x_true, ny)
                if v_std is not None:
                    y = c.noise(v_std, y, generator)
                x_est, P, _ = ekf_step(x_est, P, u_old, p_ekf, y, c.time(k))
                X.append(x_true)
                Xe.append(x_est)
                U.append(u_old)
                conv.append(sol.converged)
                iters.append(sol.iterations)
            return ClosedLoopEKFResult(X=torch.stack(X, 1), X_est=torch.stack(Xe, 1),
                                       U=torch.stack(U, 1), converged=torch.stack(conv, 1),
                                       iterations=torch.stack(iters, 1))

        return run

    return _shardable(build, lambda args: 3 if np.ndim(args[2]) == 3 else 2)
