"""Nonlinear model predictive control.

PyTorch port of the standard formulation of ``hilo_mpc_tpu/control/nmpc.py``:
quadratic tracking costs on states, inputs and measurements (constant or
runtime references), generic (callable) stage and terminal costs, box bounds
on states and inputs (the state bounds optionally soft), generic stage and
terminal constraints (hard, soft, or equalities through the solver's
augmented Lagrangian), scaling, time-invariant parameters, warm starts and
multi-start; and the augmented formulations: Δu costs and bounds and a
control horizon (the state carries u_prev, the control is Δu), path
following (a path parameter state and its virtual velocity control) and
minimum time (a dt-carrying state and a stage-0 dt-adjust control);
time-varying parameters (a (T, n_tvp) table read by the closed-loop step
count, wrapping around); real-time iteration (``rti_prepare`` /
``rti_feedback`` and their batched forms: a solve at the predicted state
ahead of the measurement, then the first move corrected by the first-stage
Riccati gain, a host-side matvec and clip); the solver's iterate history
(``ipopt_debugger``); discrete (mixed-integer) inputs (a relaxed solve,
then every rounding candidate, the discrete inputs pinned, in one batched
solve; the best converged candidate wins); and the open-loop
``OptimalControlProblem``. The multiple-shooting structure is
kept stagewise and solved by the batched interior point of ops/ip_solver.py,
whose Riccati step runs as a hand-written CUDA kernel on CUDA tensors. With
the ``pallas_full`` option, ``solve_batch_fn`` sends eligible problems to the
whole-solve interior point instead: one CUDA kernel per batched solve, with
the model and cost emitted as C++ (ops/whole_ip.py, ops/codegen_cuda.py).

Entry points: ``setup(options, device=..., dtype=...)`` (explicit device and
dtype, nothing chosen by detection; ``"cuda"`` unless the caller passes
``device="cpu"``), ``prepare_batch`` -> ``solve_batch_fn``
for B scenarios at once, ``optimize`` for one closed-loop step and
``optimize_batch``. Every problem function is batch-first: x (..., n_x),
u (..., n_u), theta (..., n_theta).

The model may be a DAE, integrated by any method of core/integrators.py
(``integration_method``, ``degree``, ``collocation_scheme``,
``newton_iters``); the algebraic states' Newton guess is the model's z0, else
zeros. ``pallas_full`` takes them (the emitted step runs the Newton inside
the kernel, csrc/implicit.cuh) up to a Newton of ``NEWTON_MAX`` unknowns;
above it, and with a free final time, it warns naming the reason and takes
the general path.

Same-configuration controllers share what ``setup`` and the whole-solve
route build (utils/trace_cache.py): the canonical problem objects and, under
the entry's sites, the whole-solve gate, emission and loaded entry point.
"""
from __future__ import annotations

import dataclasses
import itertools
import time as _time
import warnings
from typing import Optional

import numpy as np
import torch
from torch.func import hessian, jacrev, vmap

from ..core.integrators import IntegratorSpec, make_step
from ..core.model import Model, one_row_last, records_setup, resolve_device
from ..core.series import TimeSeries
from ..ops.codegen_cuda import OCPSource
from ..ops.ip_solver import (IPOptions, OCPBounds, OCPDims, OCPFunctions,
                             OCPSolution, _check_supported, solve_ocp)
from ..ops.riccati import backward_sweep
from ..ops.whole_ip import (WholeIPLaunch, solve_ocp_full_cuda, whole_ip_gate,
                            whole_ip_problem)
from ..utils.trace_cache import arr_key, registry_lookup, registry_store
from .costs import GenericCost, QuadraticCost, make_constraint

_NLP_OPTION_KEYS = {
    "integration_method", "degree", "collocation_scheme", "substeps",
    "newton_iters", "max_iter", "tol", "mu_init", "warm_start", "print_level",
    "dt", "convexify", "n_linesearch", "early_exit", "u_pf_lb", "u_pf_ub",
    "ipopt_debugger", "parallel_riccati", "pallas_riccati", "mehrotra",
    "riccati_unroll", "pallas_full", "pallas_tile", "pallas_full_pack",
    "pallas_vmem_mb", "const_cost_hessian", "lin_storage_dtype",
    "mi_neighbors",
    "mi_max_enum",
    "initial_guess",
}


def _snapshot(term):
    """A copy of a quadratic cost term with its own arrays."""
    return dataclasses.replace(term, idx=np.array(term.idx), W=np.array(term.W),
                               ref=None if term.ref is None else np.array(term.ref))


class NMPC:
    """Nonlinear MPC over a Model."""

    _controller_type = "NMPC"

    def __init__(self, model: Model, id: Optional[str] = None,
                 name: Optional[str] = None):
        self._model = model.copy(keep_solution=False)
        self.name = name or f"nmpc_{self._model.name}"
        self.quad_stage_cost = QuadraticCost(self._model)
        self.quad_terminal_cost = QuadraticCost(self._model)
        self.stage_cost = GenericCost(self._model)
        self.terminal_cost = GenericCost(self._model)
        self._stage_constraints = []
        self._terminal_constraints = []

        self._horizon: Optional[int] = None
        self._control_horizon: Optional[int] = None
        nx, nu = self._model.n_x, self._model.n_u
        self._x_lb = np.full(nx, -np.inf); self._x_ub = np.full(nx, np.inf)
        self._u_lb = np.full(nu, -np.inf); self._u_ub = np.full(nu, np.inf)
        self._du_lb = np.full(nu, -np.inf); self._du_ub = np.full(nu, np.inf)
        self._x_soft = False
        self._soft_weight = 1e4
        self._x_scaling = np.ones(nx)
        self._u_scaling = np.ones(nu)
        self._x_guess: Optional[np.ndarray] = None
        self._u_guess = np.zeros(nu)
        self._tvp_names: list = []
        self._tvp_values: Optional[np.ndarray] = None   # (T, n_tvp)
        self._p_defaults: Optional[np.ndarray] = None

        self._path_following = False
        self._path_u_bounds = (0.0, np.inf)
        self._path_speed = None
        self._min_time = None
        self._augment_du = False
        self._discrete_inputs: dict = {}   # input name -> levels array | None
        self._mi = None                    # resolved at setup()

        self._setup_done = False
        self._opts: dict = {}
        self._device = torch.device("cpu")
        self._dtype = torch.float32
        self._time = 0.0
        self._step_count = 0
        self._u_old = np.zeros(nu)
        self._theta_path0 = 0.0
        self._warm = None          # previous (X, U) scaled solution for warm start
        self._rti = None           # prepared RTI data (rti_prepare/rti_feedback)
        self._rti_pending = None   # (xs0, U, theta) applied by the last feedback
        # int k: the RTI prepare (single and batched) runs exactly k
        # interior-point iterations (classical single-iteration RTI at
        # k = 1); None: a full solve
        self.rti_gn_iterations = None
        self._rti_batch = None     # prepared batched-RTI data
        self._rti_batch_warm = None  # the last batched-RTI solution (X, U)
        self._rti_batch_u_old = None  # the fleet's applied inputs (Δu)
        self.iteration_history = None
        self.solution: Optional[TimeSeries] = None
        self.last_prediction = None
        self.stats: dict = {}
        # the whole-solve path prepared for the current problem (_whole_ip_cache)
        self._wip: Optional[dict] = None
        self._trace_entry = None   # cross-instance registry entry

    # -- basic configuration -------------------------------------------------
    @property
    def horizon(self) -> Optional[int]:
        return self._horizon

    @horizon.setter
    def horizon(self, N: int):
        if int(N) < 1:
            raise ValueError("horizon must be >= 1")
        self._horizon = int(N)

    prediction_horizon = horizon

    @property
    def control_horizon(self) -> Optional[int]:
        return self._control_horizon if self._control_horizon else self._horizon

    @control_horizon.setter
    def control_horizon(self, Nc: int):
        if int(Nc) < 1:
            raise ValueError("control horizon must be >= 1")
        self._control_horizon = int(Nc)

    @property
    def n_x(self): return self._model.n_x
    @property
    def n_u(self): return self._model.n_u

    @property
    def device(self) -> torch.device: return self._device
    @property
    def dtype(self) -> torch.dtype: return self._dtype

    def set_box_constraints(self, x_lb=None, x_ub=None, u_lb=None, u_ub=None,
                            du_lb=None, du_ub=None, x_soft: bool = False,
                            soft_weight: float = 1e4):
        """Box bounds; with ``x_soft`` every finite state bound becomes the
        penalty soft_weight·Σ relu(x − ub)² + relu(lb − x)² in the stage and
        terminal costs instead of a barrier row."""
        def setv(cur, val, n):
            if val is None:
                return cur
            return np.broadcast_to(np.asarray(val, dtype=float).ravel(), (n,)).copy()

        nx, nu = self._model.n_x, self._model.n_u
        self._x_lb = setv(self._x_lb, x_lb, nx)
        self._x_ub = setv(self._x_ub, x_ub, nx)
        self._u_lb = setv(self._u_lb, u_lb, nu)
        self._u_ub = setv(self._u_ub, u_ub, nu)
        self._du_lb = setv(self._du_lb, du_lb, nu)
        self._du_ub = setv(self._du_ub, du_ub, nu)
        self._x_soft = bool(x_soft)
        self._soft_weight = float(soft_weight)
        return self

    def set_initial_guess(self, x_guess=None, u_guess=None):
        if x_guess is not None:
            self._x_guess = np.asarray(x_guess, dtype=float).ravel()
        if u_guess is not None:
            self._u_guess = np.broadcast_to(
                np.asarray(u_guess, dtype=float).ravel(), (self._model.n_u,)).copy()
        return self

    def set_scaling(self, x_scaling=None, u_scaling=None):
        if x_scaling is not None:
            self._x_scaling = np.broadcast_to(
                np.asarray(x_scaling, float).ravel(), (self._model.n_x,)).copy()
        if u_scaling is not None:
            self._u_scaling = np.broadcast_to(
                np.asarray(u_scaling, float).ravel(), (self._model.n_u,)).copy()
        return self

    def set_parameters(self, p):
        self._p_defaults = np.asarray(p, dtype=float).ravel()
        return self

    def add_stage_constraint(self, fn=None, lb=None, ub=None, n=None,
                             is_soft=False, weight=1e4, max_violation=None,
                             name="stage_constraint"):
        """lb <= fn(x, u, p, t) <= ub at every stage; fn is batch-first and
        returns (..., n), or (...) for one row."""
        con = make_constraint(fn, lb=lb, ub=ub, n=n, is_soft=is_soft, weight=weight,
                              max_violation=max_violation, name=name,
                              probe_dims=(self._model.n_x, self._model.n_u,
                                          self._model.n_p))
        self._stage_constraints.append(con)
        return self

    def add_terminal_constraint(self, fn=None, lb=None, ub=None, n=None,
                                is_soft=False, weight=1e4, max_violation=None,
                                name="terminal_constraint"):
        """lb <= fn(x, u, p, t) <= ub at the last state (u = 0)."""
        con = make_constraint(fn, lb=lb, ub=ub, n=n, is_soft=is_soft, weight=weight,
                              max_violation=max_violation, name=name,
                              probe_dims=(self._model.n_x, 0, self._model.n_p))
        self._terminal_constraints.append(con)
        return self

    def create_path_variable(self, u_pf_lb: float = 0.0, u_pf_ub: float = np.inf,
                             speed_ref: Optional[float] = None,
                             speed_weight: float = 1.0):
        """Path-following mode: the state gains a path parameter th and the
        control its velocity u_pf (u_pf_lb <= u_pf <= u_pf_ub), with
        th_{k+1} = th_k + h·u_pf; ``speed_ref`` adds the stage penalty
        speed_weight·(u_pf − speed_ref)², which rewards progress."""
        self._path_following = True
        self._path_u_bounds = (float(u_pf_lb), float(u_pf_ub))
        self._path_speed = (None if speed_ref is None
                            else (float(speed_ref), float(speed_weight)))
        return self

    def minimize_final_time(self, weight: float = 1.0, dt_min: float = 1e-3,
                            dt_max: Optional[float] = None):
        """Minimum-time mode: the step length is a decision variable. A
        state tau carries it down the horizon, a control adjusts it at stage
        0 only (pinned to 0 elsewhere), dt_min <= tau <= dt_max, and the
        objective gains weight·Σ_k h_k = weight·T."""
        self._min_time = {"weight": float(weight), "dt_min": float(dt_min),
                          "dt_max": (np.inf if dt_max is None else float(dt_max))}
        return self

    def set_time_varying_parameters(self, names, values=None):
        """Declare model parameters whose values vary over time; ``values``
        as for ``set_tvp_values``."""
        if isinstance(names, str):
            names = [names]
        for nm in names:
            if nm not in self._model.parameters:
                raise ValueError(f"{nm!r} is not a model parameter")
        self._tvp_names = list(names)
        if values is not None:
            self.set_tvp_values(values)
        return self

    def set_tvp_values(self, values):
        """values: dict name -> (T,) array, or array (T, n_tvp). Row k is
        read at closed-loop step k, wrapping around after T rows."""
        if isinstance(values, dict):
            cols = [np.asarray(values[nm], dtype=float).ravel()
                    for nm in self._tvp_names]
            T = max(c.size for c in cols)
            arr = np.stack([np.resize(c, T) for c in cols], axis=1)
        else:
            arr = np.atleast_2d(np.asarray(values, dtype=float))
            if arr.shape[1] != len(self._tvp_names):
                arr = arr.T
        self._tvp_values = arr
        return self

    def set_discrete_inputs(self, inputs, levels=None):
        """Declare inputs that may only take values from a finite set
        (mixed-integer NMPC): ``optimize`` solves the relaxed problem, then a
        batch of rounding/neighbourhood candidates with the discrete inputs
        pinned (lbu == ubu), all in ONE batched solve; the best converged
        candidate wins.

        :param inputs: input name(s) or index(es) into model.inputs
        :param levels: allowed values — one array applied to every declared
            input, or a list of arrays (one per input). ``None`` derives the
            integer lattice from the box bounds at setup() (finite u bounds
            needed)."""
        if isinstance(inputs, (str, int)):
            inputs = [inputs]
        inputs = list(inputs)
        if levels is None:
            per_input = [None] * len(inputs)
        elif isinstance(levels, (list, tuple)) and len(levels) and \
                isinstance(levels[0], (list, tuple, np.ndarray)):
            if len(levels) != len(inputs):
                raise ValueError(f"{len(inputs)} inputs but {len(levels)} level sets")
            per_input = [np.asarray(lv, dtype=float).ravel() for lv in levels]
        else:
            per_input = [np.asarray(levels, dtype=float).ravel()] * len(inputs)
        names = self._model.inputs
        for inp, lv in zip(inputs, per_input):
            name = names[inp] if isinstance(inp, int) else inp
            if name not in names:
                raise ValueError(f"unknown input {name!r} (have {names})")
            if lv is not None and lv.size < 2:
                raise ValueError(f"input {name!r}: need >= 2 levels, got {lv}")
            self._discrete_inputs[name] = None if lv is None else np.unique(lv)
        return self

    # -- setup ----------------------------------------------------------------
    def _trace_signature(self, spec, aug, path, mt, ip_opts, dims):
        """Exhaustive hashable key of everything baked into the problem
        functions (see utils/trace_cache.py): JAX's
        (``hilo_mpc_tpu/control/nmpc.py:_trace_signature``) with the device
        and dtype in place of JAX's x64 flag. Returns (sig, keep); sig is
        None when this configuration must not be shared (discrete inputs, as
        in JAX)."""
        keep = []
        if self._mi is not None:
            return None, keep
        msig, mkeep = self._model.trace_signature()
        keep += mkeep

        def fid(obj):
            if obj is None:
                return None
            keep.append(obj)
            return ("id", id(obj))

        def term_sig(t):
            return (t.kind, tuple(int(i) for i in t.idx), arr_key(t.W),
                    arr_key(t.ref), bool(t.trajectory_tracking),
                    bool(t.path_following), fid(t.path_fn))

        def con_sig(c):
            return (fid(c.fn), int(c.n), arr_key(c.lb), arr_key(c.ub),
                    bool(c.is_soft), float(c.weight), float(c.linear_weight),
                    arr_key(c.max_violation))

        x_soft = np.asarray(self._x_soft, dtype=bool)
        sig = (
            "nmpc", msig, int(dims.N), int(self.control_horizon), float(self._dt),
            (spec.method, spec.degree, spec.scheme, spec.substeps, spec.newton_iters),
            bool(aug), bool(path), bool(mt),
            None if self._min_time is None else (
                float(self._min_time["weight"]), float(self._min_time["dt_min"]),
                float(self._min_time["dt_max"])),
            None if self._path_speed is None else tuple(map(float, self._path_speed)),
            arr_key(self._x_scaling), arr_key(self._u_scaling),
            arr_key(x_soft), float(self._soft_weight),
            ((arr_key(self._x_lb), arr_key(self._x_ub)) if x_soft.any() else None),
            tuple(term_sig(t) for t in self.quad_stage_cost.terms),
            tuple(term_sig(t) for t in self.quad_terminal_cost.terms),
            "empty" if self.stage_cost.is_empty else fid(self.stage_cost.cost),
            "empty" if self.terminal_cost.is_empty else fid(self.terminal_cost.cost),
            tuple(con_sig(c) for c in self._stage_constraints),
            tuple(con_sig(c) for c in self._terminal_constraints),
            tuple(dataclasses.astuple(ip_opts)),
            str(self._device), str(self._dtype),
        )
        try:
            hash(sig)
        except TypeError:
            return None, keep
        return sig, keep

    def _shared_site(self, name, build):
        """Per-configuration lazy cache: same-configuration instances share
        the object built for ``name`` (no registry entry: private)."""
        ent = self._trace_entry
        if ent is None:
            return build()
        if name not in ent["sites"]:
            ent["sites"][name] = build()
        return ent["sites"][name]

    @records_setup
    def setup(self, options: Optional[dict] = None, solver_options: Optional[dict]
              = None, nlp_opts: Optional[dict] = None, device="cuda",
              dtype=torch.float32):
        """Build the stagewise problem on ``device`` in ``dtype``. A CUDA
        device that PyTorch cannot see raises; pass ``device="cpu"`` to run
        on the CPU."""
        options = dict(options or {})
        options.update(nlp_opts or {})
        unknown = set(options) - _NLP_OPTION_KEYS
        if unknown:
            raise ValueError(f"unknown options {sorted(unknown)}; "
                             f"valid: {sorted(_NLP_OPTION_KEYS)}")
        if self._horizon is None:
            raise ValueError("set nmpc.horizon before setup()")
        model = self._model
        nx, nu, n_p = model.n_x, model.n_u, model.n_p
        N = self._horizon
        Nc = self.control_horizon
        dt = options.get("dt", model.dt)
        if dt is None:
            raise ValueError("no sampling time: set model.setup(dt=...) or pass "
                             "options={'dt': ...}")
        self._device = resolve_device(device)
        self._dt = float(dt)
        self._opts = options
        self._dtype = dtype
        kw = dict(dtype=dtype, device=self._device)

        # the augmented formulations: u_prev in the state and Δu as the
        # control; a path parameter and its velocity; the dt-carrying state
        # and its stage-0 adjustment
        # the problem functions keep the cost terms as they are now: a term
        # edited later reaches the solver through the next setup(), as in
        # JAX, and controllers that share them (utils/trace_cache.py) share
        # no mutable term
        stage_terms = [_snapshot(t) for t in self.quad_stage_cost.terms]
        term_terms = [_snapshot(t) for t in self.quad_terminal_cost.terms]
        has_du = (any(t.kind == "inputs_change" for t in stage_terms + term_terms)
                  or np.any(np.isfinite(self._du_lb))
                  or np.any(np.isfinite(self._du_ub)) or Nc < N)
        aug = self._augment_du = bool(has_du and nu > 0)
        if self._discrete_inputs and aug:
            raise ValueError(
                "discrete inputs are incompatible with the Δu formulation "
                "(Δu penalties/bounds or control_horizon < horizon): the solver's "
                "control variable would be the input increment, not the input")
        path = self._path_following = self._path_following or any(
            t.path_following for t in stage_terms + term_terms)
        mt = self._min_time is not None
        nxs = nx + (nu if aug else 0) + (1 if path else 0) + (1 if mt else 0)
        nus = nu + (1 if path else 0) + (1 if mt else 0)
        idx_path = nx + (nu if aug else 0)  # path parameter state
        idx_upf = nu                        # its velocity control
        idx_vtau = nu + (1 if path else 0)  # the dt-adjust control
        idx_tau = nxs - 1                   # the dt-carrying state

        int_method = options.get("integration_method",
                                 "discrete" if model.discrete else "rk4")
        if int_method == "multiple_shooting":
            int_method = "rk4"
        spec = IntegratorSpec(
            method=int_method, degree=options.get("degree", 3),
            scheme=options.get("collocation_scheme", "radau"),
            substeps=options.get("substeps", 1),
            newton_iters=options.get("newton_iters", 8))
        core_step = make_step(model.ode_fn(), model.alg_fn(), nx, model.n_z, spec)
        # the algebraic states' Newton guess: the model's z0, else zeros
        z_guess = torch.as_tensor(model._z0 if model._z0 is not None
                                  else np.zeros(model.n_z), **kw)

        sx = torch.as_tensor(self._x_scaling, **kw)
        su = torch.as_tensor(self._u_scaling, **kw)

        # theta layout: [t, dt, p (n_p), stage_refs (n_ref_s), term_refs (n_ref_t)]
        n_ref_s = sum(t.n for t in stage_terms if t.runtime_ref)
        off_p = 2
        off_rs = off_p + n_p
        off_rt = off_rs + n_ref_s
        step_dt = self._dt

        def unpack(xs, us, theta):
            """(x, u, Δu, p, t, h, th_path) of the solver's (xs, us)."""
            x = xs[..., :nx] * sx
            h = xs[..., idx_tau] + us[..., idx_vtau] if mt else theta[..., 1]
            if aug:
                du = us[..., :nu] * su
                u = xs[..., nx:nx + nu] * su + du
            else:
                u = us[..., :nu] * su
                du = torch.zeros_like(u)
            th_path = xs[..., idx_path] if path else torch.zeros_like(x[..., 0])
            return x, u, du, theta[..., off_p:off_p + n_p], theta[..., 0], h, th_path

        def dyn(xs, us, theta):
            x, u, _, p, t, h, th_path = unpack(xs, us, theta)
            zg = z_guess.expand(x.shape[:-1] + z_guess.shape)
            x_next, _ = core_step(x, zg, u, p, t, h)
            parts = [x_next / sx]
            if aug:
                parts.append(u / su)
            if path:
                parts.append((th_path + h * us[..., idx_upf])[..., None])
            if mt:
                parts.append(h[..., None])
            return torch.cat(parts, dim=-1)

        meas_fn = model.meas_fn()

        def measurements(x, u, p, t):
            y = meas_fn(x, x[..., :0], u, p, t)
            # a model of one measurement may give the batch shape itself
            return y[..., None] if y.dim() == x.dim() - 1 else y

        def quad_terms_cost(terms, ref_offset, x, u, du, p, t, th_path, theta):
            cost = torch.zeros_like(x[..., 0])
            off = ref_offset
            for term in terms:
                if term.kind == "states":
                    src = x
                elif term.kind == "inputs":
                    src = u
                elif term.kind == "inputs_change":
                    src = du
                else:
                    src = measurements(x, u, p, t)
                v = torch.stack([src[..., int(i)] for i in term.idx], dim=-1)
                if term.path_following and term.path_fn is not None:
                    ref = one_row_last(term.path_fn(th_path), v, term.n)
                elif term.runtime_ref:
                    ref = theta[..., off:off + term.n]
                    off += term.n
                elif term.ref is not None:
                    ref = torch.as_tensor(term.ref, dtype=x.dtype, device=x.device)
                else:
                    ref = torch.zeros(term.n, dtype=x.dtype, device=x.device)
                e = v - ref
                # unrolled eᵀWe over the nonzero weights, as the JAX cost
                for i in range(term.n):
                    for j in range(term.n):
                        if term.W[i, j] != 0.0:
                            cost = cost + float(term.W[i, j]) * e[..., i] * e[..., j]
            return cost

        # soft state bounds: every finite state bound becomes a relu² penalty
        x_pen_ub = np.where(self._x_soft, self._x_ub, np.inf)
        x_pen_lb = np.where(self._x_soft, self._x_lb, -np.inf)
        soft_w = self._soft_weight
        x_soft = self._x_soft
        soft_cons_s = [c for c in self._stage_constraints if c.is_soft]
        soft_cons_t = [c for c in self._terminal_constraints if c.is_soft]
        pen_ub = torch.as_tensor(np.where(np.isfinite(x_pen_ub), x_pen_ub, 1e20), **kw)
        pen_lb = torch.as_tensor(np.where(np.isfinite(x_pen_lb), x_pen_lb, -1e20), **kw)

        def soft_box_penalty(x):
            zero = torch.zeros((), dtype=x.dtype, device=x.device)
            viol = torch.maximum(x - pen_ub, zero) + torch.maximum(pen_lb - x, zero)
            return soft_w * (viol ** 2).sum(dim=-1)

        gen_stage, gen_term = self.stage_cost, self.terminal_cost
        speed = self._path_speed if path else None
        mt_weight = self._min_time["weight"] if mt else 0.0

        def stage_cost(xs, us, theta):
            x, u, du, p, t, h, th_path = unpack(xs, us, theta)
            c = quad_terms_cost(stage_terms, off_rs, x, u, du, p, t, th_path, theta)
            if not gen_stage.is_empty:
                c = c + gen_stage(x, u, p, t)
            if x_soft:
                c = c + soft_box_penalty(x)
            for con in soft_cons_s:
                c = c + con.penalty(con.fn(x, u, p, t))
            if speed is not None:
                c = c + speed[1] * (us[..., idx_upf] - speed[0]) ** 2
            # integrate stage cost over the sample interval: multiply by dt
            c = c * h / step_dt
            if mt:
                c = c + mt_weight * h
            return c

        def term_args(xs, theta):
            """(x, u = 0, p, t) of the terminal functions."""
            x = xs[..., :nx] * sx
            u0 = torch.zeros(x.shape[:-1] + (nu,), dtype=x.dtype, device=x.device)
            return x, u0, theta[..., off_p:off_p + n_p], theta[..., 0]

        def term_cost(xs, theta):
            x, u0, p, t = term_args(xs, theta)
            th_path = xs[..., idx_path] if path else torch.zeros_like(x[..., 0])
            c = quad_terms_cost(term_terms, off_rt, x, u0, u0, p, t, th_path, theta)
            if not gen_term.is_empty:
                c = c + gen_term(x, u0, p, t)
            if x_soft:
                c = c + soft_box_penalty(x)
            for con in soft_cons_t:
                c = c + con.penalty(con.fn(x, u0, p, t))
            return c

        # --- generic rows: hard inequalities (static row selection) and
        # equalities (lb == ub, the solver's augmented Lagrangian) ---
        hard_s = [(c,) + c.hard_rows() for c in self._stage_constraints]
        hard_t = [(c,) + c.hard_rows() for c in self._terminal_constraints]
        n_h = sum(int(ub_r.sum() + lb_r.sum()) for _, ub_r, lb_r, _, _ in hard_s)
        n_hN = sum(int(ub_r.sum() + lb_r.sum()) for _, ub_r, lb_r, _, _ in hard_t)
        eq_s = [(c, c.equality_rows()) for c in self._stage_constraints
                if c.equality_rows().any()]
        eq_t = [(c, c.equality_rows()) for c in self._terminal_constraints
                if c.equality_rows().any()]
        n_e = sum(int(r.sum()) for _, r in eq_s)
        n_eN = sum(int(r.sum()) for _, r in eq_t)

        def ineq_rows(hard, x, u, p, t):
            rows = []
            for con, ub_r, lb_r, ub, lb in hard:
                g = con.fn(x, u, p, t)
                if ub_r.any():
                    rows.append(g[..., np.where(ub_r)[0]]
                                - torch.as_tensor(ub[ub_r], dtype=x.dtype,
                                                  device=x.device))
                if lb_r.any():
                    rows.append(torch.as_tensor(lb[lb_r], dtype=x.dtype, device=x.device)
                                - g[..., np.where(lb_r)[0]])
            return torch.cat(rows, dim=-1)

        def eq_rows(eqs, x, u, p, t):
            return torch.cat([con.fn(x, u, p, t)[..., np.where(r)[0]]
                              - torch.as_tensor(con.ub[r], dtype=x.dtype, device=x.device)
                              for con, r in eqs], dim=-1)

        def stage_ineq(xs, us, theta):
            x, u, _, p, t, _, _ = unpack(xs, us, theta)
            return ineq_rows(hard_s, x, u, p, t)

        def term_ineq(xs, theta):
            return ineq_rows(hard_t, *term_args(xs, theta))

        def stage_eq(xs, us, theta):
            x, u, _, p, t, _, _ = unpack(xs, us, theta)
            return eq_rows(eq_s, x, u, p, t)

        def term_eq(xs, theta):
            return eq_rows(eq_t, *term_args(xs, theta))

        # the cost Hessian is point-independent iff every term is a true
        # quadratic in the decision variables: no generic costs, no soft
        # penalties (piecewise), no nonlinear measurement maps, no
        # path-parameterised references (nonlinear in th_path) and no
        # minimum-time stage scaling (cost · h is cubic); Δu terms are quadratic
        quad_cost_only = (gen_stage.is_empty and gen_term.is_empty and not x_soft
                          and not soft_cons_s and not soft_cons_t and not mt
                          and all(t.kind != "measurements" and not t.path_following
                                  for t in stage_terms + term_terms))
        # what neither whole-solve emitter can write as C++ (cost_error), and
        # what sends a problem from ops/codegen_cuda.py's emitter to the
        # traced route of ops/codegen_fx.py (dsl_error)
        cost_error = dsl_error = None
        if mt:
            cost_error = "a free final time"
        if any(t.path_following for t in stage_terms + term_terms):
            dsl_error = "a path-following reference (a callable of the path parameter)"
        elif path:
            dsl_error = "a path parameter (create_path_variable)"
        elif not gen_stage.is_empty or not gen_term.is_empty:
            dsl_error = "a generic (callable) cost"
        elif any(t.kind == "measurements" for t in stage_terms + term_terms):
            dsl_error = "a measurement cost term"
        elif soft_cons_s or soft_cons_t:
            dsl_error = "a soft generic (callable) constraint"

        dims = OCPDims(nx=nxs, nu=nus, N=N, n_h=n_h, n_hN=n_hN, n_e=n_e, n_eN=n_eN)
        source = OCPSource(
            model=model, spec=spec, off_rs=off_rs, off_rt=off_rt,
            stage_terms=tuple(stage_terms), term_terms=tuple(term_terms),
            x_scaling=tuple(self._x_scaling), u_scaling=tuple(self._u_scaling),
            dt=step_dt, soft_lb=tuple(x_pen_lb), soft_ub=tuple(x_pen_ub),
            soft_weight=soft_w, cost_error=cost_error, augment_du=aug,
            augment_path=path,
            dsl_error=dsl_error,
            n_theta=off_rt + sum(t.n for t in term_terms if t.runtime_ref),
            dtype=dtype, device=self._device,
            z0=tuple(float(v) for v in z_guess.detach().cpu().double().tolist()))
        funcs = OCPFunctions(dyn=dyn, stage_cost=stage_cost, term_cost=term_cost,
                             stage_ineq=stage_ineq if n_h else None,
                             term_ineq=term_ineq if n_hN else None,
                             stage_eq=stage_eq if n_e else None,
                             term_eq=term_eq if n_eN else None, source=source)

        # --- bounds in solver (scaled, augmented) coordinates; soft state
        # bounds leave the barrier rows ---
        su_np = self._u_scaling
        x_lb_s, x_ub_s = self._x_lb / self._x_scaling, self._x_ub / self._x_scaling
        if x_soft:
            x_lb_s, x_ub_s = np.full(nx, -np.inf), np.full(nx, np.inf)
        lbx, ubx = [np.tile(x_lb_s, (N + 1, 1))], [np.tile(x_ub_s, (N + 1, 1))]
        if aug:
            # u bounds on the u_prev component (rows 1..N hold u_0..u_{N-1})
            u_lb_st = np.tile(self._u_lb / su_np, (N + 1, 1))
            u_ub_st = np.tile(self._u_ub / su_np, (N + 1, 1))
            u_lb_st[0], u_ub_st[0] = -np.inf, np.inf
            lbx.append(u_lb_st)
            ubx.append(u_ub_st)
        if path:
            lbx.append(np.zeros((N + 1, 1)))
            ubx.append(np.full((N + 1, 1), np.inf))
        if mt:
            lbx.append(np.full((N + 1, 1), self._min_time["dt_min"]))
            ubx.append(np.full((N + 1, 1), self._min_time["dt_max"]))
        if aug:
            lbu, ubu = np.tile(self._du_lb / su_np, (N, 1)), np.tile(self._du_ub / su_np, (N, 1))
            # past the control horizon Δu is pinned to 0
            lbu[Nc:], ubu[Nc:] = 0.0, 0.0
        else:
            lbu, ubu = np.tile(self._u_lb / su_np, (N, 1)), np.tile(self._u_ub / su_np, (N, 1))
        lbu, ubu = [lbu], [ubu]
        if path:
            lbu.append(np.full((N, 1), self._path_u_bounds[0]))
            ubu.append(np.full((N, 1), self._path_u_bounds[1]))
        if mt:
            # dt adjusts only at stage 0; tau carries it down the horizon
            v_lb, v_ub = np.zeros((N, 1)), np.zeros((N, 1))
            v_lb[0] = self._min_time["dt_min"] - self._dt
            v_ub[0] = self._min_time["dt_max"] - self._dt
            lbu.append(v_lb)
            ubu.append(v_ub)
        lbu, ubu = np.concatenate(lbu, axis=1), np.concatenate(ubu, axis=1)
        self._mi = self._setup_discrete(options, N, lbu, ubu)
        self._bounds = OCPBounds(*(torch.as_tensor(np.concatenate(b, axis=1), **kw)
                                   for b in (lbx, ubx)),
                                 *(torch.as_tensor(b, **kw) for b in (lbu, ubu)))
        self._dims = dims
        self._funcs = funcs
        f64 = dtype == torch.float64
        ip_opts = IPOptions(
            max_iter=options.get("max_iter", 40),
            # 1e-6 KKT is routinely unreachable in f32 — follow the dtype
            tol=options.get("tol", 1e-6 if f64 else 1e-4),
            mu_init=options.get("mu_init", 1e-1),
            convexify=options.get("convexify", True),
            n_linesearch=options.get("n_linesearch", 10),
            early_exit=options.get("early_exit", True),
            record_iterates=options.get("ipopt_debugger", False),
            parallel_riccati=options.get("parallel_riccati", False),
            pallas_riccati=options.get("pallas_riccati", False),
            pallas_full=options.get("pallas_full", False),
            pallas_tile=options.get("pallas_tile", 256),
            pallas_full_pack=options.get("pallas_full_pack", 1),
            pallas_vmem_mb=options.get("pallas_vmem_mb", None),
            mehrotra=options.get("mehrotra", True),
            riccati_unroll=options.get("riccati_unroll", 1),
            const_cost_hessian=options.get("const_cost_hessian", quad_cost_only),
            lin_storage_dtype=options.get("lin_storage_dtype", None),
        )
        _check_supported(funcs, dims, ip_opts)
        self._ip_opts = ip_opts
        # a configuration set up before in this process: adopt its canonical
        # objects, so what is keyed on them (the whole-solve route under the
        # entry's sites) is shared
        sig, keep = self._trace_signature(spec, aug, path, mt, ip_opts, dims)
        ent = registry_lookup(sig)
        if ent is not None:
            self._funcs, self._dims, self._ip_opts = ent["funcs"], ent["dims"], ent["ip_opts"]
        elif sig is not None:
            ent = registry_store(sig, {"funcs": funcs, "dims": dims, "ip_opts": ip_opts,
                                       "keep": keep})
        self._trace_entry = ent
        self._warm_start = options.get("warm_start", True)
        guess_mode = options.get("initial_guess", "auto")
        if guess_mode not in ("auto", "rollout", "constant"):
            raise ValueError(
                f"initial_guess must be 'auto', 'rollout' or 'constant', "
                f"got {guess_mode!r}")
        self._guess_mode = guess_mode
        # warm-started solves start from a near-optimal point: a small initial
        # barrier skips the early centering iterations
        self._mu_cold = float(ip_opts.mu_init)
        self._mu_warm = min(float(ip_opts.mu_init), 1e-3)

        # host copies of the bounds for the RTI feedback phase (no device call)
        self._bounds_np = OCPBounds(*(b.cpu().numpy() for b in self._bounds))

        self.solution = TimeSeries(model.time_unit)
        self.solution.register("x", model.dynamical_states)
        self.solution.register("u", model.inputs)
        self.solution.register("stats", ["iterations", "kkt_error", "extime_ms",
                                         "converged"])
        self._setup_done = True
        self._time = 0.0
        self._step_count = 0
        self._warm = None
        self._rti = self._rti_pending = self._rti_batch = None
        self._rti_batch_warm = self._rti_batch_u_old = None
        return self

    def _setup_discrete(self, options, N, lbu, ubu):
        """The discrete inputs' levels in solver units, each relaxed bound
        (``lbu``/``ubu``, edited in place) spanning its level range, the
        neighbourhood size and, if the assignment lattice has at most
        ``mi_max_enum`` points, every assignment (exact mode)."""
        if not self._discrete_inputs:
            return None
        su = self._u_scaling
        mi_dims, mi_levels = [], []
        for name, lv in self._discrete_inputs.items():
            d = self._model.inputs.index(name)
            if lv is None:
                lo, hi = self._u_lb[d], self._u_ub[d]
                if not (np.isfinite(lo) and np.isfinite(hi)):
                    raise ValueError(
                        f"discrete input {name!r}: no levels given and box "
                        f"bounds are not finite — cannot derive the lattice")
                lv = np.arange(np.ceil(lo), np.floor(hi) + 1.0)
            else:
                lv = lv[(lv >= self._u_lb[d]) & (lv <= self._u_ub[d])]
            if lv.size < 2:
                raise ValueError(f"discrete input {name!r}: fewer than 2 "
                                 f"levels remain within the box bounds")
            mi_dims.append(d)
            mi_levels.append(lv / su[d])       # the solver works in scaled units
            # the relaxed problem spans exactly the level range
            lbu[:, d] = lv.min() / su[d]
            ubu[:, d] = lv.max() / su[d]
        mi = {"dims": mi_dims, "levels": mi_levels,
              "neighbors": int(options.get("mi_neighbors", 12)), "cand_enum": None}
        max_enum = int(options.get("mi_max_enum", 512))
        log_count = N * float(sum(np.log(lv.size) for lv in mi_levels))
        if max_enum > 0 and log_count <= np.log(max_enum) + 1e-9:
            entry_levels = [mi_levels[j] for _k in range(N) for j in range(len(mi_dims))]
            cand = np.array(list(itertools.product(*entry_levels)), dtype=float)
            mi["cand_enum"] = cand.reshape(-1, N, len(mi_dims))
        return mi

    def is_setup(self) -> bool:
        return self._setup_done

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a, dtype=float), dtype=self._dtype,
                               device=self._device)

    def _solve(self, theta_B, xs0_B, X_B, U_B, mu0, options=None):
        """The general path's batched solve; with ``record_iterates`` the
        pair (solution, history)."""
        return solve_ocp(self._funcs, self._dims, self._bounds, theta_B, xs0_B,
                         X_B, U_B, options=options or self._ip_opts, fix_x0=True,
                         mu0=mu0)

    def _keep_history(self, out, first=False):
        """The solution of a solve; under ``record_iterates`` its history
        goes to ``iteration_history`` as numpy (one scenario's when
        ``first``, as the JAX package keeps it for ``optimize``)."""
        if not self._ip_opts.record_iterates:
            return out
        sol, hist = out
        self.iteration_history = {k: (v[0] if first else v).cpu().numpy()
                                  for k, v in hist.items()}
        return sol

    # -- theta assembly --------------------------------------------------------
    def _assemble_p_rows(self, cp, tvp, N, step0):
        """(N+1, n_p) parameter rows: the defaults or ``cp`` (all parameters,
        or only the constant ones), then the time-varying columns from
        ``tvp`` (rows; one row holds over the horizon, a short table is
        padded with its last row) or else from the stored table at rows
        step0.. (wrapping around)."""
        n_p = self._model.n_p
        p_rows = np.zeros((N + 1, n_p))
        base = np.zeros(n_p)
        if self._p_defaults is not None:
            base[:] = self._p_defaults
        if cp is not None:
            cp = np.asarray(cp, dtype=float).ravel()
            const_idx = [i for i, nm in enumerate(self._model.parameters)
                         if nm not in self._tvp_names]
            if cp.size == n_p:
                base[:] = cp
            elif cp.size == len(const_idx):
                base[const_idx] = cp
            else:
                raise ValueError(f"cp has {cp.size} entries")
        p_rows[:] = base
        if self._tvp_names:
            vals = tvp
            if vals is None:
                if self._tvp_values is None:
                    raise ValueError("time-varying parameters declared but no values")
                T = self._tvp_values.shape[0]
                vals = self._tvp_values[(step0 + np.arange(N + 1)) % T]
            else:
                vals = np.atleast_2d(np.asarray(vals, dtype=float))
                if vals.shape[0] == 1:
                    vals = np.tile(vals, (N + 1, 1))
                elif vals.shape[0] < N + 1:
                    vals = np.vstack([vals, np.tile(vals[-1], (N + 1 - vals.shape[0], 1))])
            tvp_idx = [self._model.parameters.index(nm) for nm in self._tvp_names]
            p_rows[:, tvp_idx] = vals[:N + 1]
        return p_rows

    def _ref_dict_column(self, name, value, N, step0, what):
        """One reference column for a named variable from a ref_sc/ref_tc dict
        entry: a scalar holds the setpoint over the horizon; a sequence longer
        than 1 is a time series indexed by the closed-loop step count."""
        v = np.asarray(value, dtype=float).ravel()
        if v.size == 1:
            return np.full(N + 1, float(v[0]))
        if step0 + N + 1 > v.size:
            raise ValueError(
                f"time-varying reference for '{name}' ({what}) has {v.size} "
                f"points but step {step0} needs {step0 + N + 1} "
                f"(horizon {N}); supply more data points")
        return v[step0:step0 + N + 1]

    def _assemble_refs(self, terms, ref_arg, N, step0, terminal=False,
                       ref_dict=None):
        what = "ref_tc" if terminal else "ref_sc"
        if ref_dict is not None:
            known = {n for term in terms if term.runtime_ref for n in term.names}
            unknown = set(ref_dict) - known
            if unknown:
                raise ValueError(
                    f"unknown variable(s) {sorted(unknown)} in {what}: no "
                    f"trajectory-tracking cost term references them "
                    f"(tracked: {sorted(known)})")
        cols = []
        col0 = 0  # running offset into a plain-array ref_arg
        for term in terms:
            if not term.runtime_ref:
                continue
            if ref_dict is not None and any(n in ref_dict for n in term.names):
                block = np.zeros((N + 1, term.n))
                for j, n in enumerate(term.names):
                    if n in ref_dict:
                        block[:, j] = self._ref_dict_column(
                            n, ref_dict[n], N, step0, what)
                    elif term.ref is not None and term.ref.ndim == 1:
                        block[:, j] = term.ref[j]
                cols.append(block)
            elif term.ref is not None and term.ref.ndim == 2:
                T = term.ref.shape[0]
                rows = np.minimum(step0 + np.arange(N + 1), T - 1)
                cols.append(term.ref[rows])
            elif ref_arg is not None:
                r = np.asarray(ref_arg, dtype=float)
                if r.ndim == 1:
                    r = np.tile(r[None, :], (N + 1, 1))
                cols.append(r[:, col0:col0 + term.n])
            elif term.ref is not None:
                cols.append(np.tile(term.ref[None, :], (N + 1, 1)))
            elif term.trajectory_tracking:
                raise ValueError(
                    f"variable(s) {term.names} follow a runtime reference but "
                    f"none was supplied — pass {what}={{name: value}} (or "
                    f"ref=array) to optimize()")
            else:
                cols.append(np.zeros((N + 1, term.n)))
            col0 += term.n
        if cols:
            return np.concatenate(cols, axis=1)
        return np.zeros((N + 1, 0))

    def _assemble_theta(self, cp, tvp, ref=None, N=None, ref_sc=None, ref_tc=None):
        N = N or self._horizon
        step0 = self._step_count
        t_col = self._time + self._dt * np.arange(N + 1)
        dt_col = np.full(N + 1, self._dt)
        p_rows = self._assemble_p_rows(cp, tvp, N, step0)
        refs_s = self._assemble_refs(
            [t for t in self.quad_stage_cost.terms if t.runtime_ref], ref, N,
            step0, ref_dict=ref_sc)
        refs_t = self._assemble_refs(
            [t for t in self.quad_terminal_cost.terms if t.runtime_ref], ref, N,
            step0, terminal=True, ref_dict=ref_tc)
        return np.concatenate(
            [t_col[:, None], dt_col[:, None], p_rows, refs_s, refs_t], axis=1)

    # -- initial guesses -------------------------------------------------------
    def _solver_x0(self, x0):
        parts = [np.asarray(x0, dtype=float).ravel() / self._x_scaling]
        if self._augment_du:
            parts.append(self._u_old / self._u_scaling)
        if self._path_following:
            parts.append(np.array([self._theta_path0]))
        if self._min_time is not None:
            parts.append(np.array([self._dt]))
        return np.concatenate(parts)

    def _widen(self, U):
        """A guess of JAX's cold width to the solver's: JAX's cold U has no
        column for minimum time's dt-adjust control, so its rollout reads
        that control from the last column present (an out-of-range index
        clamps) and its solver broadcasts a one-column U over all columns
        (hilo_mpc_tpu/ops/ip_solver.py:408). The column appended here holds
        that last column, which gives JAX's values wherever JAX runs."""
        if U.shape[-1] < self._dims.nu:
            U = np.concatenate([U, U[..., -1:]], axis=-1)
        return U

    def _narrow_cold_U(self):
        """JAX's cold guess (hilo_mpc_tpu/control/nmpc.py:1085-1090): zeros
        under the Δu augmentation, else u_guess and a zero path velocity."""
        N = self._horizon
        if self._augment_du:
            return np.zeros((N, self._dims.nu))
        return np.tile(np.concatenate([self._u_guess / self._u_scaling,
                                       np.zeros(1 if self._path_following else 0)]),
                       (N, 1))

    def _cold_U(self):
        return self._widen(self._narrow_cold_U())

    def _rollout_guess(self, xs0_B, theta, U):
        """Hold U (N, nu), or each scenario's own (B, N, nu), and roll the
        dynamics out from every xs0: (B, N+1, nx)."""
        Bn = xs0_B.shape[0]
        X = [xs0_B]
        for k in range(self._dims.N):
            X.append(self._funcs.dyn(X[-1], U[..., k, :].expand(Bn, -1),
                                     theta[k].expand(Bn, -1)))
        X = torch.stack(X, dim=1)
        return torch.nan_to_num(X, nan=0.0, posinf=1e3, neginf=-1e3)

    def _traj_cost(self, X, U, theta):
        f = self._funcs
        return (f.stage_cost(X[:, :-1], U, theta[:, :-1]).sum(dim=-1)
                + f.term_cost(X[:, -1], theta[:, -1]))

    def _select_cold_guess(self, X_roll_B, xs0_B, U_B, theta_B):
        """Per-scenario cold-start guess: the rollout unless 'auto' finds it
        decisively costlier than the constant-x0 guess (factor 2) or
        nonfinite."""
        if self._guess_mode == "rollout":
            return X_roll_B
        Xc_B = xs0_B[:, None, :].expand(X_roll_B.shape).contiguous()
        if self._guess_mode == "constant":
            return Xc_B
        c_roll = self._traj_cost(X_roll_B, U_B, theta_B)
        c_const = self._traj_cost(Xc_B, U_B, theta_B)
        use_const = ~torch.isfinite(c_roll) | (c_roll > 2.0 * c_const + 1e-9)
        return torch.where(use_const[:, None, None], Xc_B, X_roll_B)

    def _initial_trajectory(self, xs0, theta):
        if self._warm is not None and self._warm_start:
            X_prev, U_prev = self._warm
            X = np.vstack([xs0[None, :], X_prev[2:], X_prev[-1:]])
            U = np.vstack([U_prev[1:], U_prev[-1:]])
            return X, U
        U = self._cold_U()
        if self._x_guess is not None:
            Xg = np.tile(self._solver_x0(self._x_guess)[None, :],
                         (self._horizon + 1, 1))
            Xg[0] = xs0
            return Xg, U
        xs0_t, th_t, U_t = self._tensor(xs0)[None], self._tensor(theta), self._tensor(U)
        X = self._rollout_guess(xs0_t, th_t, U_t)
        X = self._select_cold_guess(X, xs0_t, U_t[None], th_t[None])
        return X[0].cpu().numpy(), U

    # -- one closed-loop step --------------------------------------------------
    def optimize(self, x0, cp=None, tvp=None, ref=None, runs: int = 1,
                 seed: int = 0, ref_sc=None, ref_tc=None):
        """One MPC step: solve the horizon problem from measured state x0 and
        return the first control move. ref_sc / ref_tc map variable names to
        stage/terminal reference values (scalar setpoint or a time series)."""
        if not self._setup_done:
            raise RuntimeError("call setup() first")
        for nm, d in (("ref_sc", ref_sc), ("ref_tc", ref_tc)):
            if d is not None and not isinstance(d, dict):
                raise TypeError(f"{nm} must be a dict mapping variable names to "
                                f"reference values, got {type(d).__name__}")
        t_wall = _time.perf_counter()
        x0 = np.asarray(x0, dtype=float).ravel()
        if x0.size != self._model.n_x:
            raise ValueError(f"x0 has {x0.size} entries, expected {self._model.n_x} "
                             f"({self._model.dynamical_states})")
        theta = self._assemble_theta(cp, tvp, ref, ref_sc=ref_sc, ref_tc=ref_tc)
        xs0 = self._solver_x0(x0)
        X_init, U_init = self._initial_trajectory(xs0, theta)
        warm = self._warm is not None and self._warm_start
        mu0 = self._mu_warm if warm else self._mu_cold
        th_t, xs0_t = self._tensor(theta)[None], self._tensor(xs0)[None]
        X_t = self._tensor(X_init)[None]
        sol = self._keep_history(
            self._solve(th_t, xs0_t, X_t, self._tensor(U_init)[None], mu0), first=True)
        X, U = sol.X[0].cpu().numpy(), sol.U[0].cpu().numpy()

        def scalar(v):
            return v[0].item()

        if runs > 1:
            # multi-start: perturbed initial guesses, keep the best converged
            # objective — a "converged" first solve may sit on a stationary
            # hump of a nonconvex cost
            rng = np.random.default_rng(seed)
            best_obj = scalar(sol.objective) if scalar(sol.converged) else np.inf
            # the draws have the shape of JAX's guess (narrower when cold
            # at minimum time), widened as JAX's solver broadcasts them
            shape = U_init.shape if warm else self._narrow_cold_U().shape
            for _ in range(runs - 1):
                U_r = U_init + self._widen(0.5 * rng.standard_normal(shape))
                sol_r = self._solve(th_t, xs0_t, X_t, self._tensor(U_r)[None],
                                    self._mu_cold)
                if self._ip_opts.record_iterates:
                    sol_r = sol_r[0]    # the history kept is the first solve's
                if scalar(sol_r.converged) and scalar(sol_r.objective) < best_obj:
                    sol, best_obj = sol_r, scalar(sol_r.objective)
                    X, U = sol.X[0].cpu().numpy(), sol.U[0].cpu().numpy()

        mi_info = {}
        if self._mi is not None:
            relaxed_obj = scalar(sol.objective)
            sol, X, U, mi_info = self._mi_refine(theta, xs0, U)
            # integrality gap: the discrete-feasible objective against the
            # relaxed lower bound
            mi_info["mi_gap"] = scalar(sol.objective) - relaxed_obj

        nx, nu = self._model.n_x, self._model.n_u
        # under the Δu augmentation u_k rides in x_{k+1}'s u_prev component
        U_applied = X[1:, nx:nx + nu] if self._augment_du else U[:, :nu]
        u0 = U_applied[0] * self._u_scaling
        self._warm = (X, U)
        self._u_old = u0.copy()
        if self._path_following:
            self._theta_path0 = float(X[1, nx + (nu if self._augment_du else 0)])
        if self._min_time is not None:
            self.optimal_dt = float(X[-1, -1])
            self.optimal_final_time = self.optimal_dt * self._horizon
        self.last_prediction = {
            "x": X[:, :nx] * self._x_scaling,
            "u": U_applied * self._u_scaling,
            "t": self._time + self._dt * np.arange(self._horizon + 1),
        }
        self._time += self._dt
        self._step_count += 1
        self.stats = {
            "iterations": int(scalar(sol.iterations)),
            "kkt_error": float(scalar(sol.kkt_error)),
            "objective": float(scalar(sol.objective)),
            "converged": bool(scalar(sol.converged)),
            "status": int(scalar(sol.status)),
            "extime": _time.perf_counter() - t_wall,
            **mi_info,
        }
        if self.solution is not None:
            self.solution.append(
                self._time, x=x0, u=u0,
                stats=np.array([self.stats["iterations"],
                                self.stats["kkt_error"],
                                self.stats["extime"] * 1e3,
                                float(self.stats["converged"])]))
        return u0

    # -- mixed-integer refinement ---------------------------------------------
    def _mi_candidates(self, U_rel: np.ndarray) -> np.ndarray:
        """Rounding candidates for the discrete inputs from a relaxed
        solution, as the JAX package makes them (host-side numpy, the same
        sorts). Returns (C, N, n_d) level assignments. Exact mode (small
        lattice, see mi_max_enum): every assignment. Heuristic mode: nearest
        rounding, floor- and ceil-biased roundings, the top-K most fractional
        entries flipped to their second-nearest level one at a time and in
        pairs, and all K flipped together. C is fixed (duplicates repeat the
        nearest rounding)."""
        mi = self._mi
        if mi["cand_enum"] is not None:
            return mi["cand_enum"]
        N = self._dims.N
        n_d = len(mi["dims"])
        near = np.zeros((N, n_d))
        second = np.zeros((N, n_d))
        floor_c = np.zeros((N, n_d))
        ceil_c = np.zeros((N, n_d))
        frac = np.zeros((N, n_d))
        for j, (d, lv) in enumerate(zip(mi["dims"], mi["levels"])):
            u = np.asarray(U_rel[:, d], dtype=float)
            dist = np.abs(u[:, None] - lv[None, :])          # (N, L)
            order = np.argsort(dist, axis=1)
            rows = np.arange(N)
            near[:, j] = lv[order[:, 0]]
            second[:, j] = lv[order[:, 1]]
            # fractionality: how close the relaxed value sits to the midpoint
            # between its two nearest levels (1 = exactly between, 0 = on-level)
            frac[:, j] = dist[rows, order[:, 0]] / np.maximum(
                dist[rows, order[:, 1]], 1e-12)
            below = u[:, None] >= lv[None, :] - 1e-12
            floor_c[:, j] = np.where(below.any(axis=1),
                                     lv[np.maximum(below.sum(axis=1) - 1, 0)],
                                     lv[0])
            above = u[:, None] <= lv[None, :] + 1e-12
            ceil_c[:, j] = np.where(above.any(axis=1),
                                    lv[np.minimum(lv.size - above.sum(axis=1),
                                                  lv.size - 1)],
                                    lv[-1])
        K_cfg = mi["neighbors"]
        K = min(K_cfg, N * n_d)
        cands = [near, floor_c, ceil_c]
        flat = frac.ravel()
        top = np.argsort(-flat)[:K]
        all_flipped = near.copy()
        for idx in top:
            k, j = np.unravel_index(idx, (N, n_d))
            flip = near.copy()
            flip[k, j] = second[k, j]
            cands.append(flip)
            all_flipped[k, j] = second[k, j]
        # pairwise flips of the most fractional entries cover
        # Hamming-distance-2 optima that single flips miss
        P = min(K_cfg, 8)
        for ia, ib in itertools.combinations(top[:min(K, 8)], 2):
            ka, ja = np.unravel_index(ia, (N, n_d))
            kb, jb = np.unravel_index(ib, (N, n_d))
            flip = near.copy()
            flip[ka, ja] = second[ka, ja]
            flip[kb, jb] = second[kb, jb]
            cands.append(flip)
        cands.append(all_flipped)
        C_total = 4 + K_cfg + P * (P - 1) // 2
        while len(cands) < C_total:    # keep C the same at every step
            cands.append(near)
        return np.stack(cands[:C_total], axis=0)

    def _mi_refine(self, theta, xs0, U_rel):
        """Pin each rounding candidate (lbu == ubu on the discrete dims) and
        solve the whole candidate batch in ONE batched ``solve_ocp`` (per
        candidate input bounds, the shared state bounds; on CUDA tensors
        every Newton step one Riccati kernel launch). Each candidate starts
        from its U and the rollout of it. Returns (the picked candidate's
        solution as a batch of one, X, U with the discrete entries snapped
        to their levels, stats): the best converged objective, else the
        least KKT error, the first index on ties."""
        mi = self._mi
        cand = self._mi_candidates(np.asarray(U_rel))        # (C, N, n_d)
        C = cand.shape[0]
        b = self._bounds_np
        lbu = np.broadcast_to(b.lbu, (C,) + b.lbu.shape).astype(float)
        ubu = np.broadcast_to(b.ubu, (C,) + b.ubu.shape).astype(float)
        U_c = np.broadcast_to(U_rel, (C,) + U_rel.shape).astype(float)
        for j, d in enumerate(mi["dims"]):
            lbu[:, :, d] = cand[:, :, j]
            ubu[:, :, d] = cand[:, :, j]
            U_c[:, :, d] = cand[:, :, j]
        th_t, xs0_t, U_t = self._tensor(theta), self._tensor(xs0), self._tensor(U_c)
        X_c = self._rollout_guess(xs0_t.expand(C, -1), th_t, U_t)
        bounds = OCPBounds(self._bounds.lbx, self._bounds.ubx, self._tensor(lbu),
                           self._tensor(ubu))
        opts = dataclasses.replace(self._ip_opts,
                                   mu_init=min(self._ip_opts.mu_init, 1e-2),
                                   record_iterates=False)
        sols = solve_ocp(self._funcs, self._dims, bounds,
                         th_t.expand((C,) + tuple(th_t.shape)), xs0_t.expand(C, -1),
                         X_c, U_t, options=opts, fix_x0=True)
        conv = sols.converged.cpu().numpy()
        obj = sols.objective.cpu().numpy().astype(float)
        if conv.any():
            i = int(np.argmin(np.where(conv, obj, np.inf)))
        else:
            i = int(np.argmin(sols.kkt_error.cpu().numpy()))
        sol = OCPSolution(*[v[i:i + 1] for v in sols])
        X = sol.X[0].cpu().numpy()
        U = sol.U[0].cpu().numpy()
        for j, d in enumerate(mi["dims"]):
            U[:, d] = cand[i, :, j]    # snap: the pin is a stiff quadratic, not exact
        info = {"mi_candidates": C, "mi_feasible": int(conv.sum()), "mi_pick": i}
        return sol, X, U, info

    # -- real-time iteration (prepare / feedback split) ----------------------
    def rti_gain(self, X, U, theta):
        """First-stage Riccati feedback gains K_0 (B, nus, nxs) at solved
        trajectories X (B, N+1, nxs), U (B, N, nus), theta (B, N+1, n_theta),
        in solver scaling: the dynamics Jacobians and the stage-cost
        Hessians at (X, U) by ``torch.func`` (``jacrev`` / ``hessian`` under
        one ``vmap`` over all B·N stages), the terminal Hessian, and the
        plain backward sweep (ops/riccati.py) with reg = 1e-8, as the JAX
        package's ``_build_rti_gain``. K_0 is the Gauss-Newton approximation
        of ∂u0*/∂x0 (cost curvature only: the λᵀ∇²f term is left out, as in
        RTI schemes). A plain computation in both packages: the Riccati
        kernel does not run here."""
        f, d = self._funcs, self._dims
        Bn, N, nxs, nus = X.shape[0], d.N, d.nx, d.nu
        xs = X[:, :-1].reshape(Bn * N, nxs)
        us = U.reshape(Bn * N, nus)
        th = theta[:, :-1].reshape(Bn * N, -1)
        A, Bm = vmap(jacrev(f.dyn, argnums=(0, 1)))(xs, us, th)
        (Q, _), (S, R) = vmap(hessian(f.stage_cost, argnums=(0, 1)))(xs, us, th)
        P_T = vmap(hessian(f.term_cost))(X[:, -1], theta[:, -1])
        z = X.new_zeros

        def stages(M):
            return M.reshape(Bn, N, *M.shape[1:])

        K, *_ = backward_sweep(stages(A), stages(Bm), stages(Q), stages(S), stages(R),
                               z(Bn, N, nxs), z(Bn, N, nus), z(Bn, N, nxs), P_T,
                               z(Bn, nxs), reg=1e-8)
        return K[:, 0]

    def _rti_gn_options(self) -> IPOptions:
        """Classical RTI's prepare: exactly ``rti_gn_iterations``
        interior-point iterations (each one Riccati factor and solve), no
        early exit, the warm barrier, no history."""
        return dataclasses.replace(
            self._ip_opts, max_iter=int(self.rti_gn_iterations), early_exit=False,
            mu_init=min(self._ip_opts.mu_init, 1e-3), record_iterates=False)

    def _check_rti(self, what="RTI mode"):
        if not self._setup_done:
            raise RuntimeError("call setup() first")
        if self._path_following or self._min_time is not None or self._mi is not None:
            raise NotImplementedError(
                f"{what} supports the standard and Δu-augmented NMPC "
                f"formulations (no path following, minimum time or discrete "
                f"inputs)")

    def rti_prepare(self, x_pred=None, cp=None, tvp=None, ref=None,
                    ref_sc=None, ref_tc=None):
        """Preparation phase of real-time-iteration NMPC: solve the horizon
        problem at the PREDICTED next state (before the measurement exists)
        and keep the first input and the first-stage Riccati feedback gain;
        ``rti_feedback(x0)`` then answers the measured state at once.

        ``x_pred`` defaults to the one-step prediction from the state and
        move of the last feedback (one device call here, so the feedback
        phase needs none), else the last solve's prediction; the first call
        must pass it. With ``rti_gn_iterations = k`` the solve runs exactly
        k interior-point iterations from the shifted previous trajectory."""
        self._check_rti()
        t0 = _time.perf_counter()
        nx = self._model.n_x
        if x_pred is None:
            pend = self._rti_pending
            if pend is not None:
                xs_pred = self._funcs.dyn(self._tensor(pend["xs0"]),
                                          self._tensor(pend["U"][0]),
                                          self._tensor(pend["theta"][0]))
                x_pred = xs_pred.cpu().numpy()[:nx] * self._x_scaling
            elif self.last_prediction is not None:
                x_pred = self.last_prediction["x"][1]
            else:
                raise RuntimeError(
                    "no prediction available yet — pass x_pred= on the first "
                    "rti_prepare() call (e.g. the current measured state)")
        x_pred = np.asarray(x_pred, dtype=float).ravel()
        if x_pred.size != nx:
            raise ValueError(f"x_pred has {x_pred.size} entries, expected {nx}")
        self._rti_pending = None
        theta = self._assemble_theta(cp, tvp, ref, ref_sc=ref_sc, ref_tc=ref_tc)
        xs_pred = self._solver_x0(x_pred)
        X_init, U_init = self._initial_trajectory(xs_pred, theta)
        args = (self._tensor(theta)[None], self._tensor(xs_pred)[None],
                self._tensor(X_init)[None], self._tensor(U_init)[None])
        if self.rti_gn_iterations:
            sol = self._solve(*args, mu0=None, options=self._rti_gn_options())
        else:
            warm = self._warm is not None and self._warm_start
            sol = self._keep_history(
                self._solve(*args, self._mu_warm if warm else self._mu_cold), first=True)
        K0 = self.rti_gain(sol.X, sol.U, args[0])[0].cpu().numpy()
        X, U = sol.X[0].cpu().numpy(), sol.U[0].cpu().numpy()
        self._warm = (X, U)
        nu = self._model.n_u
        # rti_feedback advances _time before the next prepare, so _time is
        # the sampling instant of x_pred on either path
        self.last_prediction = {
            "x": X[:, :nx] * self._x_scaling,
            "u": (X[1:, nx:nx + nu] if self._augment_du else U[:, :nu]) * self._u_scaling,
            "t": self._time + self._dt * np.arange(self._horizon + 1),
        }
        self._rti = {
            "xs_pred": xs_pred, "theta": theta, "X": X, "U": U, "K0": K0,
            "stats": {"iterations": int(sol.iterations[0]),
                      "kkt_error": float(sol.kkt_error[0]),
                      "objective": float(sol.objective[0]),
                      "converged": bool(sol.converged[0]),
                      "status": int(sol.status[0]),
                      "mode": "rti-gn" if self.rti_gn_iterations else "rti",
                      "t_prepare": _time.perf_counter() - t0},
        }
        return self._rti["stats"]

    def rti_feedback(self, x0):
        """Feedback phase: the control for the measured state,
        u_0 = clip(u_0* + K_0 (x0 − x_pred)), from what ``rti_prepare``
        kept — a numpy matvec and clip, no device call (the next prepare
        propagates the state). Under the Δu augmentation the move is Δu:
        clipped to its bounds, u = u_prev + Δu clipped to the input box and
        the clip folded back into Δu. Updates the solution series like
        ``optimize``."""
        if self._rti is None:
            raise RuntimeError("call rti_prepare() first")
        t0 = _time.perf_counter()
        x0 = np.asarray(x0, dtype=float).ravel()
        if x0.size != self._model.n_x:
            raise ValueError(f"x0 has {x0.size} entries, expected {self._model.n_x}")
        d = self._rti
        b = self._bounds_np
        xs0 = self._solver_x0(x0)
        U = d["U"].copy()
        U[0] = np.clip(U[0] + d["K0"] @ (xs0 - d["xs_pred"]), b.lbu[0], b.ubu[0])
        nx, nu = self._model.n_x, self._model.n_u
        if self._augment_du:
            u_s = np.clip(xs0[nx:nx + nu] + U[0, :nu], b.lbx[1, nx:nx + nu],
                          b.ubx[1, nx:nx + nu])
            U[0, :nu] = u_s - xs0[nx:nx + nu]
            u0 = u_s * self._u_scaling
        else:
            u0 = U[0, :nu] * self._u_scaling
        self._u_old = u0.copy()
        self._rti_pending = {"xs0": xs0, "U": U, "theta": d["theta"]}
        self._time += self._dt
        self._step_count += 1
        self.stats = {**d["stats"], "phase": "rti",
                      "t_feedback": _time.perf_counter() - t0,
                      "extime": d["stats"]["t_prepare"]}
        if self.solution is not None:
            self.solution.append(
                self._time, x=x0, u=u0,
                stats=np.array([self.stats["iterations"], self.stats["kkt_error"],
                                self.stats["t_feedback"] * 1e3,
                                float(self.stats["converged"])]))
        self._rti = None
        return u0

    # -- batched solve ---------------------------------------------------------
    def solve_batch_fn(self, warm: bool = False):
        """Return a function (theta_B, xs0_B, X_init_B, U_init_B) -> OCPSolution
        batched over scenarios (tensors on this controller's device); on the
        general path with ``ipopt_debugger`` the pair (OCPSolution, history)
        of ``ops/ip_solver.py:solve_ocp``.

        warm=True uses the warm-start barrier min(mu_init, 1e-3): pass it when
        the initial trajectories come from a previous solution (the closed-loop
        regime)."""
        if not self._setup_done:
            raise RuntimeError("call setup() first")
        mu_val = self._mu_warm if warm else self._mu_cold
        opts = self._ip_opts
        if opts.pallas_full:
            cache = self._whole_ip_cache()
            if cache["eligible"]:
                return self._whole_ip_fn(cache, mu_val)
            warnings.warn("pallas_full requested but the problem is not "
                          "kernel-eligible (the whole-solve kernel takes box "
                          "constraints, soft state bounds and soft generic "
                          "constraints, pure Newton steps, fix_x0, explicit and "
                          "implicit integrators (collocation, irk, the "
                          "cvodes/idas stand-ins) with a Newton of at most "
                          "NEWTON_MAX unknowns, an ODE or DAE model in the "
                          "equation DSL, by state-space matrices or as a "
                          "callable, and any cost that traces to its op table: "
                          "quadratic, generic, measurement and path-following "
                          f"terms; declined here: {cache['why']}); using the "
                          "general path")
        return lambda th, x0s, Xi, Ui: self._solve(th, x0s, Xi, Ui, mu_val)

    def _weights_key(self):
        """The numbers of the cost terms that the emitted problem bakes into
        prm, as bytes (those of the last setup(), which the problem
        functions keep); and the soft state bounds and their weight."""
        src = self._funcs.source
        return tuple((t.kind, np.asarray(t.idx).tobytes(), np.asarray(t.W).tobytes(),
                      None if t.ref is None else np.asarray(t.ref).tobytes(),
                      t.runtime_ref)
                     for t in (*src.stage_terms, *src.term_terms)) + (
            (src.soft_lb, src.soft_ub, src.soft_weight),)

    def _whole_ip_cache(self) -> dict:
        """The whole-solve path prepared for the current problem: the gate's
        result (``eligible``, and ``why`` not), the problem it emitted for
        this controller's theta width, and a ``WholeIPLaunch`` per (device,
        n_theta) (each with its emitted problem, bound entry point, prm on
        the card and row indices). The gate decides from the options, the
        dims and the emission (ops/whole_ip.py:whole_ip_gate), before any
        compile. A problem that neither the DSL emitter nor the trace can
        write is declined here; a problem that is eligible and then fails
        to build or launch raises. Bounds, weights and options reach the
        solver only through setup(), which makes new ``_funcs``,
        ``_bounds`` and ``_ip_opts`` (or adopts a registry entry's, whose
        cache under its ``"whole_ip"`` site same-configuration controllers
        share, one per bound values); the cache is keyed on those objects
        and on the cost terms' numbers, so a new setup() drops it, and the
        traced route traces the problem again:
        the constants of the problem functions' closures are read at that
        point, as JAX's ``jit`` reads them at trace time. Cold and warm
        solves share it: they differ only in mu0, a launch argument."""
        c = self._wip
        weights = self._weights_key()
        if (c is None or c["funcs"] is not self._funcs or c["bounds"] is not self._bounds
                or c["opts"] != self._ip_opts or c["weights"] != weights):
            # same-configuration controllers share one per bound values
            shared = self._shared_site("whole_ip", dict)
            key = (tuple(arr_key(b) for b in self._bounds_np), weights)
            c = shared.get(key)
            if c is None or c["funcs"] is not self._funcs or c["opts"] != self._ip_opts:
                problem, why = whole_ip_gate(self._funcs, self._dims, self._bounds,
                                             self._ip_opts, True)
                c = shared[key] = dict(funcs=self._funcs, opts=self._ip_opts,
                                       weights=weights, eligible=problem is not None,
                                       why=why, problem=problem, launch={})
            self._wip = dict(c, bounds=self._bounds)
        return self._wip

    def _whole_ip_fn(self, cache, mu0):
        """The whole-solve kernel in float32 (the JAX kernel's precision):
        CUDA inputs are cast to float32 and the solution back to this
        controller's dtype, through the launch prepared once per device.
        CPU inputs go to the kernel's plain version in this controller's
        dtype, which runs the controller's own functions.
        ``pallas_tile``, ``pallas_full_pack`` and ``pallas_vmem_mb`` are TPU
        knobs without effect."""
        funcs, dims, dtype = self._funcs, self._dims, self._dtype
        opts = dataclasses.replace(self._ip_opts, mu_init=mu0)

        def solve(th, x0s, Xi, Ui):
            if not th.is_cuda:
                return solve_ocp_full_cuda(funcs, dims, self._bounds, th, x0s, Xi, Ui,
                                           options=opts)
            key = (th.device, th.shape[2])
            launch = cache["launch"].get(key)
            if launch is None:
                problem = (cache["problem"]
                           if th.shape[2] == self._funcs.source.n_theta else
                           whole_ip_problem(funcs, dims, self._bounds, th.shape[2],
                                            self._ip_opts))
                launch = cache["launch"][key] = WholeIPLaunch(
                    problem, dims, torch.float32, th.device)
            f32 = torch.float32
            sol = launch(*[a.to(f32).contiguous() for a in (th, x0s, Xi, Ui)], mu0)
            if dtype == f32:
                return sol
            return type(sol)(*[v.to(dtype) if v.is_floating_point() else v
                               for v in sol])
        return solve

    def prepare_batch(self, x0_batch, cp=None, tvp=None, ref=None, u_prev=None):
        """Solver inputs for B scenarios, cold-started by one batched rollout:
        (theta_B, xs0_B, X_init_B, U_init_B) tensors on this controller's
        device. ``u_prev`` (B, n_u): each scenario's previous input for the
        Δu-augmented formulation (default: this controller's ``_u_old`` for
        every scenario). ``tvp``: the time-varying parameters' rows over the
        horizon (see ``_assemble_p_rows``), shared by the batch."""
        theta, xs0 = self._batch_theta_xs0(x0_batch, cp, tvp, ref, u_prev)
        Bn = xs0.shape[0]
        N, nus = self._dims.N, self._dims.nu
        U = self._tensor(self._cold_U())
        X_B = self._rollout_guess(xs0, theta, U)
        U_B = U.expand(Bn, N, nus).contiguous()
        theta_B = theta.expand((Bn,) + tuple(theta.shape)).contiguous()
        X_B = self._select_cold_guess(X_B, xs0, U_B, theta_B)
        return theta_B, xs0, X_B, U_B

    def _batch_theta_xs0(self, x0_batch, cp, tvp, ref, u_prev):
        """theta (N+1, n_theta) and the solver's x0 (B, nxs) of B scenarios."""
        if not self._setup_done:
            raise RuntimeError("call setup() first")
        if u_prev is not None and not self._augment_du:
            raise ValueError("u_prev is only meaningful for the Δu-augmented "
                             "formulation (Δu costs/bounds or Nc < N)")
        x0_batch = np.atleast_2d(np.asarray(x0_batch, dtype=float))
        Bn = x0_batch.shape[0]
        theta = self._tensor(self._assemble_theta(cp, tvp, ref))
        # the appended components of _solver_x0 are the same for every scenario
        xs0_np = np.concatenate([x0_batch / self._x_scaling,
                                 np.tile(self._solver_x0(x0_batch[0])[self._model.n_x:],
                                         (Bn, 1))], axis=1)
        if u_prev is not None:
            u_prev = np.atleast_2d(np.asarray(u_prev, dtype=float))
            nx, nu = self._model.n_x, self._model.n_u
            if u_prev.shape != (Bn, nu):
                raise ValueError(f"u_prev has shape {u_prev.shape}, expected {(Bn, nu)}")
            xs0_np[:, nx:nx + nu] = u_prev / self._u_scaling
        return theta, self._tensor(xs0_np)

    def optimize_batch(self, x0_batch, cp=None, tvp=None, ref=None,
                       u_prev=None):
        """Solve B independent MPC problems at once; returns ((B, n_u) first
        moves as numpy, OCPSolution). ``u_prev`` (B, n_u): per-scenario
        previous inputs for the Δu-augmented formulation."""
        sol = self._keep_history(self.solve_batch_fn()(
            *self.prepare_batch(x0_batch, cp, tvp, ref, u_prev=u_prev)))
        nx, nu = self._model.n_x, self._model.n_u
        u0 = (sol.X[:, 1, nx:nx + nu] if self._augment_du
              else sol.U[:, 0, :nu]).cpu().numpy() * self._u_scaling
        return u0, sol

    def rti_prepare_batch(self, x_pred_batch, cp=None, tvp=None, ref=None,
                          warm: bool = False, u_prev=None):
        """Batched RTI preparation: B horizon problems solved at the
        predicted states and every first-stage gain, kept for
        ``rti_feedback_batch``. ``warm=True`` starts each scenario from its
        own previous solution shifted by one stage (on the device) with the
        warm barrier. Under the Δu augmentation each scenario's previous
        input rides in its solver state: ``u_prev`` (B, n_u), by default the
        inputs the last ``rti_feedback_batch`` applied (zeros before it).
        With ``rti_gn_iterations = k`` every scenario runs exactly k
        interior-point iterations, as ``rti_prepare`` does (the JAX
        package's batched prepare ignores the option and always solves).
        Returns numpy arrays: {"xs_pred", "U", "K0", "converged"}."""
        self._check_rti("batched RTI")
        Bn = np.atleast_2d(np.asarray(x_pred_batch)).shape[0]
        if self._augment_du and u_prev is None:
            u_old = self._rti_batch_u_old
            u_prev = (u_old if u_old is not None and u_old.shape[0] == Bn
                      else np.zeros((Bn, self._model.n_u)))
        prev = self._rti_batch_warm
        if warm and prev is not None and prev[0].shape[0] == Bn:
            theta, xs0 = self._batch_theta_xs0(x_pred_batch, cp, tvp, ref, u_prev)
            X_prev, U_prev = prev
            args = (theta.expand((Bn,) + tuple(theta.shape)).contiguous(), xs0,
                    torch.cat([xs0[:, None], X_prev[:, 2:], X_prev[:, -1:]], dim=1),
                    torch.cat([U_prev[:, 1:], U_prev[:, -1:]], dim=1))
            solve = self.solve_batch_fn(warm=True)
        else:
            args = self.prepare_batch(x_pred_batch, cp, tvp, ref, u_prev=u_prev)
            solve = self.solve_batch_fn()
        if self.rti_gn_iterations:
            sol = self._solve(*args, mu0=None, options=self._rti_gn_options())
        else:
            sol = self._keep_history(solve(*args))
        K0 = self.rti_gain(sol.X, sol.U, args[0])
        self._rti_batch_warm = (sol.X, sol.U)
        self._rti_batch = {"xs_pred": args[1].cpu().numpy(), "U": sol.U.cpu().numpy(),
                           "K0": K0.cpu().numpy(),
                           "converged": sol.converged.cpu().numpy()}
        return self._rti_batch

    def rti_feedback_batch(self, x0_batch):
        """Batched feedback phase: (B, n_u) first moves for B measured
        states from the gains ``rti_prepare_batch`` kept — one einsum and
        clip in numpy, no device call."""
        if self._rti_batch is None:
            raise RuntimeError("call rti_prepare_batch() first")
        d = self._rti_batch
        x0_batch = np.atleast_2d(np.asarray(x0_batch, dtype=float))
        Bn = x0_batch.shape[0]
        if Bn != d["xs_pred"].shape[0]:
            raise ValueError(f"x0_batch has {Bn} scenarios, prepared "
                             f"{d['xs_pred'].shape[0]}")
        b = self._bounds_np
        nx, nu = self._model.n_x, self._model.n_u
        if self._augment_du:
            # the deviation uses the u_prev the prepare solved with (zero on
            # the augmented rows); Δu is clipped to its bounds, then
            # u = u_prev + Δu to the input box (state bounds on those rows)
            u_old_s = d["xs_pred"][:, nx:nx + nu]
            xs0 = np.concatenate([x0_batch / self._x_scaling, u_old_s], axis=1)
            dU0 = np.clip(d["U"][:, 0, :] + np.einsum("bij,bj->bi", d["K0"],
                                                      xs0 - d["xs_pred"]),
                          b.lbu[0], b.ubu[0])
            u_s = np.clip(u_old_s + dU0[:, :nu], b.lbx[1, nx:nx + nu],
                          b.ubx[1, nx:nx + nu])
            u0 = u_s * self._u_scaling
            # carried to the next rti_prepare_batch as the fleet's u_prev
            self._rti_batch_u_old = u0.copy()
            self._rti_batch = None
            return u0
        xs0 = x0_batch / self._x_scaling
        U0 = np.clip(d["U"][:, 0, :] + np.einsum("bij,bj->bi", d["K0"],
                                                 xs0 - d["xs_pred"]),
                     b.lbu[0], b.ubu[0])
        self._rti_batch = None
        return U0[:, :nu] * self._u_scaling

    def print_stats(self):
        """Per-step solver statistics summary (p50/p99 solve time, iterations,
        convergence rate) over the recorded closed-loop run."""
        st = self.solution.get("stats") if self.solution is not None else None
        if st is None or st.shape[1] == 0:
            print("no recorded solves")
            return
        it, kkt, ms, conv = st
        print(f"solves: {it.size} | converged {100 * np.nanmean(conv):.1f}% | "
              f"iterations p50={np.nanmedian(it):.0f} max={np.nanmax(it):.0f} | "
              f"solve time p50={np.nanpercentile(ms, 50):.1f} ms "
              f"p99={np.nanpercentile(ms, 99):.1f} ms | "
              f"kkt p50={np.nanmedian(kkt):.2e}")

    def return_prediction(self):
        """The last solve's predicted {"x", "u", "t"} (unscaled)."""
        return self.last_prediction

    def plot_prediction(self, save_plot=False, plot_dir=None,
                        name_file="mpc_prediction.png", show_plot=False,
                        extras=None, extras_names=None, title=None):
        """Plot the MPC's predicted state/input trajectories from the last
        solve (reference: plot_prediction, mpc.py:868-1024) on the active
        plot backend (matplotlib, or bokeh through
        utils/plotting_bokeh.py), with the extras-overlay contract:
        ``extras`` maps state/input names to arrays plotted over the
        prediction."""
        if self.last_prediction is None:
            raise RuntimeError("call optimize() before plot_prediction()")
        from ..utils.plotting import get_plot_backend
        if get_plot_backend() == "bokeh":
            from ..utils.plotting_bokeh import plot_prediction_bokeh
            import os
            save_as = (os.path.join(plot_dir or "",
                                    str(name_file).replace(".png", ".html"))
                       if save_plot else None)
            return plot_prediction_bokeh(
                self.last_prediction, self._model.dynamical_states,
                self._model.inputs, extras=extras,
                extras_names=extras_names, save_as=save_as, title=title,
                time_unit=self._model.time_unit)
        import matplotlib
        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        pred = self.last_prediction
        x_names = list(self._model.dynamical_states)
        u_names = list(self._model.inputs)
        t = np.asarray(pred["t"])
        n_panels = len(x_names) + len(u_names)
        fig, axes = plt.subplots(n_panels, 1, figsize=(8, 2.2 * n_panels),
                                 sharex=True, squeeze=False)
        axes = axes.ravel()
        extras = extras or {}
        extras_names = list(extras_names or [])
        # tolerate a short extras_names list: fall back to the extras key
        keys = list(extras)
        extras_names += keys[len(extras_names):]

        def _extra_label(nm):
            return extras_names[keys.index(nm)]
        for i, nm in enumerate(x_names):
            axes[i].plot(t, np.asarray(pred["x"])[:, i], "-o", ms=3,
                         label="prediction")
            if nm in extras:
                e = np.asarray(extras[nm]).ravel()
                axes[i].plot(t[:e.size], e, "--",
                             label=_extra_label(nm))
            axes[i].set_ylabel(nm)
            axes[i].legend(loc="best", fontsize=8)
        for j, nm in enumerate(u_names):
            ax = axes[len(x_names) + j]
            u = np.asarray(pred["u"])[:, j]
            ax.step(t[:u.size], u, where="post", label="prediction")
            if nm in extras:
                e = np.asarray(extras[nm]).ravel()
                ax.step(t[:e.size], e, "--", where="post",
                        label=_extra_label(nm))
            ax.set_ylabel(nm)
            ax.legend(loc="best", fontsize=8)
        axes[-1].set_xlabel(f"time [{self._model.time_unit}]")
        if title:
            fig.suptitle(title)
        fig.tight_layout()
        if save_plot:
            import os
            path = (os.path.join(plot_dir, name_file) if plot_dir
                    else name_file)
            fig.savefig(path, dpi=120)
        if show_plot:  # pragma: no cover - interactive
            plt.show()
        return fig

    def plot_iterations(self, save_as=None, show=False):
        """Visualize the recorded IP iterate history (reference: plot_iterations,
        optimizer.py:1562 + IpoptDebugger): ``iteration_history`` of the
        last ``optimize``, which ``setup(options={'ipopt_debugger': True})``
        records."""
        hist = getattr(self, "iteration_history", None)
        if hist is None:
            raise RuntimeError("enable options={'ipopt_debugger': True} and call "
                               "optimize() first")
        import matplotlib
        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        n = int(hist["n"])
        fig, axes = plt.subplots(3, 1, figsize=(8, 9))
        its = np.arange(n)
        axes[0].semilogy(its, np.maximum(hist["kkt"][:n], 1e-16), "-o", ms=3)
        axes[0].set_ylabel("KKT error")
        axes[1].semilogy(its, np.maximum(hist["mu"][:n], 1e-16), "-o", ms=3)
        axes[1].set_ylabel("barrier mu")
        nu = self._model.n_u
        for it in range(0, n, max(1, n // 8)):
            axes[2].plot(hist["U"][it, :, :nu].ravel(), alpha=0.4)
        axes[2].plot(hist["U"][max(n - 1, 0), :, :nu].ravel(), "k", lw=2,
                     label="final")
        axes[2].set_ylabel("u trajectory per iterate")
        axes[2].legend()
        for ax in axes:
            ax.grid(alpha=0.3)
        fig.tight_layout()
        if save_as:
            fig.savefig(save_as, dpi=120)
        if show:
            plt.show()
        return fig

    def __str__(self):
        feats = []
        if self._setup_done:
            feats.append(f"N={self._horizon}")
            if self.control_horizon != self._horizon:
                feats.append(f"Nc={self.control_horizon}")
            feats.append(f"dt={self._dt}")
            if self._augment_du:
                feats.append("du-augmented")
            if self._path_following:
                feats.append("path-following")
            if self._min_time is not None:
                feats.append("min-time")
            if self._dims.n_e or self._dims.n_eN:
                feats.append(f"equalities={self._dims.n_e + self._dims.n_eN}")
            if self._dims.n_h or self._dims.n_hN:
                feats.append(f"custom-ineqs={self._dims.n_h + self._dims.n_hN}")
        state = ", ".join(feats) if feats else "not set up"
        lines = [f"{self._controller_type} {self.name!r} on model "
                 f"{self._model.name!r} ({state})"]
        if self.stats:
            lines.append(
                f"  last solve: {'converged' if self.stats.get('converged') else 'NOT converged'}"
                f" in {self.stats.get('iterations')} iterations, "
                f"kkt={self.stats.get('kkt_error'):.2e}, "
                f"{self.stats.get('extime', 0) * 1e3:.1f} ms")
        return "\n".join(lines)


class OptimalControlProblem(NMPC):
    """Open-loop optimal control: one solve, then the control sequence
    applied step by step (``reset`` solves again at the next call)."""

    _controller_type = "OCP"

    def __init__(self, model, **kwargs):
        super().__init__(model, **kwargs)
        self._u_sequence = None
        self._seq_pos = 0

    def optimize(self, x0, **kwargs):
        if self._u_sequence is None:
            super().optimize(x0, **kwargs)
            self._u_sequence = np.asarray(self.last_prediction["u"])
            self._seq_pos = 0
        u = self._u_sequence[min(self._seq_pos, len(self._u_sequence) - 1)]
        self._seq_pos += 1
        return u

    def reset(self):
        self._u_sequence = None
        self._seq_pos = 0


OCP = OptimalControlProblem
