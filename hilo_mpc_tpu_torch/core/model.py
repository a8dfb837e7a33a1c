"""Dynamic model: declaration, integration, simulation.

PyTorch port of ``hilo_mpc_tpu/core/model.py``. A model's equations are
plain functions ``f(x, z, u, p, t)`` over BATCH-FIRST tensors (``x`` is
``(..., n_x)``, the result ``(..., n_x)``), built from the equation-string DSL
(utils/parsing.py) or given as callables: the dynamics, semi-explicit DAE
algebraic residuals ``0 = g(x, z, u, p, t)``, measurements and quadratures.
A linear model may instead be declared by its state-space matrices
(``set_state_space``), and a discrete-time model (``Model(discrete=True)``)
gives the next state instead of the derivative. ``setup`` composes the
equations with a fixed-step integrator (ERK, Radau/Legendre collocation, or
the discrete map; core/integrators.py) on an explicit device and dtype
(``"cuda"`` unless the caller asks for the CPU); quadratures of a continuous
model are integrated as augmented states. ``simulate`` rolls the step out
with a Python loop over time, every scenario at once. ``linearize``,
``linearize_trajectory``, ``discretize`` and ``jacobians`` derive linear and
discrete models by ``torch.func`` forward-mode Jacobians.

A trained network whose labels are model parameters composes into the
model: ``model + ann`` (a new hybrid model) and ``substitute_from(ann)``
(in place), ml/hybrid.py. ``generate_data`` excites the model and returns a
``DataSet`` (utils/data.py).
"""
from __future__ import annotations

import copy as _copy
import functools
import inspect
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from .integrators import IntegratorSpec, make_step
from .series import TimeSeries
from .variables import VarSpec

_CANONICAL_ARGS = ("x", "z", "u", "p", "t")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. A CUDA device that PyTorch cannot
    see is an error: nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r}, but PyTorch sees no CUDA device; pass "
            f"device='cpu' to run on the CPU")
    return dev


def records_setup(setup: Callable) -> Callable:
    """Keep the arguments of the last ``setup`` call on the object
    (``_setup_call``): ``parallel/sharding.py:on_device`` sets up a copy on
    another device with them."""
    @functools.wraps(setup)
    def wrapper(self, *args, **kwargs):
        out = setup(self, *args, **kwargs)
        self._setup_call = (args, kwargs)
        return out
    return wrapper


def _device_matrix(M: np.ndarray):
    """``M`` as a tensor of the dtype and device of the argument, one copy per
    (dtype, device): a state-space closure does not copy its matrix to the
    device on every call. A tensor made inside a ``torch.func`` transform
    belongs to that transform's level and must not outlive it, so only one
    made outside every transform is kept. Under ``make_fx`` the copy is
    traced from ``M`` itself, whether or not a call before the trace made
    one, so a trace (the whole-solve kernel's emitted text) does not depend
    on what ran before it."""
    from torch._C._functorch import peek_interpreter_stack
    from torch.fx.experimental.proxy_tensor import get_proxy_mode

    cache = {}

    def get(like):
        key = (like.dtype, like.device)
        tracing = get_proxy_mode() is not None
        if key in cache and not tracing:
            return cache[key]
        t = torch.as_tensor(M, dtype=like.dtype, device=like.device)
        if peek_interpreter_stack() is None and not tracing:
            cache[key] = t
        return t

    return get


def wrap_rhs(fn: Callable, what: str = "rhs") -> Callable:
    """Adapt a user function with any subset of (x, z, u, p, t) parameters (by name or
    positionally in canonical order) to the canonical signature f(x, z, u, p, t).
    The function works on batch-first tensors and returns ``(..., n)`` — a
    tensor, or a sequence of per-row ``(...)`` tensors/numbers."""
    try:
        sig = inspect.signature(fn)
        params = [p.name for p in sig.parameters.values()
                  if p.kind in (p.POSITIONAL_OR_KEYWORD, p.POSITIONAL_ONLY)]
    except (TypeError, ValueError):
        params = list(_CANONICAL_ARGS)
    if all(p in _CANONICAL_ARGS for p in params):
        picks = params
    else:
        picks = list(_CANONICAL_ARGS[: len(params)])

    def canonical(x, z, u, p, t):
        env = {"x": x, "z": z, "u": u, "p": p, "t": t}
        out = fn(*[env[name] for name in picks])
        if torch.is_tensor(out):
            return out
        from ..utils.parsing import _stack_like
        return _stack_like(list(out), x)

    canonical.__name__ = f"canonical_{what}"
    return canonical


def one_row_last(v, x, n: int):
    """A user function's value in (..., n) form: a function of one row may
    return the batch shape (...) of ``x`` (..., n_x) itself; a value without
    the batch dims is broadcast to them."""
    if n == 1 and v.dim() == x.dim() - 1:
        v = v[..., None]
    return torch.broadcast_to(v, x.shape[:-1] + (n,))


class Model:
    """Dynamic ODE/DAE/discrete model with measurements and quadratures."""

    def __init__(self, name: Optional[str] = None, discrete: bool = False,
                 time_unit: str = "h"):
        self.name = name or "model"
        self._discrete = bool(discrete)
        self._time_unit = time_unit

        self._x = VarSpec()   # differential states
        self._z = VarSpec()   # algebraic states
        self._u = VarSpec()   # inputs
        self._p = VarSpec()   # parameters
        self._y = VarSpec()   # measurements
        self._q = VarSpec()   # quadrature states

        self._ode: Optional[Callable] = None
        self._alg: Optional[Callable] = None
        self._meas: Optional[Callable] = None
        self._quad: Optional[Callable] = None
        self._equations_src: Optional[str] = None
        # where the state equations came from: "dsl" (self._dsl keeps the
        # parse), "state_space" (self._ss) or "callable"; code generation for
        # the card (ops/codegen_cuda.py) reads the first two
        self._ode_origin: Optional[str] = None
        self._dsl = None

        # linear state-space matrices if declared that way
        self._ss: Dict[str, Optional[np.ndarray]] = {k: None for k in "ABCDM"}

        self._dt: Optional[float] = None
        self._int_spec: Optional[IntegratorSpec] = None
        self._step = None          # step(x, z, u, p, t, dt) -> (x+, z+, y+, q+)
        self._setup_done = False
        self._device = torch.device("cpu")
        self._dtype = torch.float32

        self._x0: Optional[np.ndarray] = None
        self._z0: Optional[np.ndarray] = None
        self._p0: Optional[np.ndarray] = None
        self._time = 0.0
        self.solution: Optional[TimeSeries] = None

        # deferred linearization: linearize() without a point, then
        # set_equilibrium_point() on the linearized model
        self._linearized_parent: Optional["Model"] = None
        self._needs_equilibrium = False
        self._equilibrium: Optional[dict] = None

    # -- dimensions ---------------------------------------------------------
    @property
    def n_x(self) -> int: return self._x.n
    @property
    def n_z(self) -> int: return self._z.n
    @property
    def n_u(self) -> int: return self._u.n
    @property
    def n_p(self) -> int: return self._p.n
    @property
    def n_q(self) -> int: return self._q.n

    @property
    def n_y(self) -> int:
        return self._y.n if self._y.n else self._x.n

    @property
    def dynamical_states(self): return list(self._x.names)
    @property
    def algebraic_states(self): return list(self._z.names)
    @property
    def inputs(self): return list(self._u.names)
    @property
    def parameters(self): return list(self._p.names)
    @property
    def measurements(self):
        return list(self._y.names) if self._y.n else list(self._x.names)

    @property
    def discrete(self) -> bool: return self._discrete
    @property
    def continuous(self) -> bool: return not self._discrete
    @property
    def dt(self) -> Optional[float]: return self._dt
    @property
    def time_unit(self) -> str: return self._time_unit
    @property
    def device(self) -> torch.device: return self._device
    @property
    def dtype(self) -> torch.dtype: return self._dtype

    # -- declaration --------------------------------------------------------
    @staticmethod
    def _vector_decl(names, dim):
        """Normalize vector-declaration forms: ('x', 3) / (3, 'x') -> x_0..x_2."""
        if dim is None:
            return names
        if isinstance(names, str) and isinstance(dim, (int, np.integer)):
            name, n = names, int(dim)
        elif isinstance(dim, str) and isinstance(names, (int, np.integer)):
            name, n = dim, int(names)
        else:
            raise TypeError("vector declaration takes (name, dim) or (dim, name)")
        if n < 0:
            raise ValueError(f"vector dimension must be >= 0, got {n}")
        if n == 1:
            return [name]
        return [f"{name}_{i}" for i in range(n)]

    def set_dynamical_states(self, names, dim=None, **meta):
        self._x = VarSpec()
        self._x.add(self._vector_decl(names, dim), prefix="x")
        return self

    def set_algebraic_states(self, names, dim=None, **meta):
        self._z = VarSpec()
        self._z.add(self._vector_decl(names, dim), prefix="z")
        return self

    def set_inputs(self, names, dim=None, **meta):
        self._u = VarSpec()
        self._u.add(self._vector_decl(names, dim), prefix="u")
        return self

    def set_parameters(self, names, dim=None, **meta):
        self._p = VarSpec()
        self._p.add(self._vector_decl(names, dim), prefix="p")
        return self

    def set_measurements(self, names, dim=None, **meta):
        self._y = VarSpec()
        self._y.add(self._vector_decl(names, dim), prefix="y")
        return self

    def set_dynamical_equations(self, fn: Union[Callable, str, Sequence[str]]):
        if isinstance(fn, (str, list, tuple)):
            return self.set_equations(ode=fn)
        self._set_callable_ode(fn)
        return self

    def set_algebraic_equations(self, fn: Callable):
        """The residuals ``0 = g(x, z, u, p, t)`` of the algebraic states."""
        self._alg = wrap_rhs(fn, "alg")
        return self

    def set_measurement_equations(self, fn: Union[Callable, str, Sequence[str]]):
        if isinstance(fn, (str, list, tuple)):
            return self.set_equations(meas=fn)
        self._meas = wrap_rhs(fn, "meas")
        return self

    def set_quadrature_functions(self, fn: Callable):
        """Integrands accumulated over each step (continuous model) or
        evaluated at the next state (discrete model); one quadrature unless
        declared otherwise."""
        self._quad = wrap_rhs(fn, "quad")
        if self._q.n == 0:
            self._q.add(1, prefix="q")
        return self

    def set_equations(self, equations=None, ode=None, alg=None, meas=None, quad=None):
        """Set equations from callables, a dict of callables, or the equation-string DSL."""
        from ..utils.parsing import apply_parsed_equations

        if isinstance(equations, dict):
            ode = equations.get("ode", ode)
            alg = equations.get("alg", alg)
            meas = equations.get("meas", meas)
            quad = equations.get("quad", quad)
            equations = None
        if equations is not None:
            if callable(equations):
                self._set_callable_ode(equations)
                return self
            if isinstance(equations, (list, tuple)):
                equations = "\n".join(equations)
            apply_parsed_equations(self, equations)
            self._equations_src = equations
            return self
        for fn, what in ((ode, "ode"), (meas, "meas")):
            if fn is None:
                continue
            if isinstance(fn, (str, list, tuple)):
                apply_parsed_equations(self, fn if isinstance(fn, str) else "\n".join(fn))
            elif what == "ode":
                self._set_callable_ode(fn)
            else:
                self._meas = wrap_rhs(fn, what)
        if alg is not None:
            self.set_algebraic_equations(alg)
        if quad is not None:
            self.set_quadrature_functions(quad)
        return self

    def _set_callable_ode(self, fn: Callable):
        self._ode = wrap_rhs(fn, "ode")
        self._ode_origin, self._dsl = "callable", None

    # -- linear state-space declaration --------------------------------------
    def set_state_space(self, A=None, B=None, C=None, D=None, M=None):
        """Declare a (possibly time-discrete) linear model x' = Ax + Bu,
        y = Cx + Du. Undeclared states, inputs and measurements are named from
        the matrix shapes (x_0, u_0, y_0, ...)."""
        for key, val in zip("ABCDM", (A, B, C, D, M)):
            if val is not None:
                self._ss[key] = np.atleast_2d(np.asarray(val, dtype=float))
        A_ = self._ss["A"]
        if A_ is not None and A_.shape[0] != A_.shape[1]:
            raise ValueError(f"A must be square, got {A_.shape}")
        if A_ is not None and self._x.n == 0:
            self._x.add(A_.shape[0], prefix="x")
        B_ = self._ss["B"]
        if B_ is not None and A_ is not None and B_.shape[0] != A_.shape[0]:
            raise ValueError(f"B has {B_.shape[0]} rows for {A_.shape[0]} states")
        if B_ is not None and self._u.n == 0:
            self._u.add(B_.shape[1], prefix="u")
        C_ = self._ss["C"]
        if C_ is not None and self._x.n and C_.shape[1] != self._x.n:
            raise ValueError(f"C has {C_.shape[1]} columns for {self._x.n} states")
        if C_ is not None and self._y.n == 0:
            self._y.add(C_.shape[0], prefix="y")
        D_ = self._ss["D"]
        if D_ is not None and self._u.n and D_.shape[1] != self._u.n:
            raise ValueError(f"D has {D_.shape[1]} columns for {self._u.n} inputs")
        if D_ is not None and C_ is not None and D_.shape[0] != C_.shape[0]:
            raise ValueError(f"D has {D_.shape[0]} rows for {C_.shape[0]} "
                             "measurements")
        if D_ is not None and self._y.n == 0:
            self._y.add(D_.shape[0], prefix="y")

        nx, nu, ny = self._x.n, self._u.n, self._y.n
        # transposed snapshots: batch-first rows times Mᵀ
        At, Bt, Ct, Dt = (None if m is None else _device_matrix(m.T.copy())
                          for m in (A_, B_, C_, D_))

        def affine(Mx, Mu, n):
            def fn(x, z, u, p, t):
                out = torch.zeros(x.shape[:-1] + (n,), dtype=x.dtype, device=x.device)
                if Mx is not None:
                    out = out + x @ Mx(x)
                if Mu is not None and nu:
                    out = out + u @ Mu(x)
                return out
            return fn

        def mat_key(m):
            return None if m is None else (m.shape, m.tobytes())

        # content markers: controllers on models with equal matrices share a
        # registry entry (trace_signature)
        self._ode = affine(At, Bt, nx)
        self._ode._hilo_dsl_src = ("ss_ode", mat_key(A_), mat_key(B_))
        self._ode_origin, self._dsl = "state_space", None
        if Ct is not None or Dt is not None:
            self._meas = affine(Ct, Dt, ny)
            self._meas._hilo_dsl_src = ("ss_meas", mat_key(C_), mat_key(D_))
        return self

    @property
    def A(self):
        return None if self._ss["A"] is None else np.array(self._ss["A"])

    @A.setter
    def A(self, val):
        self.set_state_space(A=val)

    @property
    def B(self):
        return None if self._ss["B"] is None else np.array(self._ss["B"])

    @B.setter
    def B(self, val):
        self.set_state_space(B=val)

    @property
    def C(self):
        return None if self._ss["C"] is None else np.array(self._ss["C"])

    @C.setter
    def C(self, val):
        self.set_state_space(C=val)

    @property
    def D(self):
        return None if self._ss["D"] is None else np.array(self._ss["D"])

    @D.setter
    def D(self, val):
        self.set_state_space(D=val)

    # -- canonical function access ------------------------------------------
    def ode_fn(self) -> Callable:
        if self._ode is None:
            raise RuntimeError("no dynamical equations set")
        return self._ode

    def alg_fn(self) -> Optional[Callable]:
        return self._alg

    def meas_fn(self) -> Callable:
        """Measurement function; defaults to full state observation."""
        if self._meas is not None:
            return self._meas
        return lambda x, z, u, p, t: x

    def quad_fn(self) -> Optional[Callable]:
        return self._quad

    def trace_signature(self):
        """Hashable signature of everything that enters the problem functions
        a controller or estimator builds on this model; returns (sig, keep).

        Two models with equal signatures give behaviorally identical
        ode/alg/meas/quad functions, so controllers built on them can share
        one registry entry (utils/trace_cache.py). DSL-built and state-space
        models hash by content (equation text or matrices, and the
        variable-name layout); callable-built models by the id of the exact
        function objects (same objects share, fresh lambdas do not).
        ``keep`` lists the objects whose ids appear in ``sig`` (the
        registry holds them so ids cannot be recycled)."""
        keep = []

        def fn_sig(fn):
            if fn is None:
                return None
            src = getattr(fn, "_hilo_dsl_src", None)
            if src is not None:
                return ("dsl", src)
            keep.append(fn)
            return ("id", id(fn))

        eq = ("fns", fn_sig(self._ode), fn_sig(self._alg),
              fn_sig(self._meas), fn_sig(self._quad))
        sig = (type(self).__name__, self.discrete, eq,
               tuple(self._x.names), tuple(self._z.names),
               tuple(self._u.names), tuple(self._p.names),
               tuple(self.measurements), self.n_q,
               None if self._z0 is None else tuple(np.asarray(self._z0)))
        return sig, keep

    # -- structural analysis --------------------------------------------------
    def _probe_args(self, seed: int = 0, spread: float = 0.37):
        rng = np.random.default_rng(seed)

        def mk(n):
            return torch.as_tensor(rng.normal(size=n) * spread + 0.21,
                                   dtype=self._dtype, device=self._device)

        return mk(self.n_x), mk(self.n_z), mk(self.n_u), mk(max(self.n_p, 0)), 0.13

    @property
    def is_linear(self) -> bool:
        """Probabilistic affinity check in (x, u): superposition at widely
        separated random probe points, evaluated in the model's dtype with
        tolerances of that dtype, so curvature shows up well above the
        rounding of a genuinely affine map."""
        if self._ode is None:
            return False
        if self._ss["A"] is not None:
            return True
        if self._dtype == torch.float64:
            tol = dict(rtol=1e-9, atol=1e-10)
        else:
            tol = dict(rtol=3e-5, atol=1e-6)
        try:
            for seeds in ((1, 2), (5, 9)):
                x1, z, u1, p, t = self._probe_args(seeds[0], spread=1.9)
                x2, _, u2, _, _ = self._probe_args(seeds[1], spread=1.9)

                def f(x, u):
                    return self.ode_fn()(x, z, u, p, t)

                a = 0.731
                lhs = f(a * x1 + (1 - a) * x2, a * u1 + (1 - a) * u2)
                rhs = a * f(x1, u1) + (1 - a) * f(x2, u2)
                if not np.allclose(lhs.cpu().numpy(), rhs.cpu().numpy(), **tol):
                    return False
            return True
        except Exception:  # a user function that fails at a probe point is
            return False   # not known to be linear (the reference's rule)

    @property
    def is_time_variant(self) -> bool:
        """Whether the dynamics change between two probe times."""
        if self._ode is None:
            return False
        try:
            x, z, u, p, _ = self._probe_args(3)
            f1 = self.ode_fn()(x, z, u, p, 0.17)
            f2 = self.ode_fn()(x, z, u, p, 2.93)
            return not np.allclose(f1.cpu().numpy(), f2.cpu().numpy(),
                                   rtol=1e-6, atol=1e-8)
        except Exception:
            return False

    # -- setup ----------------------------------------------------------------
    @records_setup
    def setup(self, dt: float = 1.0, integration_method: Optional[str] = None,
              degree: int = 3, scheme: str = "radau", substeps: int = 1,
              newton_iters: int = 8, options: Optional[dict] = None,
              device="cuda", dtype=torch.float32):
        """Build the per-step transition function on ``device`` in ``dtype``
        (explicit; nothing is chosen by detection; ``device="cpu"`` runs on
        the CPU). ``integration_method`` is one of the ERK names ('euler',
        'rk4', ...), 'collocation' (or 'irk'; Radau IIA or Gauss-Legendre by
        ``scheme``, of ``degree``), 'cvodes'/'idas' (Radau collocation of
        degree at least 3); the default is 'collocation' for a DAE model and
        'rk4' otherwise, and a discrete-time model always takes 'discrete'."""
        if self._ode is None:
            raise RuntimeError(f"model {self.name!r}: no equations set before setup()")
        if integration_method is None or self._discrete:
            integration_method = "discrete" if self._discrete else (
                "collocation" if self.n_z else "rk4")
        device = resolve_device(device)
        self._int_spec = IntegratorSpec(
            method=integration_method, degree=degree, scheme=scheme,
            substeps=substeps, newton_iters=newton_iters)
        self._dt = float(dt)
        self._device = device
        self._dtype = dtype

        ode, alg, quad, meas = self._ode, self._alg, self._quad, self.meas_fn()
        nx, nq = self.n_x, (self.n_q if self._quad is not None else 0)
        if quad is not None and not self._discrete:
            # quadratures integrated as augmented states: d[q]/dt = integrand
            def ode_aug(xa, z, u, p, t):
                x = xa[..., :nx]
                q = one_row_last(quad(x, z, u, p, t), x, nq)
                return torch.cat([ode(x, z, u, p, t), q], dim=-1)

            alg_aug = (None if alg is None else
                       lambda xa, z, u, p, t: alg(xa[..., :nx], z, u, p, t))
            core = make_step(ode_aug, alg_aug, nx + nq, self.n_z, self._int_spec)

            def step(x, z, u, p, t, dt):
                xa = torch.cat([x, x.new_zeros(x.shape[:-1] + (nq,))], dim=-1)
                xa_n, z_n = core(xa, z, u, p, t, dt)
                x_n = xa_n[..., :nx]
                return x_n, z_n, meas(x_n, z_n, u, p, t + dt), xa_n[..., nx:]
        else:
            core = make_step(ode, alg, nx, self.n_z, self._int_spec)

            def step(x, z, u, p, t, dt):
                x_n, z_n = core(x, z, u, p, t, dt)
                q_n = (one_row_last(quad(x_n, z_n, u, p, t + dt), x_n, nq)
                       if quad is not None else x_n[..., :0])
                return x_n, z_n, meas(x_n, z_n, u, p, t + dt), q_n

        self._step = step
        self.solution = TimeSeries(self._time_unit)
        self.solution.register("x", self._x.names)
        self.solution.register("z", self._z.names)
        self.solution.register("u", self._u.names)
        self.solution.register("y", self.measurements)
        self.solution.register("p", self._p.names)
        self._time = 0.0
        self._setup_done = True
        return self

    def is_setup(self) -> bool:
        return self._setup_done

    @property
    def step_fn(self) -> Callable:
        """step(x, z, u, p, t, dt) -> (x_next, z_next, y_next, q_next), batch-first."""
        if not self._setup_done:
            raise RuntimeError("call setup() first")
        return self._step

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a, dtype=float), dtype=self._dtype,
                               device=self._device)

    # -- initial conditions ---------------------------------------------------
    def set_initial_conditions(self, x0, z0=None):
        if self.solution is not None and self.solution.n_samples > 1:
            import warnings
            warnings.warn(
                "The model has already been simulated — call reset_solution() "
                "to record a new trajectory (no changes applied); for "
                "stateless one-off rollouts from arbitrary states use "
                "simulate(x0=..., ...) instead")
            return self
        self._x0 = np.atleast_1d(np.asarray(x0, dtype=float)).ravel()
        if self._x0.size != self.n_x:
            raise ValueError(f"x0 has {self._x0.size} entries, expected {self.n_x}")
        if z0 is not None:
            self._z0 = np.atleast_1d(np.asarray(z0, dtype=float)).ravel()
        if self.solution is not None and self.solution.n_samples == 1:
            self.solution.reset()
        if self.solution is not None and self.solution.n_samples == 0:
            z0v = self._z0 if self._z0 is not None else np.zeros(self.n_z)
            p0 = self._p0 if self._p0 is not None else np.zeros(self.n_p)
            y0 = self.meas_fn()(self._tensor(self._x0), self._tensor(z0v),
                                self._tensor(np.zeros(self.n_u)),
                                self._tensor(p0), 0.0)
            self.solution.append(0.0, x=self._x0, z=z0v, y=y0.cpu().numpy())
        return self

    def set_initial_parameter_values(self, p):
        self._p0 = np.atleast_1d(np.asarray(p, dtype=float)).ravel()
        if self._p0.size != self.n_p:
            raise ValueError(f"p has {self._p0.size} entries, expected {self.n_p}")
        return self

    def reset_solution(self):
        if self.solution is not None:
            self.solution.reset()
        self._time = 0.0
        if self._x0 is not None:
            self.set_initial_conditions(self._x0, self._z0)
        return self

    # -- simulation -----------------------------------------------------------
    def _coerce_u(self, u, steps: int) -> np.ndarray:
        if u is None:
            return np.zeros((steps, self.n_u))
        u = np.asarray(u, dtype=float)
        if u.ndim == 0:
            u = u.reshape(1, 1)
        if u.ndim == 1:
            if u.size == self.n_u:
                u = np.tile(u.reshape(1, -1), (steps, 1))
            elif self.n_u == 1:
                u = u.reshape(-1, 1)
        if u.shape == (self.n_u, steps) and self.n_u != steps:
            u = u.T
        if u.shape == (1, self.n_u) and steps > 1:
            u = np.tile(u, (steps, 1))
        if u.shape != (steps, self.n_u):
            raise ValueError(f"u has shape {u.shape}, expected {(steps, self.n_u)}")
        return u

    def _coerce_p(self, p, steps: int) -> np.ndarray:
        if p is None:
            if self._p0 is not None:
                p = self._p0
            elif self.n_p == 0:
                p = np.zeros(0)
            else:
                raise ValueError("model has parameters; pass p= or "
                                 "set_initial_parameter_values")
        p = np.asarray(p, dtype=float)
        if p.ndim <= 1:
            p = np.tile(np.atleast_1d(p).reshape(1, -1), (steps, 1))
        if p.shape == (self.n_p, steps) and self.n_p != steps:
            p = p.T
        if p.shape != (steps, self.n_p):
            raise ValueError(f"p has shape {p.shape}, expected {(steps, self.n_p)}")
        return p

    def _coerce_batched(self, val, steps, batch, n, coerce):
        """Per-scenario ``(B, steps, n)`` or ``(B, n)`` held over all steps;
        anything else is the shared ``(steps, n)`` layout."""
        if val is not None:
            arr = np.asarray(val, dtype=float)
            if arr.ndim == 3:
                if arr.shape != (batch, steps, n):
                    raise ValueError(f"per-scenario value has shape {arr.shape}, "
                                     f"expected {(batch, steps, n)}")
                return arr
            if arr.ndim == 2 and arr.shape == (batch, n) and arr.shape != (steps, n):
                return np.broadcast_to(arr[:, None, :], (batch, steps, n)).copy()
        return coerce(val, steps)

    def rollout_fn(self) -> Callable:
        """Pure rollout: (x0, z0, U, P, t0) -> dict of stacked trajectories, with
        x0 (..., n_x), U (..., steps, n_u), P (..., steps, n_p) tensors; the
        results are (..., steps, n)."""
        step = self.step_fn
        dt = self._dt

        def rollout(x0, z0, U, P, t0=0.0):
            x, z = x0, z0
            t = torch.as_tensor(t0, dtype=x0.dtype, device=x0.device)
            X, Z, Y, Q = [], [], [], []
            for k in range(U.shape[-2]):
                x, z, y, q = step(x, z, U[..., k, :], P[..., k, :], t, dt)
                t = t + dt
                X.append(x); Z.append(z); Y.append(y); Q.append(q)
            return {"x": torch.stack(X, -2), "z": torch.stack(Z, -2),
                    "y": torch.stack(Y, -2), "q": torch.stack(Q, -2)}

        return rollout

    def simulate(self, x0=None, z0=None, u=None, p=None, steps: Optional[int] = None,
                 t0: Optional[float] = None, store: bool = True):
        """Simulate ``steps`` steps (default: as many as rows of u).

        Unbatched: appends to ``self.solution``. Batched (x0 with a leading batch dim):
        every scenario at once, nothing stored, returns trajectory dict with a
        leading batch axis. Results are numpy arrays."""
        if not self._setup_done:
            raise RuntimeError("call setup() first")
        if self._needs_equilibrium:
            raise RuntimeError(
                "Model is linearized, but no equilibrium point was set. Please "
                "set equilibrium point before simulating the model!")
        if steps is None:
            if u is not None:
                u_arr = np.asarray(u, dtype=float)
                if u_arr.ndim == 3:
                    steps = u_arr.shape[1]
                elif u_arr.ndim == 2:
                    steps = u_arr.shape[0] if u_arr.shape[1] == self.n_u else u_arr.shape[1]
                elif u_arr.ndim == 1 and self.n_u == 1:
                    steps = u_arr.size
                else:
                    steps = 1
            else:
                steps = 1

        batched = x0 is not None and np.asarray(x0).ndim > 1
        if x0 is None:
            if self.solution is not None and self.solution.n_samples:
                x0 = self.solution["x:f"]
            elif self._x0 is not None:
                x0 = self._x0
            else:
                raise ValueError("no x0 given and no stored initial conditions")
        x0 = np.asarray(x0, dtype=float)
        if z0 is None:
            # the stored trajectory's last algebraic state, else zeros; a
            # column the solution never recorded reads NaN and starts at 0
            z0 = (self.solution["z:f"] if (self.solution is not None and
                                           self.solution.n_samples and self.n_z)
                  else np.zeros(self.n_z))
            z0 = np.nan_to_num(np.asarray(z0, dtype=float))
        z0 = np.asarray(z0, dtype=float)
        if batched and z0.ndim == 1:
            z0 = np.tile(z0, (x0.shape[0], 1))
        t_start = self._time if t0 is None else float(t0)

        if batched:
            B = x0.shape[0]
            U = self._coerce_batched(u, steps, B, self.n_u, self._coerce_u)
            P = self._coerce_batched(p, steps, B, self.n_p, self._coerce_p)
        else:
            U = self._coerce_u(u, steps)
            P = self._coerce_p(p, steps)
        out = self.rollout_fn()(self._tensor(x0), self._tensor(z0),
                                self._tensor(U), self._tensor(P), t_start)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        if not batched and store and self.solution is not None:
            ts = t_start + self._dt * np.arange(1, steps + 1)
            self.solution.append(ts, x=out["x"].T, z=out["z"].T if self.n_z else None,
                                 u=U.T, y=out["y"].T,
                                 p=P.T if self.n_p else None)
            self._time = float(ts[-1])
        return out

    # -- linearization --------------------------------------------------------
    def _param_vector(self, p):
        """Parameter values for a Jacobian: ``p``, else the stored initial
        values, else zeros."""
        if p is None and self._p0 is not None:
            return self._p0
        return np.asarray(p if p is not None else np.zeros(self.n_p), dtype=float)

    def linearize(self, x_eq=None, u_eq=None, z_eq=None, p=None, t: float = 0.0):
        """Jacobian linearization about an equilibrium: a linear model in
        Δ-coordinates (states dx, inputs du, measurements dy), with matrices
        computed in float64 on the CPU.

        Without a point the linearization is deferred: the returned model's
        A/B/C/D are finalized by ``set_equilibrium_point(...)`` on it, and
        ``simulate`` raises until then."""
        if self._linearized_parent is not None:
            print("Model is already linearized. Nothing to be done.")
            return self
        if self.is_linear:
            print("Model is already linear. Linearization is not necessary. "
                  "Nothing to be done.")
            return self
        deferred = x_eq is None and u_eq is None
        nx, nu, nz = self.n_x, self.n_u, self.n_z

        def vec(v, n):
            return torch.as_tensor(np.zeros(n) if v is None else np.asarray(v, float),
                                   dtype=torch.float64)

        x_v, u_v, z_v = vec(x_eq, nx), vec(u_eq, nu), vec(z_eq, nz)
        p_v = vec(self._param_vector(p), self.n_p)
        f, h = self.ode_fn(), self.meas_fn()
        jac = torch.func.jacfwd
        A = jac(lambda x: f(x, z_v, u_v, p_v, t))(x_v).numpy()
        B = jac(lambda u: f(x_v, z_v, u, p_v, t))(u_v).numpy()
        C = jac(lambda x: h(x, z_v, u_v, p_v, t))(x_v).numpy()
        D = jac(lambda u: h(x_v, z_v, u, p_v, t))(u_v).numpy()
        lin = Model(name=f"{self.name}_linearized", discrete=self._discrete,
                    time_unit=self._time_unit)
        lin.set_dynamical_states([f"d{n}" for n in self._x.names])
        if nu:
            lin.set_inputs([f"d{n}" for n in self._u.names])
        lin.set_measurements([f"d{n}" for n in self.measurements])
        lin.set_state_space(A=A, B=B if nu else None, C=C, D=D if nu else None)
        lin._linearized_parent = self
        if deferred:
            lin._needs_equilibrium = True
        else:
            lin._equilibrium = {"x": x_v.numpy(), "u": u_v.numpy(), "p": p_v.numpy()}
        return lin

    def set_equilibrium_point(self, x_eq, u_eq=None, p=None, tol: float = 1e-6):
        """Validate and store an equilibrium (raises if the dynamics do not
        rest there). On a model from a deferred ``linearize()`` this finalizes
        the linearization: A/B/C/D are recomputed at the point from the
        parent's dynamics."""
        x_eq = np.asarray(x_eq, dtype=float).ravel()
        if x_eq.size != self.n_x:
            raise ValueError(f"x_eq has {x_eq.size} entries, expected {self.n_x}")
        u_eq = (np.zeros(self.n_u) if u_eq is None
                else np.asarray(u_eq, dtype=float).ravel())
        if u_eq.size != self.n_u:
            raise ValueError(f"u_eq has {u_eq.size} entries, expected {self.n_u}")
        parent = self._linearized_parent
        if parent is not None:
            parent.set_equilibrium_point(x_eq, u_eq, p=p, tol=tol)
            fresh = parent.linearize(x_eq=x_eq, u_eq=u_eq, p=p)
            self._ss.update(fresh._ss)
            self.set_state_space()   # rebind the closures to the new matrices
            self._equilibrium = dict(fresh._equilibrium)
            self._needs_equilibrium = False
            if self._setup_done:
                spec = self._int_spec
                self.setup(dt=self._dt, integration_method=spec.method,
                           degree=spec.degree, scheme=spec.scheme,
                           substeps=spec.substeps, newton_iters=spec.newton_iters,
                           device=self._device, dtype=self._dtype)
            return self
        p_v = self._param_vector(p)
        f64 = dict(dtype=torch.float64)
        res = self.ode_fn()(torch.as_tensor(x_eq, **f64), torch.zeros(self.n_z, **f64),
                            torch.as_tensor(u_eq, **f64), torch.as_tensor(p_v, **f64),
                            0.0).numpy()
        if self._discrete:
            res = res - x_eq
        if np.max(np.abs(res)) > tol:
            raise ValueError(
                f"({x_eq}, {u_eq}) is not an equilibrium: residual {res} "
                f"(max |r| = {np.max(np.abs(res)):.3g} > tol {tol})")
        self._equilibrium = {"x": x_eq, "u": u_eq, "p": np.asarray(p_v)}
        return self

    def linearize_trajectory(self, X, U, p=None, t0: float = 0.0):
        """Time-varying linearization along a trajectory: (A_k, B_k) as numpy
        arrays (T, nx, nx) / (T, nx, nu), T the shorter of X and U, at the
        times t0 + k·dt, computed in float64 on the CPU (the algebraic
        states at zero)."""
        X = np.atleast_2d(np.asarray(X, dtype=float))
        U = np.atleast_2d(np.asarray(U, dtype=float))
        T = min(X.shape[0], U.shape[0])
        f64 = dict(dtype=torch.float64)
        f = self.ode_fn()
        z0 = torch.zeros(self.n_z, **f64)
        pv = torch.as_tensor(self._param_vector(p), **f64)
        dt = self._dt or 1.0
        jac = torch.func.jacfwd

        def jac_at(x, u, t):
            return (jac(lambda xx: f(xx, z0, u, pv, t))(x),
                    jac(lambda uu: f(x, z0, uu, pv, t))(u))

        ts = t0 + dt * torch.arange(T, **f64)
        A, B = torch.func.vmap(jac_at)(torch.as_tensor(X[:T], **f64),
                                       torch.as_tensor(U[:T], **f64), ts)
        return A.numpy(), B.numpy()

    def jacobians(self, x, u, z=None, p=None, t: float = 0.0):
        """(A, B): Jacobians of the right-hand side (continuous- or
        discrete-time) at a point, as tensors in the model's dtype on its
        device."""
        kw = dict(dtype=self._dtype, device=self._device)
        z = torch.zeros(self.n_z, **kw) if z is None else torch.as_tensor(
            np.asarray(z, float), **kw)
        p = torch.as_tensor(self._param_vector(p), **kw)
        x = torch.as_tensor(np.asarray(x, float), **kw)
        u = torch.as_tensor(np.asarray(u, float), **kw)
        f = self.ode_fn()
        A = torch.func.jacfwd(lambda xx: f(xx, z, u, p, t))(x)
        B = torch.func.jacfwd(lambda uu: f(x, z, uu, p, t))(u)
        return A, B

    # -- discretization -------------------------------------------------------
    def discretize(self, method: str = "rk4", degree: int = 3, substeps: int = 1,
                   dt: Optional[float] = None):
        """A discrete-time model whose difference equation is one integrator
        step of this model (of length ``dt``, else the discrete model's
        ``setup`` dt)."""
        if self._discrete:
            raise RuntimeError("model is already discrete")
        spec = IntegratorSpec(method=method, degree=degree, substeps=substeps)
        core = make_step(self.ode_fn(), self._alg, self.n_x, self.n_z, spec)
        disc = self.copy(keep_solution=False)
        disc._discrete = True

        def disc_map(x, z, u, p, t):
            h = dt if dt is not None else (disc._dt or 1.0)
            return core(x, z, u, p, t, h)[0]

        disc._ode = disc_map
        disc._ode_origin, disc._dsl = "callable", None
        return disc

    # -- data generation ------------------------------------------------------
    def generate_data(self, kind: str = "random_uniform", steps: int = 100, **kwargs):
        """A ``DataSet`` of ``steps`` steps under the input signal ``kind``
        (``random_uniform``, ``random_normal``, ``chirp``): features the
        states and inputs, labels the next states."""
        from ..utils.data import DataGenerator
        gen = DataGenerator(self, steps=steps, **kwargs)
        getattr(gen, kind)(**{k: v for k, v in kwargs.items()
                              if k in ("lb", "ub", "mean", "std", "seed")})
        gen.run()
        return gen.data

    # -- composition with learned components ---------------------------------
    def __add__(self, other):
        from ..ml.hybrid import hybridize
        return hybridize(self, other)

    def substitute_from(self, learned):
        """Replace the parameters named by the learned component's labels
        by its predictions."""
        from ..ml.hybrid import substitute_from as _sub
        _sub(self, learned)
        return self

    # -- misc -----------------------------------------------------------------
    def copy(self, name: Optional[str] = None, keep_solution: bool = False) -> "Model":
        new = _copy.copy(self)
        new.name = name or self.name
        new._x = self._x.copy(); new._z = self._z.copy(); new._u = self._u.copy()
        new._p = self._p.copy(); new._y = self._y.copy(); new._q = self._q.copy()
        new._ss = {k: (None if v is None else np.array(v)) for k, v in self._ss.items()}
        new.solution = (self.solution.copy() if (keep_solution and self.solution)
                        else None)
        if not keep_solution:
            new._setup_done = False
            new._step = None
        return new

    def __getstate__(self):
        state = self.__dict__.copy()
        # the step is rebuilt by setup() after unpickling
        state["_step"] = None
        state["_setup_done"] = False
        # the parent may hold unpicklable closures; a finalized linear model
        # no longer needs it (finalize deferred linearizations before pickling)
        state["_linearized_parent"] = None
        if state.get("_equations_src") is not None:
            # DSL models re-parse their text on load; equations given as
            # callables must pickle themselves (lambdas do not)
            for key in ("_ode", "_alg", "_meas", "_quad", "_dsl"):
                state[key] = None
        elif state.get("_ss", {}).get("A") is not None:
            # state-space models rebuild their closures from the matrices
            state["_ode"] = None
            state["_meas"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        if self._ode is None and self._ss.get("A") is not None:
            self.set_state_space()
        if self._equations_src is not None and self._ode is None:
            from ..utils.parsing import apply_parsed_equations
            x, z, u, p = (list(self._x.names), list(self._z.names),
                          list(self._u.names), list(self._p.names))
            apply_parsed_equations(self, self._equations_src)
            self._x.names, self._z.names = x, z
            self._u.names, self._p.names = u, p

    def __repr__(self):
        return (f"Model({self.name!r}, nx={self.n_x}, nz={self.n_z}, nu={self.n_u}, "
                f"np={self.n_p}, ny={self.n_y}, "
                f"{'discrete' if self._discrete else 'continuous'})")

    def __str__(self):
        """A summary table of the model's variables."""
        rows = [("kind", "names")]
        for kind, names in [("states", self._x.names),
                            ("algebraic", self._z.names),
                            ("inputs", self._u.names),
                            ("parameters", self._p.names),
                            ("measurements", self.measurements)]:
            rows.append((kind, ", ".join(names) if names else "-"))
        w0 = max(len(r[0]) for r in rows)
        w1 = max(len(r[1]) for r in rows)
        sep = "+" + "-" * (w0 + 2) + "+" + "-" * (w1 + 2) + "+"
        lines = [f"Model {self.name!r} "
                 f"({'discrete' if self._discrete else 'continuous'}"
                 f"{', set up, dt=' + str(self._dt) if self._setup_done else ''})",
                 sep]
        for i, (a, b) in enumerate(rows):
            lines.append(f"| {a:<{w0}} | {b:<{w1}} |")
            if i == 0:
                lines.append(sep)
        lines.append(sep)
        return "\n".join(lines)

    def __iter__(self):
        yield from {"x": self._x.names, "z": self._z.names, "u": self._u.names,
                    "p": self._p.names, "y": self.measurements}.items()
