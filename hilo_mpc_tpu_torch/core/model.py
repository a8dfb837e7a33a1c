"""Dynamic model: declaration, integration, simulation.

PyTorch port of ``hilo_mpc_tpu/core/model.py`` (the parts the batched NMPC
path needs). A model's equations are plain functions ``f(x, z, u, p, t)`` over
BATCH-FIRST tensors (``x`` is ``(..., n_x)``, the result ``(..., n_x)``), built
from the equation-string DSL (utils/parsing.py) or given as callables.
``setup`` composes them with a fixed-step ERK integrator (core/integrators.py)
on an explicit device and dtype; ``simulate`` rolls the step out with a Python
loop over time, every scenario at once.

Not ported yet: quadratures, DAE algebraic states, discrete-time models,
linearization and the state-space declaration (ROADMAP.md §A item 7).
"""
from __future__ import annotations

import copy as _copy
import inspect
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from .integrators import IntegratorSpec, make_step
from .series import TimeSeries
from .variables import VarSpec

_CANONICAL_ARGS = ("x", "z", "u", "p", "t")
_NOT_PORTED = "{what} is not ported to the PyTorch package yet — ROADMAP.md §A item 7"


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


class Model:
    """Dynamic ODE model with measurements."""

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
        self._ode = wrap_rhs(fn, "ode")
        return self

    def set_measurement_equations(self, fn: Union[Callable, str, Sequence[str]]):
        if isinstance(fn, (str, list, tuple)):
            return self.set_equations(meas=fn)
        self._meas = wrap_rhs(fn, "meas")
        return self

    def set_equations(self, equations=None, ode=None, meas=None):
        """Set equations from callables, a dict of callables, or the equation-string DSL."""
        from ..utils.parsing import apply_parsed_equations

        if isinstance(equations, dict):
            ode = equations.get("ode", ode)
            meas = equations.get("meas", meas)
            equations = None
        if equations is not None:
            if callable(equations):
                self._ode = wrap_rhs(equations, "ode")
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
                self._ode = wrap_rhs(fn, what)
            else:
                self._meas = wrap_rhs(fn, what)
        return self

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

    # -- setup ----------------------------------------------------------------
    def setup(self, dt: float = 1.0, integration_method: Optional[str] = None,
              degree: int = 3, scheme: str = "radau", substeps: int = 1,
              newton_iters: int = 8, options: Optional[dict] = None,
              device="cpu", dtype=torch.float32):
        """Build the per-step transition function on ``device`` in ``dtype``
        (explicit; nothing is chosen by detection). ``integration_method``
        is one of the ERK names ('euler', 'rk4', ...)."""
        if self._ode is None:
            raise RuntimeError(f"model {self.name!r}: no equations set before setup()")
        if self._quad is not None:
            raise NotImplementedError(_NOT_PORTED.format(what="quadratures"))
        if self.n_z or self._discrete:
            raise NotImplementedError(_NOT_PORTED.format(
                what="DAE and discrete-time models"))
        if integration_method is None:
            integration_method = "rk4"
        self._int_spec = IntegratorSpec(
            method=integration_method, degree=degree, scheme=scheme,
            substeps=substeps, newton_iters=newton_iters)
        self._dt = float(dt)
        self._device = torch.device(device)
        self._dtype = dtype

        core = make_step(self._ode, self._alg, self.n_x, self.n_z, self._int_spec)
        meas = self.meas_fn()

        def step(x, z, u, p, t, dt):
            x_n, z_n = core(x, z, u, p, t, dt)
            y_n = meas(x_n, z_n, u, p, t + dt)
            return x_n, z_n, y_n, x_n[..., :0]

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
        z0 = np.zeros(x0.shape[:-1] + (self.n_z,))
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

    # -- misc -----------------------------------------------------------------
    def copy(self, name: Optional[str] = None, keep_solution: bool = False) -> "Model":
        new = _copy.copy(self)
        new.name = name or self.name
        new._x = self._x.copy(); new._z = self._z.copy(); new._u = self._u.copy()
        new._p = self._p.copy(); new._y = self._y.copy(); new._q = self._q.copy()
        new.solution = (self.solution.copy() if (keep_solution and self.solution)
                        else None)
        if not keep_solution:
            new._setup_done = False
            new._step = None
        return new

    def __repr__(self):
        return (f"Model({self.name!r}, nx={self.n_x}, nz={self.n_z}, nu={self.n_u}, "
                f"np={self.n_p}, ny={self.n_y}, "
                f"{'discrete' if self._discrete else 'continuous'})")
