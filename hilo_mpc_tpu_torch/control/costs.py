"""Cost and constraint building blocks for MPC.

PyTorch port of ``hilo_mpc_tpu/control/costs.py``: quadratic stage/terminal
costs accumulate named state, input and measurement terms with weights and
references (constant, or supplied per solve through the per-stage parameter
vector theta); generic costs and constraints are callables over
(x, u, p, t). The quadratic terms are plain numpy descriptions;
``control/nmpc.py`` lowers everything to batch-first torch functions, so a
user callable takes x (..., n_x), u (..., n_u), p (..., n_p), t (...).
Input-change terms (``add_inputs_change``) weigh Δu of the augmented
formulation; a path-following term's reference is ``path_fn`` of the path
parameter, batch-first too: th (...) -> (..., n).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..core.model import one_row_last


def _as_weight_matrix(weights, n: int) -> np.ndarray:
    W = np.asarray(weights, dtype=float)
    if W.ndim == 0:
        W = np.eye(n) * float(W)
    elif W.ndim == 1:
        if W.size != n:
            raise ValueError(f"got {W.size} weights for {n} variables")
        W = np.diag(W)
    elif W.shape != (n, n):
        raise ValueError(f"weight matrix shape {W.shape}, expected {(n, n)}")
    return W


@dataclasses.dataclass
class QuadTerm:
    kind: str                      # 'states' | 'inputs' | 'inputs_change' | 'measurements'
    names: List[str]
    idx: np.ndarray                # indices into the relevant vector
    W: np.ndarray                  # (n, n) weights
    ref: Optional[np.ndarray]      # constant reference, or None for zero/no reference
    trajectory_tracking: bool = False   # reference provided per-step at solve time
    path_following: bool = False        # reference is a function of the path parameter
    path_fn: Optional[Callable] = None  # th (...) -> (..., n) reference on the path

    @property
    def n(self) -> int:
        return len(self.idx)

    @property
    def runtime_ref(self) -> bool:
        """True if the reference values are supplied per solve through theta
        (per-step trajectory windows or refs passed to optimize(ref=...))."""
        if self.path_following:
            return False
        return self.trajectory_tracking or (self.ref is not None
                                            and self.ref.ndim == 2)


class QuadraticCost:
    """Accumulates quadratic penalty terms; ``add_*`` mirrors the JAX API."""

    def __init__(self, model):
        self._model = model
        self.terms: List[QuadTerm] = []

    @property
    def is_empty(self) -> bool:
        return not self.terms

    def _resolve(self, names, pool: Sequence[str], what: str):
        if names is None:
            names = list(pool)
        if isinstance(names, str):
            names = [names]
        idx = []
        for nm in names:
            if nm not in pool:
                raise ValueError(f"unknown {what} {nm!r}; have {list(pool)}")
            idx.append(list(pool).index(nm))
        return list(names), np.asarray(idx, dtype=int)

    def _add(self, kind, pool, names, weights, ref, trajectory_tracking,
             path_following, path_fn=None):
        names, idx = self._resolve(names, pool, kind)
        W = _as_weight_matrix(weights if weights is not None else 1.0, len(idx))
        ref_arr = None
        if ref is not None and not callable(ref):
            ref_arr = np.asarray(ref, dtype=float)
            if ref_arr.ndim == 0:
                ref_arr = np.full(len(idx), float(ref_arr))
            if ref_arr.ndim == 1 and ref_arr.size != len(idx):
                raise ValueError(f"reference has {ref_arr.size} entries for "
                                 f"{len(idx)} variables")
            if ref_arr.ndim == 2 and ref_arr.shape[1] != len(idx):
                raise ValueError(
                    f"trajectory reference has {ref_arr.shape[1]} columns "
                    f"for {len(idx)} variables")
        if callable(ref):
            path_fn, path_following = ref, True
        self.terms.append(QuadTerm(
            kind=kind, names=names, idx=idx, W=W, ref=ref_arr,
            trajectory_tracking=bool(trajectory_tracking),
            path_following=bool(path_following), path_fn=path_fn))
        return self

    def add_states(self, names=None, weights=None, ref=None,
                   trajectory_tracking=False, path_following=False, path_fn=None):
        return self._add("states", self._model.dynamical_states, names, weights,
                         ref, trajectory_tracking, path_following, path_fn)

    def add_inputs(self, names=None, weights=None, ref=None,
                   trajectory_tracking=False, path_following=False):
        return self._add("inputs", self._model.inputs, names, weights, ref,
                         trajectory_tracking, path_following)

    def add_inputs_change(self, names=None, weights=None):
        """A quadratic penalty on the input increments Δu (the controller
        then runs the Δu-augmented formulation)."""
        return self._add("inputs_change", self._model.inputs, names, weights,
                         None, False, False)

    def add_measurements(self, names=None, weights=None, ref=None,
                         trajectory_tracking=False, path_following=False):
        return self._add("measurements", self._model.measurements, names, weights,
                         ref, trajectory_tracking, path_following)

    def _kind_matrix(self, kind, n):
        M = np.zeros((n, n))
        for t in self.terms:
            if t.kind == kind:
                M[np.ix_(t.idx, t.idx)] += t.W
        return M

    @property
    def Q(self):
        return self._kind_matrix("states", self._model.n_x)

    @property
    def R(self):
        return self._kind_matrix("inputs", self._model.n_u)

    @property
    def n_runtime_refs(self) -> int:
        """Number of reference entries supplied per solve (through theta)."""
        return sum(t.n for t in self.terms if t.runtime_ref)


class GenericCost:
    """Arbitrary stage/terminal cost as a batch-first callable over
    (x, u, p, t) returning (...) or (..., 1) (reference: GenericCost,
    util/modeling.py:38)."""

    def __init__(self, model):
        self._model = model
        self._fn: Optional[Callable] = None

    @property
    def is_empty(self) -> bool:
        return self._fn is None

    @property
    def cost(self):
        return self._fn

    @cost.setter
    def cost(self, fn: Callable):
        from ..core.model import wrap_rhs

        wrapped = wrap_rhs(fn, "cost")
        self._fn = lambda x, u, p, t: one_row_last(
            wrapped(x, x[..., :0], u, p, t), x, 1)[..., 0]

    def __call__(self, x, u, p, t):
        return self._fn(x, u, p, t)


@dataclasses.dataclass
class GenericConstraint:
    """Nonlinear stage or terminal constraint lb <= g(x, u, p, t) <= ub,
    optionally softened (reference: GenericConstraint,
    util/modeling.py:820-1005). ``fn`` is batch-first: (..., n).

    Soft constraints use the exact quadratic/linear penalty reformulation: the
    NLP ``min f + w·eps² s.t. g <= ub + eps, eps >= 0`` has the closed-form
    minimizer eps* = relu(g - ub), so the slack never becomes a decision
    variable; with ``max_violation`` a hard constraint at ub + max_violation
    remains.
    """

    fn: Callable                       # canonical g(x, u, p, t) -> (..., m)
    n: int
    lb: np.ndarray
    ub: np.ndarray
    is_soft: bool = False
    weight: float = 1e4                # quadratic penalty weight when soft
    linear_weight: float = 0.0         # optional l1-ish penalty (smoothed by relu)
    max_violation: Optional[np.ndarray] = None
    name: str = "constraint"

    def __post_init__(self):
        self.lb = np.broadcast_to(np.asarray(self.lb, dtype=float), (self.n,)).copy()
        self.ub = np.broadcast_to(np.asarray(self.ub, dtype=float), (self.n,)).copy()
        if self.max_violation is not None:
            self.max_violation = np.broadcast_to(
                np.asarray(self.max_violation, dtype=float), (self.n,)).copy()

    def equality_rows(self) -> np.ndarray:
        """Rows with lb == ub (handled as true equalities by the solver's
        augmented-Lagrangian path, not as tight inequality bands)."""
        if self.is_soft:
            return np.zeros(self.n, bool)
        both = np.isfinite(self.lb) & np.isfinite(self.ub)
        return both & (np.abs(self.ub - self.lb) < 1e-9)

    def hard_rows(self):
        """Static description of the hard inequality rows this constraint adds."""
        if not self.is_soft:
            eq = self.equality_rows()
            ub_rows = np.isfinite(self.ub) & ~eq
            lb_rows = np.isfinite(self.lb) & ~eq
            return ub_rows, lb_rows, self.ub, self.lb
        if self.max_violation is not None:
            ub_rows = np.isfinite(self.ub)
            lb_rows = np.isfinite(self.lb)
            return (ub_rows, lb_rows, self.ub + self.max_violation,
                    self.lb - self.max_violation)
        return (np.zeros(self.n, bool), np.zeros(self.n, bool), self.ub, self.lb)

    def penalty(self, g):
        """Soft-constraint penalty (...) for constraint values g (..., n).
        ``torch.maximum``, as the reference's ``jnp.maximum``, splits the
        derivative in half where g sits on a bound."""
        if not self.is_soft:
            return 0.0
        kw = dict(dtype=g.dtype, device=g.device)
        ub = torch.as_tensor(np.where(np.isfinite(self.ub), self.ub, 1e20), **kw)
        lb = torch.as_tensor(np.where(np.isfinite(self.lb), self.lb, -1e20), **kw)
        zero = torch.zeros((), **kw)
        viol = torch.maximum(g - ub, zero) + torch.maximum(lb - g, zero)
        pen = self.weight * (viol ** 2).sum(dim=-1)
        if self.linear_weight:
            pen = pen + self.linear_weight * viol.sum(dim=-1)
        return pen


def make_constraint(fn: Callable, lb=None, ub=None, n: Optional[int] = None,
                    is_soft: bool = False, weight: float = 1e4,
                    max_violation=None, name: str = "constraint",
                    probe_dims=None) -> GenericConstraint:
    """Build a GenericConstraint from a batch-first user callable with flexible
    signature. Without ``n`` the rows are counted on a probe batch of two
    scenarios (``probe_dims`` = (n_x, n_u, n_p)): a value of the batch shape
    itself is one row."""
    from ..core.model import wrap_rhs

    wrapped = wrap_rhs(fn, "constraint")
    if n is None:
        if probe_dims is None:
            raise ValueError("pass n= (number of constraint rows)")
        nx, nu, np_ = probe_dims
        x = torch.zeros(2, nx, dtype=torch.float64)
        out = wrapped(x, x[..., :0], torch.zeros(2, nu, dtype=torch.float64),
                      torch.zeros(2, np_, dtype=torch.float64),
                      torch.zeros(2, dtype=torch.float64))
        n = 1 if out.dim() == 1 else out.shape[-1]
    n = int(n)

    def canon(x, u, p, t):
        return one_row_last(wrapped(x, x[..., :0], u, p, t), x, n)

    lb = -np.inf if lb is None else lb
    ub = np.inf if ub is None else ub
    return GenericConstraint(fn=canon, n=n, lb=lb, ub=ub, is_soft=is_soft,
                             weight=weight, max_violation=max_violation, name=name)
