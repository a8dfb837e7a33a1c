"""Quadratic cost terms for MPC.

PyTorch port of the quadratic part of ``hilo_mpc_tpu/control/costs.py``:
stage/terminal costs accumulate named state/input terms with weights and
references (constant, or supplied per solve through the per-stage parameter
vector theta). The terms are plain numpy descriptions; ``control/nmpc.py``
lowers them to batch-first torch functions.

Not ported yet: Δu and path-following terms (ROADMAP.md §A item 9),
measurement terms, generic costs and constraints (item 7).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

_NOT_PORTED = ("{what} is not ported to the PyTorch package yet — "
               "ROADMAP.md §A item {item}")


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
    kind: str                      # 'states' | 'inputs'
    names: List[str]
    idx: np.ndarray                # indices into the relevant vector
    W: np.ndarray                  # (n, n) weights
    ref: Optional[np.ndarray]      # constant reference, or None for zero/no reference
    trajectory_tracking: bool = False   # reference provided per-step at solve time

    @property
    def n(self) -> int:
        return len(self.idx)

    @property
    def runtime_ref(self) -> bool:
        """True if the reference values are supplied per solve through theta
        (per-step trajectory windows or refs passed to optimize(ref=...))."""
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
             path_following):
        if path_following or callable(ref):
            raise NotImplementedError(
                _NOT_PORTED.format(what="path following", item=9))
        names, idx = self._resolve(names, pool, kind)
        W = _as_weight_matrix(weights if weights is not None else 1.0, len(idx))
        ref_arr = None
        if ref is not None:
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
        self.terms.append(QuadTerm(
            kind=kind, names=names, idx=idx, W=W, ref=ref_arr,
            trajectory_tracking=bool(trajectory_tracking)))
        return self

    def add_states(self, names=None, weights=None, ref=None,
                   trajectory_tracking=False, path_following=False, path_fn=None):
        return self._add("states", self._model.dynamical_states, names, weights,
                         ref, trajectory_tracking, path_following or path_fn)

    def add_inputs(self, names=None, weights=None, ref=None,
                   trajectory_tracking=False, path_following=False):
        return self._add("inputs", self._model.inputs, names, weights, ref,
                         trajectory_tracking, path_following)

    def add_inputs_change(self, names=None, weights=None):
        raise NotImplementedError(
            _NOT_PORTED.format(what="Δu (inputs_change) costs", item=9))

    def add_measurements(self, names=None, weights=None, ref=None,
                         trajectory_tracking=False, path_following=False):
        raise NotImplementedError(
            _NOT_PORTED.format(what="measurement costs", item=7))

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
