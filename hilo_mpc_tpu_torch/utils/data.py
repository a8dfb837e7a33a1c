"""Data sets and excitation-signal generators for training surrogates.

PyTorch port of ``hilo_mpc_tpu/utils/data.py``: ``DataSet`` holds named
feature/label columns with train/test selection and noise injection;
``DataGenerator`` excites a set-up ``Model`` with random or chirp input
signals (or a controller in closed loop), simulates it with the port's
``Model.simulate`` (on the model's device and in its dtype), and emits
features/labels with absolute, delta or difference-quotient outputs. The
draws are numpy's, as in the JAX package, so both give the same signals.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..core.model import Model


class DataSet:
    def __init__(self, features: Sequence[str], labels: Sequence[str],
                 add_time: bool = False):
        self.features = [features] if isinstance(features, str) else list(features)
        self.labels = [labels] if isinstance(labels, str) else list(labels)
        self._X = np.zeros((0, len(self.features)))
        self._y = np.zeros((0, len(self.labels)))
        self._t = np.zeros((0,))
        self._test_idx: Optional[np.ndarray] = None

    @property
    def n_samples(self) -> int:
        return self._X.shape[0]

    def __len__(self):
        return self.n_samples

    def add_data(self, X, y, t=None):
        X = np.atleast_2d(np.asarray(X, dtype=float))
        y = np.atleast_2d(np.asarray(y, dtype=float))
        if X.shape[1] != len(self.features) and X.shape[0] == len(self.features):
            X = X.T
        if y.shape[1] != len(self.labels) and y.shape[0] == len(self.labels):
            y = y.T
        if X.shape[0] != y.shape[0]:
            raise ValueError(f"{X.shape[0]} feature rows vs {y.shape[0]} label rows")
        self._X = np.concatenate([self._X, X], axis=0)
        self._y = np.concatenate([self._y, y], axis=0)
        t = (np.full(X.shape[0], np.nan) if t is None
             else np.asarray(t, dtype=float).ravel())
        self._t = np.concatenate([self._t, t])
        return self

    @property
    def features_values(self) -> np.ndarray:
        return np.array(self._X)

    @property
    def labels_values(self) -> np.ndarray:
        return np.array(self._y)

    def __getitem__(self, name: str) -> np.ndarray:
        if name in self.features:
            return self._X[:, self.features.index(name)]
        if name in self.labels:
            return self._y[:, self.labels.index(name)]
        if name == "t":
            return np.array(self._t)
        raise KeyError(name)

    def train_test_split(self, test_fraction: float = 0.2, seed: int = 0,
                         shuffle: bool = True):
        n = self.n_samples
        idx = (np.random.default_rng(seed).permutation(n) if shuffle
               else np.arange(n))
        n_test = int(n * test_fraction)
        self._test_idx = idx[:n_test]
        train_idx = idx[n_test:]
        return ((self._X[train_idx], self._y[train_idx]),
                (self._X[self._test_idx], self._y[self._test_idx]))

    def add_noise(self, std=0.01, seed: Optional[int] = None, what: str = "labels"):
        rng = np.random.default_rng(seed)
        if what in ("labels", "both"):
            self._y = self._y + rng.normal(size=self._y.shape) * np.asarray(std)
        if what in ("features", "both"):
            self._X = self._X + rng.normal(size=self._X.shape) * np.asarray(std)
        return self

    def sort(self, by: str):
        order = np.argsort(self[by])
        self._X = self._X[order]
        self._y = self._y[order]
        self._t = self._t[order]
        return self

    def append(self, other: "DataSet"):
        return self.add_data(other._X, other._y, other._t)

    def copy(self) -> "DataSet":
        ds = DataSet(self.features, self.labels)
        ds.add_data(self._X, self._y, self._t)
        return ds


class DataGenerator:
    """Excite a model and collect training data (reference: util/data.py:642-1209)."""

    def __init__(self, model: Model, steps: int = 100, x0=None, p=None,
                 seed: int = 0, **_):
        if not model.is_setup():
            raise RuntimeError("model must be set up (model.setup(dt=...))")
        self._model = model
        self.steps = int(steps)
        self._x0 = (np.asarray(x0, dtype=float).ravel() if x0 is not None
                    else (model._x0 if model._x0 is not None
                          else np.zeros(model.n_x)))
        self._p = p
        self._seed = seed
        self._U: Optional[np.ndarray] = None
        self.data: Optional[DataSet] = None

    # -- input signal designs -------------------------------------------------
    def random_uniform(self, lb=-1.0, ub=1.0, hold: int = 1, seed=None, **_):
        rng = np.random.default_rng(self._seed if seed is None else seed)
        nu = self._model.n_u
        lb = np.broadcast_to(np.asarray(lb, float).ravel(), (nu,))
        ub = np.broadcast_to(np.asarray(ub, float).ravel(), (nu,))
        n_holds = int(np.ceil(self.steps / hold))
        sig = rng.uniform(lb, ub, size=(n_holds, nu))
        self._U = np.repeat(sig, hold, axis=0)[: self.steps]
        return self

    def random_normal(self, mean=0.0, std=1.0, hold: int = 1, seed=None, **_):
        rng = np.random.default_rng(self._seed if seed is None else seed)
        nu = self._model.n_u
        mean = np.broadcast_to(np.asarray(mean, float).ravel(), (nu,))
        std = np.broadcast_to(np.asarray(std, float).ravel(), (nu,))
        n_holds = int(np.ceil(self.steps / hold))
        sig = rng.normal(mean, std, size=(n_holds, nu))
        self._U = np.repeat(sig, hold, axis=0)[: self.steps]
        return self

    def chirp(self, amplitude=1.0, offset=0.0, f0: float = 0.01, f1: float = 0.5,
              kind: str = "linear", **_):
        """Swept-frequency excitation: linear/exponential/hyperbolic chirp."""
        dt = self._model.dt or 1.0
        t = np.arange(self.steps) * dt
        T = t[-1] if t[-1] > 0 else 1.0
        if kind == "linear":
            phase = 2 * np.pi * (f0 * t + (f1 - f0) / (2 * T) * t ** 2)
        elif kind == "exponential":
            k = (f1 / f0) ** (1 / T)
            phase = 2 * np.pi * f0 * (k ** t - 1) / np.log(k)
        elif kind == "hyperbolic":
            phase = 2 * np.pi * f0 * f1 * T / (f1 - f0) * np.log(
                1 - (f1 - f0) / (f1 * T) * t)
            phase = -phase
        else:
            raise ValueError(f"unknown chirp kind {kind!r} "
                             "(linear|exponential|hyperbolic)")
        sig = offset + amplitude * np.sin(phase)
        self._U = np.tile(sig[:, None], (1, max(self._model.n_u, 1)))
        self._U = self._U[:, : self._model.n_u]
        return self

    def closed_loop(self, controller, **_):
        """Excite via a controller in the loop (reference: data.py closed_loop)."""
        self._controller = controller
        self._U = "closed_loop"
        return self

    # -- run -------------------------------------------------------------------
    def run(self, output: str = "absolute", features: Optional[List[str]] = None,
            labels: Optional[List[str]] = None, shift: int = 0):
        """Simulate and build the DataSet.

        output: 'absolute' (x_{k+1}), 'delta' (x_{k+1}-x_k), or
        'difference_quotient' ((x_{k+1}-x_k)/dt).
        """
        model = self._model
        if self._U is None:
            raise RuntimeError("design an input signal first "
                               "(random_uniform/random_normal/chirp/closed_loop)")
        dt = model.dt or 1.0
        if isinstance(self._U, str):  # closed loop
            x = np.array(self._x0)
            X_traj = [x]
            U_traj = []
            for k in range(self.steps):
                u = np.atleast_1d(np.asarray(self._controller.optimize(x)
                                             if hasattr(self._controller, "optimize")
                                             else self._controller(x)))
                out = model.simulate(x0=x, u=u, p=self._p, steps=1, store=False)
                x = out["x"][-1]
                X_traj.append(x)
                U_traj.append(u)
            X_traj = np.asarray(X_traj)
            U = np.asarray(U_traj)
        else:
            U = self._U
            out = model.simulate(x0=self._x0, u=U, p=self._p,
                                 steps=U.shape[0], store=False)
            X_traj = np.vstack([self._x0[None, :], out["x"]])

        x_names = model.dynamical_states
        u_names = model.inputs
        feats = features or (x_names + u_names)
        labs = labels or x_names
        X_cols = {nm: X_traj[:-1, i] for i, nm in enumerate(x_names)}
        X_cols.update({nm: U[:, i] for i, nm in enumerate(u_names)})
        if output == "absolute":
            y_vals = X_traj[1:]
        elif output == "delta":
            y_vals = X_traj[1:] - X_traj[:-1]
        elif output == "difference_quotient":
            y_vals = (X_traj[1:] - X_traj[:-1]) / dt
        else:
            raise ValueError(f"unknown output mode {output!r}")
        y_cols = {nm: y_vals[:, i] for i, nm in enumerate(x_names)}

        ds = DataSet(feats, labs)
        Xd = np.stack([X_cols[nm] for nm in feats], axis=1)
        yd = np.stack([y_cols[nm] for nm in labs], axis=1)
        t = dt * np.arange(Xd.shape[0])
        ds.add_data(Xd, yd, t)
        self.data = ds
        return ds
