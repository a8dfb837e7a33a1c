"""Solution storage: append-only named time series.

PyTorch port of ``hilo_mpc_tpu/core/series.py``. Storage is host numpy (device
tensors are brought to the host before appending); per-variable access
supports ``'x'``, a state name, ``'x:f'`` (final) and ``'x:0'`` (initial).
Plotting is not ported yet (ROADMAP.md §A.10).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


class TimeSeries:
    """Columnar append-only storage for simulation/estimation/control trajectories.

    Each registered kind (e.g. ``'x'``, ``'u'``, ``'y'``) holds a (n_vars, n_samples)
    array plus the variable names, so entries are addressable by kind or by name.
    """

    def __init__(self, time_unit: str = "s"):
        self._kinds: Dict[str, List[str]] = {}
        self._data: Dict[str, np.ndarray] = {}
        self._time = np.zeros((0,))
        self.time_unit = time_unit

    # -- registration -------------------------------------------------------
    def register(self, kind: str, names: Sequence[str]) -> None:
        names = list(names)
        self._kinds[kind] = names
        self._data[kind] = np.zeros((len(names), 0))

    @property
    def kinds(self) -> List[str]:
        return list(self._kinds)

    def names(self, kind: str) -> List[str]:
        return list(self._kinds[kind])

    @property
    def n_samples(self) -> int:
        return int(self._time.shape[0])

    def __len__(self) -> int:
        return self.n_samples

    # -- append -------------------------------------------------------------
    def append(self, t, **kind_values) -> None:
        """Append one or more samples. ``t`` is scalar or (k,); values are
        (n_vars,) or (n_vars, k) arrays per kind."""
        t = np.atleast_1d(np.asarray(t, dtype=float))
        k = t.shape[0]
        self._time = np.concatenate([self._time, t])
        for kind, val in kind_values.items():
            if val is None:
                continue
            if kind not in self._data:
                raise KeyError(f"kind {kind!r} not registered (have {self.kinds})")
            arr = np.asarray(val, dtype=float)
            n = len(self._kinds[kind])
            if arr.ndim == 0:
                arr = arr.reshape(1, 1)
            elif arr.ndim == 1:
                arr = arr.reshape(n, 1) if k == 1 else arr.reshape(1, k)
            if arr.shape != (n, k):
                raise ValueError(
                    f"kind {kind!r}: expected shape {(n, k)}, got {arr.shape}"
                )
            self._data[kind] = np.concatenate([self._data[kind], arr], axis=1)
        # pad unmentioned kinds with NaN so columns stay aligned
        for kind in self._kinds:
            if kind not in kind_values or kind_values.get(kind) is None:
                n = len(self._kinds[kind])
                pad = np.full((n, k), np.nan)
                self._data[kind] = np.concatenate([self._data[kind], pad], axis=1)

    # -- access -------------------------------------------------------------
    def _lookup_name(self, name: str):
        for kind, names in self._kinds.items():
            if name in names:
                return kind, names.index(name)
        raise KeyError(f"unknown series entry {name!r}")

    def __getitem__(self, key: str) -> np.ndarray:
        if key == "t":
            return self._time
        sel = None
        if ":" in key:
            key, sel = key.split(":", 1)
        if key in self._data:
            arr = self._data[key]
        else:
            kind, idx = self._lookup_name(key)
            arr = self._data[kind][idx : idx + 1]
        if sel is None:
            return arr
        if sel == "f":
            return arr[:, -1] if arr.shape[1] else np.full(arr.shape[0], np.nan)
        if sel == "0":
            return arr[:, 0] if arr.shape[1] else np.full(arr.shape[0], np.nan)
        return arr[:, int(sel)]

    def get(self, key: str, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def to_dict(self) -> Dict[str, np.ndarray]:
        out = {"t": self._time}
        out.update({k: v for k, v in self._data.items()})
        return out

    # -- utilities ----------------------------------------------------------
    def make_some_noise(self, kind: str = "y", std=None, seed: Optional[int] = None):
        """Return a noisy copy of a stored kind."""
        rng = np.random.default_rng(seed)
        arr = self._data[kind]
        if std is None:
            std = 0.05 * np.nanstd(arr, axis=1, keepdims=True)
        std = np.broadcast_to(np.asarray(std, dtype=float).reshape(-1, 1), arr.shape)
        return arr + rng.normal(size=arr.shape) * std

    def reset(self) -> None:
        self._time = np.zeros((0,))
        for kind in self._data:
            self._data[kind] = np.zeros((len(self._kinds[kind]), 0))

    def copy(self) -> "TimeSeries":
        ts = TimeSeries(self.time_unit)
        ts._kinds = {k: list(v) for k, v in self._kinds.items()}
        ts._data = {k: np.array(v) for k, v in self._data.items()}
        ts._time = np.array(self._time)
        return ts
