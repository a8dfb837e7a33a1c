"""Solution storage: append-only named time series.

PyTorch port of ``hilo_mpc_tpu/core/series.py``. Storage is host numpy (device
tensors are brought to the host before appending); per-variable access
supports ``'x'``, a state name, ``'x:f'`` (final) and ``'x:0'`` (initial).
``OptimizationSeries`` keeps per-solve solver statistics. ``plot`` draws
through the active plot backend (utils/plotting.py).
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

    def sort(self, by: str = "t") -> "TimeSeries":
        """Reorder samples by a column (default: time)."""
        key = self._time if by == "t" else self[by].ravel()
        order = np.argsort(key)
        self._time = self._time[order]
        for kind in self._data:
            self._data[kind] = self._data[kind][:, order]
        return self

    def copy(self) -> "TimeSeries":
        ts = TimeSeries(self.time_unit)
        ts._kinds = {k: list(v) for k, v in self._kinds.items()}
        ts._data = {k: np.array(v) for k, v in self._data.items()}
        ts._time = np.array(self._time)
        return ts

    def interpolate(self, t_new, kind: Optional[str] = None):
        """Resample onto a new time grid by per-variable linear interpolation.

        NaN gaps (samples where a kind was not appended) are skipped per
        variable, so irregularly-logged kinds interpolate over their own
        valid samples. Returns a new TimeSeries (or the (n, len(t_new))
        array when ``kind`` is given)."""
        t_new = np.atleast_1d(np.asarray(t_new, dtype=float))

        def interp_rows(arr):
            out = np.full((arr.shape[0], t_new.shape[0]), np.nan)
            for i in range(arr.shape[0]):
                ok = np.isfinite(arr[i])
                if ok.sum() >= 2:
                    out[i] = np.interp(t_new, self._time[ok], arr[i, ok])
                elif ok.sum() == 1:
                    out[i] = arr[i, ok][0]
            return out

        if kind is not None:
            return interp_rows(self._data[kind])
        ts = TimeSeries(self.time_unit)
        ts._kinds = {k: list(v) for k, v in self._kinds.items()}
        ts._time = t_new.copy()
        ts._data = {k: interp_rows(v) for k, v in self._data.items()}
        return ts

    def merge(self, other: "TimeSeries", interpolate: bool = False
              ) -> "TimeSeries":
        """Combine two series.

        The result carries the union of kinds; samples are the union of
        both time grids, sorted. Kinds present in only one side are NaN at
        the other side's instants — unless ``interpolate=True``, which fills
        them by linear interpolation over the union grid."""
        out = self.copy()
        for kind, names in other._kinds.items():
            if kind in out._kinds:
                if list(names) != out._kinds[kind]:
                    raise ValueError(
                        f"kind {kind!r} has different variables: "
                        f"{out._kinds[kind]} vs {list(names)}")
            else:
                out._kinds[kind] = list(names)
                out._data[kind] = np.full((len(names), out.n_samples), np.nan)
        n_other = other.n_samples
        out._time = np.concatenate([out._time, other._time])
        for kind in out._kinds:
            pad = (other._data[kind] if kind in other._data
                   else np.full((len(out._kinds[kind]), n_other), np.nan))
            out._data[kind] = np.concatenate([out._data[kind], pad], axis=1)
        out.sort()
        if interpolate:
            filled = out.interpolate(out._time)
            out._data = filled._data
        return out

    def to_mat(self, path: str) -> None:
        """Export to a MATLAB .mat file (SciPy's ``savemat``)."""
        from scipy.io import savemat

        savemat(path, {k.replace(":", "_"): v for k, v in self.to_dict().items()})

    def plot(self, kinds=None, names=None, show: bool = False, save_as=None,
             title=None):
        """Plot through the active backend (matplotlib/bokeh/latex).

        Reference: Series.plot dispatching to the PlotManager backend
        (modules/base.py:3458-3530, plugins/plugins.py)."""
        from ..utils.plotting import plot_series

        return plot_series(self, kinds=kinds, names=names, show=show,
                           save_as=save_as, title=title)


class OptimizationSeries(TimeSeries):
    """TimeSeries specialized for per-solve optimizer telemetry: the ``stats`` kind
    (iterations, kkt_error, extime_ms, converged) is pre-registered, and the
    usual queries are properties. NMPC/MHE solutions use the same stats
    layout, so a plain controller solution can be wrapped via ``adopt``."""

    STAT_NAMES = ["iterations", "kkt_error", "extime_ms", "converged"]

    def __init__(self, time_unit: str = "s"):
        super().__init__(time_unit)
        self.register("stats", list(self.STAT_NAMES))

    @classmethod
    def adopt(cls, ts: TimeSeries) -> "OptimizationSeries":
        out = cls(ts.time_unit)
        out._kinds = {k: list(v) for k, v in ts._kinds.items()}
        out._data = {k: np.array(v) for k, v in ts._data.items()}
        out._time = np.array(ts._time)
        if "stats" not in out._kinds:
            out.register("stats", list(cls.STAT_NAMES))
            out._data["stats"] = np.full((len(cls.STAT_NAMES),
                                          out.n_samples), np.nan)
        return out

    @property
    def iterations(self) -> np.ndarray:
        return self["iterations"].ravel()

    @property
    def kkt_errors(self) -> np.ndarray:
        return self["kkt_error"].ravel()

    @property
    def solve_times_ms(self) -> np.ndarray:
        return self["extime_ms"].ravel()

    @property
    def convergence_rate(self) -> float:
        conv = self["converged"].ravel()
        ok = np.isfinite(conv)
        return float(np.mean(conv[ok])) if ok.any() else float("nan")
