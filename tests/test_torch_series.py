"""PyTorch port: TimeSeries's sort, interpolate, merge and to_mat, and
OptimizationSeries (core/series.py), against the JAX package on the same
data (exact: both are numpy on the host)."""
import numpy as np
import pytest
import scipy.io

from hilo_mpc_tpu.core.series import OptimizationSeries as JaxOptSeries
from hilo_mpc_tpu.core.series import TimeSeries as JaxSeries
from hilo_mpc_tpu_torch import OptimizationSeries, TimeSeries


def _fill(cls, seed=0, n=9, t0=0.0):
    rng = np.random.default_rng(seed)
    ts = cls("s")
    ts.register("x", ["x1", "x2"])
    ts.register("u", ["u"])
    t = t0 + rng.permutation(n) * 0.1
    for k in range(n):
        u = None if k % 3 == 2 else rng.standard_normal(1)
        ts.append(t[k], x=rng.standard_normal(2), u=u)
    return ts


def _same(a, b):
    assert a.kinds == b.kinds and a.time_unit == b.time_unit
    for k in a.kinds:
        assert a.names(k) == b.names(k)
    da, db = a.to_dict(), b.to_dict()
    assert set(da) == set(db)
    for k in da:
        np.testing.assert_array_equal(da[k], db[k])


@pytest.mark.parametrize("by", ["t", "x1", "u"])
def test_sort(by):
    _same(_fill(TimeSeries).sort(by), _fill(JaxSeries).sort(by))


@pytest.mark.parametrize("kind", [None, "x", "u"])
def test_interpolate(kind):
    t_new = np.linspace(-0.05, 0.95, 13)
    a = _fill(TimeSeries).sort().interpolate(t_new, kind=kind)
    b = _fill(JaxSeries).sort().interpolate(t_new, kind=kind)
    if kind is None:
        _same(a, b)
        assert a.n_samples == 13
    else:
        np.testing.assert_array_equal(a, b)


def test_interpolate_single_valid_sample_and_empty():
    """A variable with one valid sample is held constant, one with none
    stays NaN."""
    def one(cls):
        ts = cls()
        ts.register("y", ["y"])
        ts.register("z", ["z"])
        ts.append([0.0, 1.0], y=np.array([[np.nan, 2.0]]))
        return ts.interpolate([0.5, 2.0])

    a = one(TimeSeries)
    _same(a, one(JaxSeries))
    np.testing.assert_array_equal(a["y"], [[2.0, 2.0]])
    assert np.isnan(a["z"]).all()


@pytest.mark.parametrize("interpolate", [False, True])
def test_merge(interpolate):
    def other(cls):
        ts = cls("s")
        ts.register("x", ["x1", "x2"])
        ts.register("y", ["y"])
        rng = np.random.default_rng(5)
        ts.append(np.array([0.05, 0.35, 0.55]), x=rng.standard_normal((2, 3)),
                  y=rng.standard_normal((1, 3)))
        return ts

    a = _fill(TimeSeries).merge(other(TimeSeries), interpolate=interpolate)
    b = _fill(JaxSeries).merge(other(JaxSeries), interpolate=interpolate)
    _same(a, b)
    assert np.all(np.diff(a["t"]) >= 0)


def test_merge_refuses_other_variables():
    a = _fill(TimeSeries)
    b = TimeSeries()
    b.register("x", ["p", "q"])
    with pytest.raises(ValueError, match="different variables"):
        a.merge(b)


def test_to_mat(tmp_path):
    _fill(TimeSeries).to_mat(str(tmp_path / "t.mat"))
    _fill(JaxSeries).to_mat(str(tmp_path / "j.mat"))
    a = scipy.io.loadmat(str(tmp_path / "t.mat"))
    b = scipy.io.loadmat(str(tmp_path / "j.mat"))
    keys = [k for k in a if not k.startswith("__")]
    assert sorted(keys) == sorted(k for k in b if not k.startswith("__"))
    for k in keys:
        np.testing.assert_array_equal(a[k], b[k])


def _stats(cls):
    rng = np.random.default_rng(3)
    ts = cls()
    if "stats" not in ts.kinds:
        ts.register("stats", ["iterations", "kkt_error", "extime_ms", "converged"])
    ts.register("x", ["x"])
    for k in range(6):
        ts.append(0.1 * k, x=[rng.standard_normal()],
                  stats=None if k == 4 else [3 + k, 10.0 ** -(k + 4), 1.5 * k, k != 2])
    return ts


def test_optimization_series():
    a = _stats(OptimizationSeries)
    b = _stats(JaxOptSeries)
    _same(a, b)
    for name in ("iterations", "kkt_errors", "solve_times_ms"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert a.convergence_rate == b.convergence_rate == pytest.approx(0.8)


@pytest.mark.parametrize("with_stats", [True, False])
def test_optimization_series_adopt(with_stats):
    def plain(cls):
        if with_stats:
            return _stats(cls)
        ts = cls()
        ts.register("x", ["x"])
        ts.append([0.0, 0.1], x=np.array([[1.0, 2.0]]))
        return ts

    a = OptimizationSeries.adopt(plain(TimeSeries))
    b = JaxOptSeries.adopt(plain(JaxSeries))
    assert isinstance(a, OptimizationSeries)
    _same(a, b)
    np.testing.assert_array_equal(a.iterations, b.iterations)
    ra, rb = a.convergence_rate, b.convergence_rate
    assert (np.isnan(ra) and np.isnan(rb)) or ra == rb
