"""PyTorch port: plotting (utils/plotting.py, utils/plotting_bokeh.py,
``TimeSeries.plot``, ``NMPC.print_stats`` / ``plot_prediction`` /
``plot_iterations``, ``SimpleControlLoop.run(live_plot=)`` / ``plot``),
held against the JAX package's figures on the same data: the line data of
every matplotlib axis (exact where the data are the same numpy arrays,
1e-9 where each package simulated its own plant), every glyph a stub of
bokeh records (tests/test_plotting_bokeh.py's stub, as bokeh is not
installed), the pgfplots text byte for byte and ``print_stats``' output
character for character."""
import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import hilo_mpc_tpu as jx  # noqa: E402
from hilo_mpc_tpu.control_loop import _make_live_plotter as jax_live  # noqa: E402
from hilo_mpc_tpu.utils import plotting as jplot  # noqa: E402
from hilo_mpc_tpu.utils import plotting_bokeh as jbok  # noqa: E402
from hilo_mpc_tpu_torch import (NMPC, GaussianProcess, Model,  # noqa: E402
                                SimpleControlLoop, TimeSeries, get_plot_backend,
                                set_plot_backend)
from hilo_mpc_tpu_torch.control_loop import _make_live_plotter  # noqa: E402
from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz  # noqa: E402
from hilo_mpc_tpu_torch.utils import plotting as tplot  # noqa: E402
from hilo_mpc_tpu_torch.utils import plotting_bokeh as tbok  # noqa: E402

from test_plotting_bokeh import stub_bokeh  # noqa: E402,F401

CPU, F64 = "cpu", torch.float64


def _series(cls, seed=0, n=12):
    rng = np.random.default_rng(seed)
    ts = cls("h")
    ts.register("x", ["x_0", "x_1"])
    ts.register("u", ["u"])
    for k in range(n):
        ts.append(0.1 * k, x=rng.standard_normal(2), u=rng.standard_normal(1))
    return ts


def _lines(fig):
    """Each axis's label and the data of its lines and step/hline artists."""
    return [(ax.get_ylabel(), [np.asarray(line.get_xydata()) for line in ax.get_lines()])
            for ax in fig.axes]


def _same_figs(a, b, atol=0.0):
    la, lb = _lines(a), _lines(b)
    assert [x[0] for x in la] == [x[0] for x in lb]
    for (_, da), (_, db) in zip(la, lb):
        assert len(da) == len(db)
        for u, v in zip(da, db):
            np.testing.assert_allclose(u, v, rtol=0, atol=atol)
    plt.close(a)
    plt.close(b)


@pytest.mark.parametrize("kw", [{}, dict(kinds=["u"]), dict(names=["x_1", "u"],
                                                             title="run")])
def test_plot_series_and_timeseries_plot(kw):
    _same_figs(tplot.plot_series(_series(TimeSeries), **kw),
               jplot.plot_series(_series(jx.TimeSeries), **kw))
    _same_figs(_series(TimeSeries).plot(**kw), _series(jx.TimeSeries).plot(**kw))


@pytest.mark.parametrize("standalone", [True, False])
def test_to_pgfplots_byte_identical(tmp_path, standalone):
    a = tplot.to_pgfplots(_series(TimeSeries), tmp_path / "a.tex", title="A_1 & b",
                          standalone=standalone)
    b = jplot.to_pgfplots(_series(jx.TimeSeries), tmp_path / "b.tex", title="A_1 & b",
                          standalone=standalone)
    assert a == b
    assert (tmp_path / "a.tex").read_bytes() == (tmp_path / "b.tex").read_bytes()


def test_backend_switch_and_latex_dispatch(tmp_path):
    prev = get_plot_backend()
    try:
        with pytest.raises(ValueError, match="unknown plot backend"):
            set_plot_backend("svg")
        set_plot_backend("latex")
        assert get_plot_backend() == "latex"
        assert _series(TimeSeries).plot(save_as=str(tmp_path / "s.tex")) is None
        assert (tmp_path / "s.tex").read_text().startswith("\\documentclass")
        with pytest.raises(ValueError, match="save_as"):
            _series(TimeSeries).plot()
    finally:
        set_plot_backend(prev)


def _controllers():
    """An unsolved port and JAX controller of the CSTR, given the same
    prediction, iterate history and recorded stats."""
    rng = np.random.default_rng(4)
    pred = {"t": 0.1 * np.arange(6), "x": rng.standard_normal((6, 2)),
            "u": rng.standard_normal((5, 1))}
    hist = {"n": 7, "kkt": np.abs(rng.standard_normal(10)) * 1e-3,
            "mu": np.logspace(-1, -8, 10), "U": rng.standard_normal((10, 5, 1)),
            "X": rng.standard_normal((10, 6, 2)), "objective": rng.standard_normal(10)}
    stats = rng.uniform(0.0, 10.0, (4, 9))
    stats[3] = rng.integers(0, 2, 9)
    out = []
    for nm, lib in ((NMPC, cstr_schaffner_and_zeitz), (jx.NMPC, None)):
        if lib is None:
            from hilo_mpc_tpu.library import cstr_schaffner_and_zeitz as lib
        n = nm(lib())
        n.last_prediction = dict(pred)
        n.iteration_history = dict(hist)
        n.solution = (TimeSeries if nm is NMPC else jx.TimeSeries)("h")
        n.solution.register("stats", ["iterations", "kkt_error", "extime_ms", "converged"])
        n.solution.append(np.arange(9) * 0.1, stats=stats)
        out.append(n)
    return out


@pytest.mark.parametrize("extras", [None, {"x_1": np.full(6, 0.3), "u": np.zeros(5)}])
def test_plot_prediction(extras):
    port, jax_nmpc = _controllers()
    kw = dict(extras=extras, extras_names=["measured"] if extras else None, title="p")
    _same_figs(port.plot_prediction(**kw), jax_nmpc.plot_prediction(**kw))


def test_plot_iterations_and_print_stats(capsys):
    port, jax_nmpc = _controllers()
    _same_figs(port.plot_iterations(), jax_nmpc.plot_iterations())
    port.print_stats()
    ours = capsys.readouterr().out
    jax_nmpc.print_stats()
    assert ours == capsys.readouterr().out and ours.startswith("solves: 9")
    port.solution = None
    port.print_stats()
    assert capsys.readouterr().out == "no recorded solves\n"
    port.iteration_history = None
    with pytest.raises(RuntimeError, match="ipopt_debugger"):
        port.plot_iterations()


def _loop(jax_side, live=None, **kw):
    m = (jx.Model if jax_side else Model)()
    m.set_inputs("u")
    m.set_equations("dx/dt = -x + u")
    if jax_side:
        m._dtype = np.float64       # JAX's plants default to float32
    m.setup(dt=0.1, **({} if jax_side else dict(device=CPU, dtype=F64)))
    m.set_initial_conditions([1.0])
    loop = (jx.SimpleControlLoop if jax_side else SimpleControlLoop)(
        m, lambda x: -0.5 * np.asarray(x))
    loop.run(6, live_plot=live, live_plot_kwargs=kw or None)
    return loop


def test_control_loop_plot_and_live_plot():
    """``plot`` and the live matplotlib figure (its redraws and its
    reference and bound overlays) against JAX's on the same closed loop."""
    a, b = _loop(False), _loop(True)
    _same_figs(a.plot(), b.plot(), atol=1e-9)
    kw = dict(refs={"x": 0.2}, bounds={"u": (-1.0, 1.0)})
    a = _make_live_plotter(_loop(False).solution, True, **kw)
    b = jax_live(_loop(True).solution, True, **kw)
    for p in (a, b):
        p.update()
        p.update()
        p.finish()
    assert a.n_draws == b.n_draws == 2
    _same_figs(a.fig, b.fig, atol=1e-9)


def test_unknown_live_kwargs_warn_as_jax():
    with pytest.warns(UserWarning) as ours:
        p = _make_live_plotter(_series(TimeSeries), "matplotlib", mode="server")
    with pytest.warns(UserWarning) as theirs:
        q = jax_live(_series(jx.TimeSeries), "matplotlib", mode="server")
    assert str(ours[0].message) == str(theirs[0].message)
    plt.close(p.fig)
    plt.close(q.fig)


def _glyphs(rec):
    """The recorded figures: kwargs and each glyph's kind, data, options."""
    def opts(kw):   # a live glyph's data source is an object of its own
        return {k: (v.data if k == "source" else v) for k, v in kw.items()}

    out = [(f.kwargs, [(c[0], c[1], c[2], opts(c[3])) for c in f.calls],
            [s.kw for s in f.layouts]) for f in rec["figs"]]
    rec["figs"].clear()
    return out


def _same_glyphs(a, b, atol=0.0):
    assert len(a) == len(b)
    for (ka, ca, la), (kb, cb, lb) in zip(a, b):
        assert ka == kb and la == lb and len(ca) == len(cb)
        for (ga, xa, ya, oa), (gb, xb, yb, ob) in zip(ca, cb):
            assert ga == gb and oa == ob
            if isinstance(xa, str):
                assert (xa, ya) == (xb, yb)
                continue
            np.testing.assert_allclose(np.asarray(xa, float), np.asarray(xb, float),
                                       atol=atol)
            np.testing.assert_allclose(np.asarray(ya, float), np.asarray(yb, float),
                                       atol=atol)


def test_bokeh_series_prediction_and_overlays(stub_bokeh):  # noqa: F811
    s, js = _series(TimeSeries), _series(jx.TimeSeries)
    t = np.asarray(s["t"])
    over = dict(refs={"x_0": 0.5}, bounds={"u": (-1.0, 1.0)},
                predictions={"x_0": (t[-5:] + 0.1, np.linspace(0.5, 0.6, 5))},
                bands={"x_1": (t, np.zeros(t.size), np.full(t.size, 0.1))})
    tbok.plot_series_bokeh(s, title="loop", **over)
    ours = _glyphs(stub_bokeh)
    jbok.plot_series_bokeh(js, title="loop", **over)
    _same_glyphs(ours, _glyphs(stub_bokeh))
    port, jax_nmpc = _controllers()
    prev = get_plot_backend()
    set_plot_backend("bokeh")
    jplot.set_plot_backend("bokeh")
    try:
        port.plot_prediction(extras={"x_0": np.full(6, 0.3)}, extras_names=["m"])
        ours = _glyphs(stub_bokeh)
        jax_nmpc.plot_prediction(extras={"x_0": np.full(6, 0.3)}, extras_names=["m"])
        _same_glyphs(ours, _glyphs(stub_bokeh))
    finally:
        set_plot_backend(prev)
        jplot.set_plot_backend("matplotlib")


def test_bokeh_gp_band(stub_bokeh):  # noqa: F811
    """The GP view: the port's GaussianProcess against JAX's on the same
    data and hyperparameters (band, mean, observations to 1e-8)."""
    rng = np.random.default_rng(0)
    X = np.linspace(0, 3, 12)[:, None]
    y = np.sin(X[:, 0]) + 0.05 * rng.standard_normal(12)
    gp = GaussianProcess(["x"], ["y"], device=CPU, dtype=F64)
    gp.set_training_data(X, y)
    gp.setup()
    jgp = jx.GaussianProcess(["x"], ["y"])
    jgp.set_training_data(X, y)
    jgp.setup()
    tbok.plot_gp_bokeh(gp, np.linspace(0, 3, 30), title="gp")
    ours = _glyphs(stub_bokeh)
    jbok.plot_gp_bokeh(jgp, np.linspace(0, 3, 30), title="gp")
    _same_glyphs(ours, _glyphs(stub_bokeh), atol=1e-8)
    with pytest.raises(ValueError, match="1-D"):
        tbok.plot_gp_bokeh(gp, np.zeros((4, 2)))


def test_bokeh_live_loop(stub_bokeh, tmp_path):  # noqa: F811
    """The live bokeh plot streams the same rows as JAX's, its span
    overlays equal; the loop dispatches to it."""
    kw = dict(refs={"x_0": 0.5}, bounds={"u": (-1.0, 1.0)}, refresh_s=0.5)
    lives = []
    for mod, cls, name in ((tbok, TimeSeries, "a.html"), (jbok, jx.TimeSeries, "b.html")):
        s = _series(cls)
        live = mod.LiveBokehLoopPlot(s, save_as=tmp_path / name, **kw)
        live.update()
        s.append([1.2, 1.3], x=np.array([[0.3, 0.2], [0.1, 0.0]]), u=np.array([[0.5, 0.5]]))
        live.update()
        live.finish()
        lives.append((live, _glyphs(stub_bokeh)))
    (a, ga), (b, gb) = lives
    _same_glyphs(ga, gb)
    assert a.n_draws == b.n_draws == 2
    for sa, sb in zip(a._sources, b._sources):
        assert sa.streamed == sb.streamed
    assert (tmp_path / "a.html").read_text() == (tmp_path / "b.html").read_text()
    loop = _loop(False, live="bokeh", save_as=str(tmp_path / "live.html"))
    assert (tmp_path / "live.html").exists() and loop.solution.n_samples == 6
