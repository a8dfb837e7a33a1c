"""Bokeh plot backend: interactive HTML rendering of TimeSeries.

PyTorch port of ``hilo_mpc_tpu/utils/plotting_bokeh.py`` (the same code on
host numpy): one bokeh figure per variable, ``step`` glyphs for inputs, a
linked-x column layout, save-to-HTML and/or show; the MPC prediction view,
a 1-D GP posterior with its quantile band (on the port's
``GaussianProcess``), and the live closed-loop plot. Imports are
function-local, so the module imports without bokeh and the backend gate
(``set_plot_backend('bokeh')``) raises the clear error.

The glyph surface used is small and stable across bokeh 2.x and 3.x:
``figure``, ``fig.line``, ``fig.step``, ``fig.varea``, ``fig.scatter``,
``column``, ``output_file``, ``save``, ``show``, ``ColumnDataSource`` and
``Span``.
"""
from __future__ import annotations

from typing import Optional

__all__ = ["plot_series_bokeh", "plot_prediction_bokeh", "plot_gp_bokeh",
           "LiveBokehLoopPlot"]


def _require_bokeh():
    try:
        from bokeh import io as bio
        from bokeh import plotting as bplt
        from bokeh.layouts import column
    except ImportError as e:  # pragma: no cover - exercised via stub in tests
        raise ImportError(
            "plot backend 'bokeh' requires the bokeh package, which is not "
            "installed; use 'matplotlib' (rendering) or 'latex' (pgfplots "
            "export)") from e
    return bio, bplt, column


def _overlay_panel(fig, np, t, nm, refs=None, bounds=None, predictions=None,
                   bands=None, step=False, what="all"):
    """Draw the shared overlay set on one panel: dashed reference line,
    dotted bounds, prediction overlay and a variance/quantile band —
    the glyph contract of the reference's bokeh plugin
    (reference: hilo_mpc/plugins/bokeh/plot.py:281-355, which draws
    references, bounds, predictions and fill-between variance bands).
    ``what`` picks a phase: 'band' draws only the fill-between (so it can go
    UNDER the data line), 'rest' the line overlays, 'all' everything."""
    if what in ("all", "band") and bands and nm in bands:
        tb, lo, hi = bands[nm]
        tb = np.asarray(tb, dtype=float).ravel()
        fig.varea(x=tb, y1=np.asarray(lo, float).ravel(),
                  y2=np.asarray(hi, float).ravel(), alpha=0.25,
                  legend_label=f"{nm} band")
    if what == "band":
        return
    if refs and nm in refs:
        r = np.asarray(refs[nm], dtype=float).ravel()
        if r.size == 1:
            r = np.full(t.size, r[0])
        fig.line(t[:r.size], r[:t.size], line_dash="dashed", line_width=1.5,
                 legend_label=f"{nm} ref")
    if bounds and nm in bounds:
        lb, ub = bounds[nm]
        for v in (lb, ub):
            if v is not None and np.all(np.isfinite(v)):
                fig.line([t[0], t[-1]], [float(np.asarray(v).ravel()[0])] * 2,
                         line_dash="dotted", line_width=1.5,
                         legend_label=f"{nm} bound")
    if predictions and nm in predictions:
        tp, vp = predictions[nm]
        tp = np.asarray(tp, dtype=float).ravel()
        vp = np.asarray(vp, dtype=float).ravel()
        n = min(tp.size, vp.size)
        if step:
            fig.step(tp[:n], vp[:n], mode="after", line_dash="dashed",
                     line_width=2, legend_label=f"{nm} prediction")
        else:
            fig.line(tp[:n], vp[:n], line_dash="dashed", line_width=2,
                     legend_label=f"{nm} prediction")


def plot_series_bokeh(series, kinds=None, names=None, show: bool = False,
                      save_as=None, title: Optional[str] = None,
                      refs=None, bounds=None, predictions=None, bands=None):
    """Render a TimeSeries with bokeh: one figure per variable, shared x.

    Overlays (all dicts keyed by variable name, optional): ``refs`` —
    setpoint scalar/array drawn dashed; ``bounds`` — (lb, ub) dotted lines;
    ``predictions`` — (t, values) dashed overlay (e.g. the MPC horizon);
    ``bands`` — (t, lo, hi) fill-between variance/quantile band.
    Same contract as the matplotlib backend and the reference bokeh plugin
    (reference: hilo_mpc/plugins/bokeh/plot.py:281-355).

    Returns the bokeh layout object (a ``column`` of figures). With
    ``save_as='file.html'`` the layout is written as a standalone
    interactive HTML document; ``show=True`` opens it in a browser.
    """
    import numpy as np

    from .plotting import _collect_panels

    bio, bplt, column = _require_bokeh()

    t = np.asarray(series["t"], dtype=float)
    panels = _collect_panels(series, kinds, names)
    figs = []
    for kind, nm in panels:
        vals = np.asarray(series[nm], dtype=float).ravel()
        n = min(len(t), len(vals))
        fig = bplt.figure(
            height=180, width=640,
            x_axis_label=f"time [{series.time_unit}]", y_axis_label=nm,
            title=title if (title and not figs) else None)
        # band first so the data line draws on top of the fill
        _overlay_panel(fig, np, t[:n], nm, bands=bands, what="band")
        if kind == "u":
            # piecewise-constant inputs: hold each value to the next sample
            fig.step(t[:n], vals[:n], mode="after", line_width=2,
                     legend_label=nm)
        else:
            fig.line(t[:n], vals[:n], line_width=2, legend_label=nm)
        _overlay_panel(fig, np, t[:n], nm, refs=refs, bounds=bounds,
                       predictions=predictions, step=(kind == "u"),
                       what="rest")
        if figs:  # link the x ranges so panning stays aligned
            fig.x_range = figs[0].x_range
        figs.append(fig)
    layout = column(figs)
    if save_as:
        bio.output_file(str(save_as), title=title or "hilo_mpc_tpu_torch")
        bio.save(layout)
    if show:  # pragma: no cover - needs a browser
        bio.show(layout)
    return layout


def plot_prediction_bokeh(prediction, x_names, u_names, extras=None,
                          extras_names=None, refs=None, bounds=None,
                          save_as=None, title=None, time_unit="h"):
    """Bokeh rendering of an MPC horizon prediction with the same
    extras/refs/bounds overlay contract as ``NMPC.plot_prediction``
    (reference: plot_prediction, mpc.py:868-1024 — bokeh there too)."""
    import numpy as np

    bio, bplt, column = _require_bokeh()
    t = np.asarray(prediction["t"], dtype=float)
    extras = extras or {}
    keys = list(extras)
    extras_names = list(extras_names or [])
    extras_names += keys[len(extras_names):]
    figs = []
    X = np.asarray(prediction["x"], dtype=float)
    U = np.asarray(prediction["u"], dtype=float)
    for i, nm in enumerate(list(x_names) + list(u_names)):
        is_u = i >= len(x_names)
        fig = bplt.figure(height=200, width=640,
                          x_axis_label=f"time [{time_unit}]",
                          y_axis_label=nm,
                          title=title if (title and not figs) else None)
        if is_u:
            u = U[:, i - len(x_names)]
            fig.step(t[:u.size], u, mode="after", line_width=2,
                     legend_label="prediction")
        else:
            fig.line(t, X[:, i], line_width=2, legend_label="prediction")
        if nm in extras:
            e = np.asarray(extras[nm], dtype=float).ravel()
            lbl = extras_names[keys.index(nm)]
            if is_u:
                fig.step(t[:e.size], e, mode="after", line_dash="dashed",
                         line_width=2, legend_label=lbl)
            else:
                fig.line(t[:e.size], e, line_dash="dashed", line_width=2,
                         legend_label=lbl)
        _overlay_panel(fig, np, t, nm, refs=refs, bounds=bounds)
        if figs:
            fig.x_range = figs[0].x_range
        figs.append(fig)
    layout = column(figs)
    if save_as:
        bio.output_file(str(save_as), title=title or "mpc prediction")
        bio.save(layout)
    return layout


def plot_gp_bokeh(gp, X_query, quantiles=(0.025, 0.975), save_as=None,
                  title=None, n_samples=0):
    """GP posterior plot: mean line + quantile fill-between band (varea) and
    the training points — the reference bokeh plugin's GP view
    (reference: hilo_mpc/plugins/bokeh/plot.py fill-between variance bands).
    1-D inputs only (the band is a function of a scalar abscissa)."""
    import numpy as np

    bio, bplt, column = _require_bokeh()
    Xq = np.asarray(X_query, dtype=float)
    if Xq.ndim == 1:
        Xq = Xq[:, None]
    if Xq.shape[1] != 1:
        raise ValueError("plot_gp_bokeh draws 1-D GPs "
                         f"(got {Xq.shape[1]} input dims)")
    mu, _ = gp.predict(Xq)
    lo, hi = gp.predict_quantiles(Xq, quantiles=quantiles)
    x = Xq.ravel()
    fig = bplt.figure(height=320, width=640, title=title,
                      x_axis_label="x", y_axis_label="f(x)")
    fig.varea(x=x, y1=np.asarray(lo, float).ravel(),
              y2=np.asarray(hi, float).ravel(), alpha=0.25,
              legend_label=f"{quantiles} band")
    fig.line(x, np.asarray(mu, float).ravel(), line_width=2,
             legend_label="mean")
    Xt = getattr(gp, "X_train", None)
    yt = getattr(gp, "y_train", None)
    if Xt is not None and yt is not None:
        fig.scatter(np.asarray(Xt, float).ravel(),
                    np.asarray(yt, float).ravel(), size=6,
                    legend_label="observations")
    layout = column([fig])
    if save_as:
        bio.output_file(str(save_as), title=title or "gp posterior")
        bio.save(layout)
    return layout


class LiveBokehLoopPlot:
    """Live closed-loop animation on the bokeh backend.

    Bokeh-side analogue of the reference's live loop animation
    (reference: hilo_mpc/modules/control_loop.py:202-285, where a bokeh
    server pushes ColumnDataSource updates from a periodic callback).
    Two delivery modes:

    - ``mode='save'`` (default, headless-safe): each ``update()`` streams the
      newest samples into per-panel ``ColumnDataSource``s and re-saves a
      standalone HTML document whose ``<meta http-equiv="refresh">`` header
      makes any open browser tab poll the file — a serverless equivalent of
      the reference's push loop.
    - ``mode='server'``: a ``bokeh.server.server.Server`` app owns the
      figures; ``update()`` enqueues the new samples and a periodic callback
      inside the bokeh document streams them (the reference's architecture).
      The tornado IOLoop runs on a daemon thread so the control loop stays in
      the caller's thread.

    The data path is ``source.stream(new_rows)`` in both modes, so panels
    grow incrementally instead of being redrawn.
    """

    def __init__(self, series, save_as="live_loop.html", mode: str = "save",
                 refresh_s: float = 1.0, port: int = 5006, kinds=None,
                 refs=None, bounds=None):
        import numpy as np

        from .plotting import _collect_panels

        bio, bplt, column = _require_bokeh()
        from bokeh.models import ColumnDataSource, Span

        if mode not in ("save", "server"):
            raise ValueError(f"unknown live-plot mode {mode!r} "
                             "(expected 'save' or 'server')")
        self._np = np
        self._bio, self._bplt, self._column = bio, bplt, column
        self._series = series
        self._save_as = str(save_as)
        self._mode = mode
        self._refresh_s = float(refresh_s)
        self._n_sent = None  # per-panel samples already streamed
        self.n_draws = 0

        self._panels = _collect_panels(series, kinds, None)
        self._sources, figs = [], []
        for kind, nm in self._panels:
            src = ColumnDataSource(data={"t": [], "v": []})
            fig = bplt.figure(height=180, width=640,
                              x_axis_label=f"time [{series.time_unit}]",
                              y_axis_label=nm)
            if kind == "u":
                fig.step("t", "v", source=src, mode="after", line_width=2)
            else:
                fig.line("t", "v", source=src, line_width=2)
            # static overlays as Span annotations (x-extent-free, so they
            # need no redraw as the stream grows) — the live analogue of the
            # reference's reference/bound overlays (bokeh/plot.py:281-355)
            if refs and nm in refs:
                fig.add_layout(Span(
                    location=float(np.asarray(refs[nm]).ravel()[0]),
                    dimension="width", line_dash="dashed", line_width=1.5))
            if bounds and nm in bounds:
                for v in bounds[nm]:
                    if v is not None and np.all(np.isfinite(v)):
                        fig.add_layout(Span(
                            location=float(np.asarray(v).ravel()[0]),
                            dimension="width", line_dash="dotted",
                            line_width=1.5))
            if figs:
                fig.x_range = figs[0].x_range
            self._sources.append(src)
            figs.append(fig)
        self._figs = figs
        self.layout = column(figs)
        if mode == "server":  # pragma: no cover - needs bokeh+tornado
            self._start_server(port)

    # -- data path ---------------------------------------------------------
    def _new_rows(self):
        np = self._np
        t = np.asarray(self._series["t"], dtype=float).ravel()
        if self._n_sent is None:
            self._n_sent = [0] * len(self._panels)
        rows = []
        # panels may grow at different rates (a series appended less often);
        # a per-panel sent counter keeps each stream gapless and duplicate-free
        for j, (kind, nm) in enumerate(self._panels):
            v = np.asarray(self._series[nm], dtype=float).ravel()
            lo = self._n_sent[j]
            hi = min(len(t), len(v))
            rows.append({"t": list(t[lo:hi]), "v": list(v[lo:hi])})
            self._n_sent[j] = max(lo, hi)
        return rows

    def update(self):
        rows = self._new_rows()
        if self._mode == "server":  # pragma: no cover - needs bokeh+tornado
            self._queue.put(rows)
        else:
            for src, new in zip(self._sources, rows):
                if new["t"]:
                    src.stream(new)
            self._save_html()
        self.n_draws += 1

    def _save_html(self):
        self._bio.output_file(self._save_as, title="hilo_mpc_tpu_torch live loop")
        self._bio.save(self.layout)
        self._inject_refresh()

    def _inject_refresh(self):
        # standalone bokeh documents are static; an http-refresh header turns
        # the saved file into a polling live view (serverless push analogue)
        try:
            with open(self._save_as, "r+", encoding="utf-8") as fh:
                html = fh.read()
                tag = f'<meta http-equiv="refresh" content="{self._refresh_s}">'
                if tag not in html and "<head>" in html:
                    fh.seek(0)
                    fh.write(html.replace("<head>", "<head>\n  " + tag, 1))
                    fh.truncate()
        except OSError:  # stubbed save may not create a real file
            pass

    # -- server mode -------------------------------------------------------
    def _start_server(self, port):  # pragma: no cover - needs bokeh+tornado
        import queue
        import threading

        from bokeh.server.server import Server

        self._queue = queue.Queue()

        def app(doc):
            doc.add_root(self.layout)

            def tick():
                try:
                    while True:
                        rows = self._queue.get_nowait()
                        for src, new in zip(self._sources, rows):
                            if new["t"]:
                                src.stream(new)
                except queue.Empty:
                    pass

            doc.add_periodic_callback(tick, max(50, int(self._refresh_s * 1e3)))

        self._server = Server({"/": app}, port=port, num_procs=1)
        self._server.start()
        self._thread = threading.Thread(target=self._server.io_loop.start,
                                        daemon=True)
        self._thread.start()

    def finish(self):
        if self._mode == "save":
            self._save_html()
        else:  # pragma: no cover - needs bokeh+tornado
            self._server.io_loop.add_callback(self._server.io_loop.stop)
