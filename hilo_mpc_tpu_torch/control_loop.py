"""Closed-loop orchestration of plant, controller and observer.

PyTorch port of ``hilo_mpc_tpu/control_loop.py``: ``SimpleControlLoop``
steps the plant (a set-up ``Model``) with the controller's move and feeds
the observer's estimate, or else the true state, back. Controllers: NMPC,
LMPC and OCP (``optimize``, or NMPC's real-time iteration with
``run(rti=True)``), PID and LQR (``optimize``/``call``), a trained ANN or GP
(``predict`` on the whole plant state, a policy; a GP acts by its posterior
mean), or any callable.
The controller sees the plant states its own model names (a name-based
index map); with other names it sees the whole state. Observers: MHE, KF,
EKF, UKF, PF (``estimate(y=, u=)``). ``run(live_plot=...)`` redraws a live
figure after every step (matplotlib, or bokeh through
utils/plotting_bokeh.py) and ``plot`` draws the recorded loop
(utils/plotting.py).
"""
from __future__ import annotations

import numpy as np

from .core.model import Model
from .core.series import TimeSeries


class _LiveLoopPlot:
    """Incremental closed-loop figure, redrawn after every step.

    Matplotlib analogue of the reference's live animation
    (reference: control_loop.py:202-285 — bokeh periodic-callback server /
    mpl animation). One panel per plant state/input; lines are updated in
    place and the canvas flushed with a short ``plt.pause`` so the figure
    animates in interactive backends and is a no-op-safe redraw under Agg.
    """

    def __init__(self, solution, pause: float = 1e-3, refs=None, bounds=None):
        import matplotlib.pyplot as plt

        self._plt = plt
        self._solution = solution
        self._pause = pause
        panels = [("x", nm, i) for i, nm in enumerate(solution.names("x"))]
        panels += [("u", nm, i) for i, nm in enumerate(solution.names("u"))]
        self._panels = panels
        was_interactive = plt.isinteractive()
        plt.ion()
        self._was_interactive = was_interactive
        self.fig, axes = plt.subplots(len(panels), 1, sharex=True,
                                      figsize=(8, 2.0 * len(panels)),
                                      squeeze=False)
        self._axes = axes.ravel()
        self._lines = []
        for ax, (kind, nm, _) in zip(self._axes, panels):
            style = dict(drawstyle="steps-post") if kind == "u" else {}
            (line,) = ax.plot([], [], "-o", ms=3, **style)
            ax.set_ylabel(nm)
            # static overlays, same contract as the bokeh live backend
            if refs and nm in refs:
                ax.axhline(float(np.asarray(refs[nm]).ravel()[0]),
                           ls="--", lw=1.2, color="tab:green")
            if bounds and nm in bounds:
                for v in bounds[nm]:
                    if v is not None and np.all(np.isfinite(v)):
                        ax.axhline(float(np.asarray(v).ravel()[0]),
                                   ls=":", lw=1.2, color="tab:red")
            self._lines.append(line)
        self._axes[-1].set_xlabel("t")
        self.n_draws = 0

    def update(self):
        t = np.asarray(self._solution["t"]).ravel()
        for line, ax, (kind, nm, i) in zip(self._lines, self._axes,
                                           self._panels):
            ys = np.asarray(self._solution[kind])[i]
            line.set_data(t[: ys.size], ys)
            ax.relim()
            ax.autoscale_view()
        self.fig.canvas.draw_idle()
        self._plt.pause(self._pause)
        self.n_draws += 1

    def finish(self):
        if not self._was_interactive:
            self._plt.ioff()


def _make_live_plotter(solution, live_plot, **kwargs):
    """Live-plot dispatch: ``True`` follows the active plot backend; the
    strings 'matplotlib' / 'bokeh' select explicitly (reference: the loop
    animation honors the selected plot plugin, control_loop.py:202-285)."""
    if not live_plot:
        return None
    from .utils.plotting import get_plot_backend

    backend = (live_plot if isinstance(live_plot, str)
               else (get_plot_backend() or "matplotlib"))
    if backend == "bokeh":
        from .utils.plotting_bokeh import LiveBokehLoopPlot

        return LiveBokehLoopPlot(solution, **kwargs)
    mpl_kwargs = {k: kwargs.pop(k) for k in ("refs", "bounds", "pause")
                  if k in kwargs}
    if kwargs:
        import warnings

        warnings.warn(
            "these live_plot_kwargs are only used by the bokeh live "
            f"backend; ignored on matplotlib: {sorted(kwargs)}", stacklevel=3)
    return _LiveLoopPlot(solution, **mpl_kwargs)


class SimpleControlLoop:
    def __init__(self, plant: Model, controller, observer=None):
        if not plant.is_setup():
            raise RuntimeError("plant must be set up (plant.setup(dt=...)) before "
                               "building the loop")
        self._plant = plant
        self._controller = controller
        self._observer = observer
        self._rti = False
        self._rti_skipped_prepare = False

        # name-based mapping: controller model states -> plant state indices
        self._ctrl_idx = None
        ctrl_model = getattr(controller, "_model", None)
        if ctrl_model is not None and hasattr(ctrl_model, "dynamical_states"):
            plant_states = plant.dynamical_states
            try:
                self._ctrl_idx = [plant_states.index(n)
                                  for n in ctrl_model.dynamical_states]
            except ValueError:
                self._ctrl_idx = None  # different naming: pass the full state
        self.solution = TimeSeries(plant.time_unit)
        self.solution.register("x", plant.dynamical_states)
        self.solution.register("u", plant.inputs)
        self.solution.register("y", plant.measurements)

    def _control(self, x0, last=False, **kwargs):
        c = self._controller
        x_c = x0 if self._ctrl_idx is None else x0[self._ctrl_idx]
        if self._rti:
            if c._rti is None or self._rti_skipped_prepare:
                c.rti_prepare(x_pred=x_c, **kwargs)
                self._rti_skipped_prepare = False
            u = np.atleast_1d(np.asarray(c.rti_feedback(x_c)))
            if last:
                # the trailing solve-ahead would be discarded; a later run()
                # prepares again at the state it observes
                self._rti_skipped_prepare = True
            else:
                c.rti_prepare(**kwargs)   # solve ahead while the plant moves
            return u
        if hasattr(c, "optimize"):
            return np.atleast_1d(np.asarray(c.optimize(x_c, **kwargs)))
        if hasattr(c, "call"):
            return np.atleast_1d(np.asarray(c.call(x0)))
        if hasattr(c, "predict"):
            # a trained policy (an ANN, or a GP: its mean), on the whole
            # plant state
            out = np.asarray(c.predict(np.atleast_2d(x0)))
            return np.atleast_1d(out[0] if out.ndim > 1 else out)
        if callable(c):
            return np.atleast_1d(np.asarray(c(x0)))
        raise TypeError(f"unsupported controller {type(c).__name__}")

    def run(self, steps: int, p=None, live_plot=False, live_plot_kwargs=None,
            rti: bool = False, **kwargs):
        """Run the closed loop for ``steps`` steps. Extra kwargs (e.g.
        ref_sc / ref_tc set-point dicts) go to the controller's optimize
        call each step. ``rti=True`` drives an NMPC by real-time iteration:
        each step answers the state with ``rti_feedback`` and then prepares
        the next step ahead (the last step skips that prepare, and the next
        run prepares at the state it observes).

        ``live_plot=True`` redraws the loop after every step on the active
        plot backend: matplotlib (in-place figure updates) or bokeh
        (ColumnDataSource streaming into a saved auto-refreshing HTML
        document, or a bokeh server app with ``live_plot_kwargs=
        {'mode': 'server'}``); the strings ``'matplotlib'`` / ``'bokeh'``
        select a backend explicitly. With bokeh selected but not installed
        this raises the backend gate's ImportError."""
        plant = self._plant
        if plant.solution is None or plant.solution.n_samples == 0:
            raise RuntimeError("set plant initial conditions first "
                               "(plant.set_initial_conditions(x0))")
        if rti and not hasattr(self._controller, "rti_feedback"):
            raise TypeError("rti=True needs a controller with an RTI mode "
                            f"(NMPC); got {type(self._controller).__name__}")
        self._rti = rti
        plotter = _make_live_plotter(self.solution, live_plot,
                                     **(live_plot_kwargs or {}))
        x0 = plant.solution["x:f"]
        for k in range(steps):
            u = self._control(x0, last=(k == steps - 1), **kwargs)
            out = plant.simulate(u=u, p=p, steps=1)
            x_true = out["x"][-1]
            y = out["y"][-1]
            x0 = x_true
            if self._observer is not None:
                est = self._observer.estimate(y=y, u=u)
                if isinstance(est, tuple):
                    est = est[0]
                if est is not None:
                    x0 = np.atleast_1d(np.asarray(est))
            self.solution.append(plant.solution["t"][-1], x=x_true, u=u, y=y)
            if plotter is not None:
                plotter.update()
        if plotter is not None:
            plotter.finish()
        return self.solution

    def plot(self, **kwargs):
        from .utils.plotting import plot_series

        return plot_series(self.solution, **kwargs)
