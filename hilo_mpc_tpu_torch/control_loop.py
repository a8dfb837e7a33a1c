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
EKF, UKF, PF (``estimate(y=, u=)``).

Not ported yet: the live figure (``live_plot``) and ``plot`` (ROADMAP.md
§A.10).
"""
from __future__ import annotations

import numpy as np

from .core.model import Model
from .core.series import TimeSeries


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported to the PyTorch package yet "
                               f"— ROADMAP.md {item}")


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
        run prepares at the state it observes)."""
        if live_plot:
            raise _not_ported("the live closed-loop figure (live_plot)", "§A.10")
        plant = self._plant
        if plant.solution is None or plant.solution.n_samples == 0:
            raise RuntimeError("set plant initial conditions first "
                               "(plant.set_initial_conditions(x0))")
        if rti and not hasattr(self._controller, "rti_feedback"):
            raise TypeError("rti=True needs a controller with an RTI mode "
                            f"(NMPC); got {type(self._controller).__name__}")
        self._rti = rti
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
        return self.solution

    def plot(self, **kwargs):
        raise _not_ported("plotting", "§A.10")
