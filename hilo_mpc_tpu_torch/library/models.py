"""Canned literature models.

PyTorch port of ``hilo_mpc_tpu/library/models.py``: the Schaffner & Zeitz CSTR,
written in the same equation-string DSL. The other library models follow with
their slices.
"""
from __future__ import annotations

from ..core.model import Model


def cstr_schaffner_and_zeitz():
    """Van-de-Vusse-type CSTR of Schaffner & Zeitz.

    States x_1, x_2; input u; parameters a_1, b_1, a_2, b_2, g, E; measurement y = x_2;
    reaction rate r = (1 - x_1) exp(-E / (1 + x_2)).
    """
    model = Model(name="CSTR")
    model.set_equations(
        """
        dx_1/dt = -a_1*x_1(t) + b_1*r
        dx_2/dt = -a_2*x_2(t) + b_2*r + g*u(k)
        y(k) = x_2(t)
        r = (1 - x_1(t))*exp(-E/(1 + x_2(t)))
        """
    )
    return model
