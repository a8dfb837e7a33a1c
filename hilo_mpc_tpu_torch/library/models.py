"""Canned literature models.

PyTorch port of ``hilo_mpc_tpu/library/models.py``: the same five published
models — two CSTRs (Schaffner & Zeitz; Seborg et al.), written in the same
equation-string DSL, and two E. coli D1210 bioreactors (Lee & Ramirez 1992)
and one S. cerevisiae fed-batch reactor (Park & Ramirez 1989), written as
batch-first functions (``x[..., i]`` is state i of every scenario) that
return their rows as a list, broadcast to a common batch shape by
``core/model.py:wrap_rhs``.
"""
from __future__ import annotations

import torch

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


def cstr_seborg():
    """Exothermic CSTR with coolant dynamics (Seborg et al., Process Dynamics and
    Control). States C_A, T, T_c; input T_cr; parameters q_0, V, C_Af, k_0, E,
    T_f, DeltaH_r, rho, C_p, UA, tau.
    """
    model = Model(name="CSTR")
    model.set_equations(
        """
        dC_A/dt = q_0/V*(C_Af - C_A(t)) - k_0*exp(-E/(R*T(t)))*C_A(t)
        dT/dt = q_0/V*(T_f - T(t)) - DeltaH_r*k_0/(rho*C_p)*exp(-E/(R*T(t)))*C_A(t) + UA/(V*rho*C_p)*(T_c(t) - T(t))
        dT_c/dt = (T_cr(k) - T_c(t))/tau
        y(k) = C_A(t)
        R = 8.314
        C_A|unit: mol/L
        T|unit: K
        T_c|unit: K
        """
    )
    return model


def _lee_ramirez_rates(S, I):
    """Induced-protein reaction kinetics of Lee & Ramirez (1992)."""
    phi = 0.407 * S / (0.108 + S + (S ** 2) / 14814.0)
    Rfp = phi * (0.0005 + I) / (0.022 + I)
    k = 0.09 * I / (0.034 + I)
    return phi, Rfp, k


def ecoli_D1210_conti(model: str = "simple") -> Model:
    """Continuous culture of recombinant E. coli D1210 (Lee & Ramirez 1992).

    ``simple``: 4 states (X, S, P, I), unknown rates (mu, Rs, Rfp) left as parameters —
    the hybrid-model workhorse. ``complex``: 6 states with full induction kinetics.
    """
    if model == "complex":
        m = Model(name="ecoli_D1210_complex")
        m.set_dynamical_states(["X", "S", "P", "I", "ISF", "IRF"])
        m.set_inputs(["DS", "DI"])
        m.set_parameters(["Sf", "If"])
        m.set_measurements(["mu", "Rs", "Rfp"])

        def rates(x):
            S, I, ISF, IRF = x[..., 1], x[..., 3], x[..., 4], x[..., 5]
            phi, Rfp, k = _lee_ramirez_rates(S, I)
            mu = phi * (ISF + (0.22 * IRF) / (0.22 + I))
            return mu, 2.0 * mu, Rfp, k

        def ode(x, u, p):
            X, S, P, I, ISF, IRF = x.unbind(-1)
            mu, Rs, Rfp, k = rates(x)
            D = u[..., 0] + u[..., 1]
            return [
                mu * X - D * X,
                -Rs * X - D * S + u[..., 0] * p[..., 0],
                Rfp * X - D * P,
                -D * I + u[..., 1] * p[..., 1],
                -k * ISF,
                k * (1.0 - IRF),
            ]

        def meas(x, u, p):
            mu, Rs, Rfp, _ = rates(x)
            return [mu, Rs, Rfp]

        m.set_dynamical_equations(ode)
        m.set_measurement_equations(meas)
        return m

    m = Model(name="ecoli_D1210_conti_simple")
    m.set_dynamical_states(["X", "S", "P", "I"])
    m.set_inputs(["DS", "DI"])
    m.set_parameters(["Sf", "If", "mu", "Rs", "Rfp"])

    def ode(x, u, p):
        X, S, P, I = x.unbind(-1)
        Sf, If, mu, Rs, Rfp = p.unbind(-1)
        D = u[..., 0] + u[..., 1]
        return [
            mu * X - D * X,
            -Rs * X - D * S + u[..., 0] * Sf,
            Rfp * X - D * P,
            -D * I + u[..., 1] * If,
        ]

    m.set_dynamical_equations(ode)
    return m


def ecoli_D1210_fedbatch() -> Model:
    """Fed-batch E. coli D1210 bioreactor, 7 states incl. volume (Lee & Ramirez
    1992). Feed concentrations fixed: Sf=100, If=4."""
    m = Model(name="ecoli_D1210_fedbatch_complex")
    m.set_dynamical_states(["X", "S", "P", "I", "ISF", "IRF", "V"])
    m.set_inputs(["FeedS", "FeedI"])
    Sf, If = 100.0, 4.0

    def ode(x, u):
        X, S, P, I, ISF, IRF, V = x.unbind(-1)
        phi, Rfp, k = _lee_ramirez_rates(S, I)
        mu = phi * (ISF + (0.22 * IRF) / (0.22 + I))
        D = (u[..., 0] + u[..., 1]) / V
        return [
            mu * X - D * X,
            -2.0 * mu * X - D * S + u[..., 0] * Sf / V,
            Rfp * X - D * P,
            -D * I + u[..., 1] * If / V,
            -k * ISF,
            k * (1.0 - IRF),
            u[..., 0] + u[..., 1],
        ]

    m.set_dynamical_equations(ode)
    return m


def scerevisiae_SEY2102_fedbatch() -> Model:
    """Fed-batch S. cerevisiae SEY2102 protein-secretion model (Park & Ramirez
    1989). Feed substrate concentration s0 = 20 g/L."""
    m = Model(name="scerevisiae_SEY2102_fedbatch")
    m.set_dynamical_states(["bio", "s", "pt", "pm", "v"])
    m.set_inputs(["F"])
    s0 = 20.0

    def ode(x, u):
        bio, s, pt, pm, V = x.unbind(-1)
        F = u[..., 0]
        mu = (21.87 * s) / ((s + 0.4) * (s + 62.5))
        fp = (s * torch.exp(-5.0 * s)) / (s + 0.1)
        phi = 4.75 * mu / (0.12 + mu)
        D = F / V
        return [
            mu * bio - D * bio,
            -7.3 * mu * bio - D * (s - s0),
            fp * bio - D * pt,
            phi * (pt - pm) - D * pm,
            F,
        ]

    m.set_dynamical_equations(ode)
    m.set_measurement_equations(lambda x: x)
    return m


__all__ = [
    "cstr_schaffner_and_zeitz",
    "cstr_seborg",
    "ecoli_D1210_conti",
    "ecoli_D1210_fedbatch",
    "scerevisiae_SEY2102_fedbatch",
]
