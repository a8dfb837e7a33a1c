"""The test model of the whole-solve kernel's wide row masks: a chain of 8
unit masses on springs with a cubic stiffening term and damping, the first
tied to a wall, the force entering at the last mass through a first-order
actuator lag. States p_1..p_8, v_1..v_8, F (nx = 17), input u (nu = 1):
36 candidate box rows per stage and 34 at the terminal stage, so both row
masks cross the 32-bit word boundary. Written in the equation DSL, so the
JAX package and the port build it from the same text; chip_smoke.py keeps
its own copy."""
import numpy as np

N_MASS = 8
K_LIN, K_CUBIC, DAMP, TAU = 1.0, 0.5, 0.2, 0.5
# lower bounds on v_5..v_8 (states 12..15): stage rows 31, 32 are those of
# v_5, v_6 and terminal rows 31, 32 those of v_7, v_8
V_MIN = -0.08
U_MAX = 1.0
# the positions the cost pulls the chain to, all masses moved left, and
# the stage cost's weights on the positions, velocities and input
P_REF = -0.3
W_P, W_V, W_U = 1.0, 1.0, 10.0
# the sampling time the tests and chip_smoke.py use
DT = 0.5


def chain_equations() -> str:
    lines = []
    for i in range(1, N_MASS + 1):
        p_prev = f"p_{i - 1}(t)" if i > 1 else "0"
        v_prev = f"v_{i - 1}(t)" if i > 1 else "0"
        lines.append(f"d_{i} = p_{i}(t) - {p_prev}")
        lines.append(f"s_{i} = {K_LIN}*d_{i} + {K_CUBIC}*d_{i}**3 + "
                     f"{DAMP}*(v_{i}(t) - {v_prev})")
    for i in range(1, N_MASS + 1):
        lines.append(f"dp_{i}/dt = v_{i}(t)")
    for i in range(1, N_MASS):
        lines.append(f"dv_{i}/dt = s_{i + 1} - s_{i}")
    lines.append(f"dv_{N_MASS}/dt = F(t) - s_{N_MASS}")
    lines.append(f"dF/dt = (u(k) - F(t))/{TAU}")
    return "\n".join(lines)


def chain_bounds():
    """(x_lb, x_ub, u_lb, u_ub): |u| <= U_MAX, |F| <= U_MAX, v_5..v_8 >=
    V_MIN, the rest free."""
    nx = 2 * N_MASS + 1
    x_lb, x_ub = np.full(nx, -np.inf), np.full(nx, np.inf)
    x_lb[N_MASS + 4:2 * N_MASS] = V_MIN
    x_lb[-1], x_ub[-1] = -U_MAX, U_MAX
    return x_lb, x_ub, [-U_MAX], [U_MAX]


def chain_x0s(B, seed=0):
    """Initial states near rest: positions and velocities spread by 0.02
    and 0.01 (velocities kept above V_MIN / 2), F = 0. The cost pulls every
    mass to P_REF, faster than the velocity bounds allow."""
    rng = np.random.default_rng(seed)
    p = 0.02 * rng.standard_normal((B, N_MASS))
    v = np.maximum(0.01 * rng.standard_normal((B, N_MASS)), V_MIN / 2)
    return np.concatenate([p, v, np.zeros((B, 1))], axis=1)
