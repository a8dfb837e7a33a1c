"""Embedded NONLINEAR MPC C code generation.

PyTorch port of ``hilo_mpc_tpu/embedded/nmpc_codegen.py``: the model's
equation-string DSL is transpiled to C99 (`_CExpr`), discretized with an
in-C RK4 step, and wrapped in a dependency-free single-shooting
Gauss-Newton SQP whose box-constrained QP subproblems are solved by a
projected fast gradient method (FISTA). Finite-difference stage Jacobians
keep the generated code free of hand-derived derivative expressions. The
model is parsed by this package's own ``utils/parsing.py``; weights,
references, bounds and parameters are read from the port's NMPC on the
host, so where they equal the JAX controller's the C text is the same
bytes.

Scope (gated with clear errors): explicit-ODE or discrete models written
in the DSL, quadratic stage/terminal costs with constant references,
input box constraints.
"""
from __future__ import annotations

import ast
import ctypes
import os
from typing import Dict, List, Optional

import numpy as np

from .codegen import _fmt_array, compile_shared

__all__ = ["transpile_expr_to_c", "generate_model_rhs_c", "generate_nmpc_c",
           "load_nmpc"]


# -- expression transpiler ------------------------------------------------------
_C_FUNCS = {
    "sin": "sin", "cos": "cos", "tan": "tan", "asin": "asin", "acos": "acos",
    "atan": "atan", "arcsin": "asin", "arccos": "acos", "arctan": "atan",
    "sinh": "sinh", "cosh": "cosh", "tanh": "tanh", "exp": "exp", "log": "log",
    "ln": "log", "log10": "log10", "sqrt": "sqrt", "abs": "fabs", "fabs": "fabs",
    "floor": "floor", "ceil": "ceil", "sign": "hilo_sign", "erf": "erf",
    "atan2": "atan2", "arctan2": "atan2", "fmod": "fmod", "mod": "fmod",
    "minimum": "fmin", "maximum": "fmax", "min": "fmin", "max": "fmax",
    "power": "pow",
}
_C_CONSTS = {"pi": "3.14159265358979323846", "e": "2.71828182845904523536",
             "inf": "1e300"}


def _c_float(v: float) -> str:
    """Emit a C literal that is ALWAYS of type double. '%.17g' of 2.0 gives
    '2', and 'x / (3 - 1)' would then be C integer division — force a decimal
    point or exponent into every numeric literal."""
    s = f"{float(v):.17g}"
    if not any(c in s for c in ".eE") or s.lstrip("+-").startswith("inf"):
        s += ".0"
    return s


class _CExpr(ast.NodeVisitor):
    """Transpile the DSL's Python-expression subset to a C99 expression.

    ``name_map`` routes variable names to C lvalues (x[i]/u[j]/p[k]/aux
    locals); DSL pseudo-calls like ``x_1(t)`` / ``u(k)`` resolve to the bare
    name, mirroring the parser's _CallStripper (utils/parsing.py:88)."""

    def __init__(self, name_map: Dict[str, str]):
        self.name_map = name_map

    def emit(self, expr: str) -> str:
        tree = ast.parse(expr, mode="eval")
        return self.visit(tree.body)

    def visit_Expression(self, node):
        return self.visit(node.body)

    def visit_Constant(self, node):
        if isinstance(node.value, bool):
            return "1.0" if node.value else "0.0"
        if isinstance(node.value, (int, float)):
            return _c_float(node.value)
        raise ValueError(f"unsupported constant {node.value!r}")

    def visit_Name(self, node):
        n = node.id
        if n in self.name_map:
            return self.name_map[n]
        if n in _C_CONSTS:
            return _C_CONSTS[n]
        raise ValueError(f"unknown name {n!r} in embedded expression")

    def visit_Call(self, node):
        if not isinstance(node.func, ast.Name):
            raise ValueError("only simple function calls are supported")
        fname = node.func.id
        # DSL pseudo-call: x_1(t), u(k) -> the bare variable
        if fname in self.name_map and len(node.args) == 1 and isinstance(
                node.args[0], ast.Name) and node.args[0].id in ("t", "k"):
            return self.name_map[fname]
        if fname not in _C_FUNCS:
            raise ValueError(f"function {fname!r} has no C mapping")
        args = ", ".join(self.visit(a) for a in node.args)
        return f"{_C_FUNCS[fname]}({args})"

    def visit_BinOp(self, node):
        lhs, rhs = self.visit(node.left), self.visit(node.right)
        if isinstance(node.op, ast.Add):
            return f"({lhs} + {rhs})"
        if isinstance(node.op, ast.Sub):
            return f"({lhs} - {rhs})"
        if isinstance(node.op, ast.Mult):
            return f"({lhs} * {rhs})"
        if isinstance(node.op, ast.Div):
            return f"({lhs} / {rhs})"
        if isinstance(node.op, ast.Pow):
            # integer exponents unroll to multiplications (no libm call)
            if (isinstance(node.right, ast.Constant)
                    and float(node.right.value) == int(node.right.value)
                    and 2 <= int(node.right.value) <= 4):
                k = int(node.right.value)
                return "(" + " * ".join([lhs] * k) + ")"
            return f"pow({lhs}, {rhs})"
        if isinstance(node.op, ast.Mod):
            return f"fmod({lhs}, {rhs})"
        raise ValueError(f"unsupported operator {type(node.op).__name__}")

    def visit_UnaryOp(self, node):
        v = self.visit(node.operand)
        if isinstance(node.op, ast.USub):
            return f"(-{v})"
        if isinstance(node.op, ast.UAdd):
            return v
        raise ValueError(f"unsupported unary {type(node.op).__name__}")

    def generic_visit(self, node):
        raise ValueError(f"unsupported syntax {type(node).__name__} "
                         "in embedded expression")


def transpile_expr_to_c(expr: str, name_map: Dict[str, str]) -> str:
    """Public entry: one DSL expression -> one C expression string."""
    return _CExpr(name_map).emit(expr)


def _model_parsed(model):
    src = getattr(model, "_equations_src", None)
    if not src:
        raise ValueError(
            "embedded NMPC export needs the model's equation-string DSL "
            "(set_equations(text)); callable equations cannot be transpiled")
    from ..utils.parsing import parse_equations

    return parse_equations(src, known_states=model._x.names or None,
                           known_inputs=model._u.names or None,
                           known_parameters=model._p.names or None)


def generate_model_rhs_c(model) -> str:
    """C body for `static void model_rhs(const double *x, const double *u,
    double t, double *dx)` — aux substitutions emitted as locals in
    topological order, parameters baked as constants at export time."""
    parsed = _model_parsed(model)
    if parsed.algebraic:
        raise ValueError("embedded export does not support DAE models")
    name_map = {"t": "t", "k": "t"}
    for i, n in enumerate(parsed.states):
        name_map[n] = f"x[{i}]"
    for i, n in enumerate(parsed.inputs):
        name_map[n] = f"u[{i}]"
    for i, n in enumerate(parsed.parameters):
        name_map[n] = f"P_VALS[{i}]"
    for n, v in parsed.constants.items():
        name_map[n] = _c_float(v)
    tr = _CExpr(name_map)
    lines = []
    for n, expr in parsed.aux_src:
        name_map[n] = f"aux_{n}"
        lines.append(f"    const double aux_{n} = {tr.emit(expr)};")
    for i, n in enumerate(parsed.states):
        lines.append(f"    dx[{i}] = {tr.emit(parsed.ode_src[n])};")
    return "\n".join(lines)


def _stage_cost_data(nmpc):
    """Constant-reference Q/xref and R/uref in the full state/input space."""
    nx, nu = nmpc._model.n_x, nmpc._model.n_u

    def collect(cost, nx_, nu_):
        Q = np.zeros((nx_, nx_))
        xref = np.zeros(nx_)
        R = np.zeros((nu_, nu_))
        uref = np.zeros(nu_)
        for t in cost.terms:
            if t.trajectory_tracking or t.path_following or (
                    t.ref is not None and t.ref.ndim == 2):
                raise ValueError(
                    "embedded NMPC export supports constant references only "
                    "(trajectory/path references are host-solver features)")
            if t.kind == "states":
                Q[np.ix_(t.idx, t.idx)] += t.W
                if t.ref is not None:
                    xref[t.idx] = t.ref
            elif t.kind == "inputs":
                R[np.ix_(t.idx, t.idx)] += t.W
                if t.ref is not None:
                    uref[t.idx] = t.ref
            else:
                raise ValueError(
                    f"embedded NMPC export does not support {t.kind!r} cost "
                    "terms")
        return Q, xref, R, uref

    Q, xref, R, uref = collect(nmpc.quad_stage_cost, nx, nu)
    P, xref_t, Rt, _ = collect(nmpc.quad_terminal_cost, nx, nu)
    if np.any(Rt):
        raise ValueError("terminal input costs are not supported in the "
                         "embedded export")
    # host convention (control/nmpc.py stage_cost/term_cost): stage cost is
    # summed over (x_k, u_k), k=0..N-1, terminal cost ONLY if explicitly set
    # — an empty terminal cost stays zero, it does NOT default to Q
    return Q, xref, R, uref, P, xref_t


def generate_nmpc_c(nmpc, path: str, sqp_iters: int = 12,
                    fgm_iters: int = 200) -> str:
    """Emit a self-contained C99 NMPC controller for `nmpc`.

    Algorithm: single-shooting Gauss-Newton SQP. Each iteration rolls the
    RK4-discretized dynamics forward while propagating input sensitivities
    S_k = dx_k/dU (finite-difference A_k/B_k), condenses the quadratic
    tracking cost onto the input sequence (dense H, g), and solves the
    box-constrained step QP with FISTA (projected fast gradient, Lipschitz
    constant from on-line power iteration). Warm-started across calls by
    the shifted previous solution — the embedded analogue of the host
    solver's warm start.
    """
    model = nmpc._model
    if model.n_z:
        raise ValueError("embedded export does not support DAE models")
    if getattr(nmpc, "_stage_constraints", None) or getattr(
            nmpc, "_term_constraints", None):
        raise ValueError("embedded export supports box input constraints "
                         "only (no custom stage/terminal constraints)")
    nx, nu = model.n_x, model.n_u
    N = nmpc.horizon
    dt = float(nmpc._opts_dict.get("dt", getattr(model, "_dt", None) or 0.1)) \
        if hasattr(nmpc, "_opts_dict") else 0.1
    # prefer the dt the controller was set up with
    dt = float(getattr(nmpc, "_dt", None) or dt)
    p_vals = np.asarray(getattr(nmpc, "_p_defaults", None) if getattr(
        nmpc, "_p_defaults", None) is not None else np.zeros(model.n_p),
        dtype=float)
    if p_vals.size != model.n_p:
        raise ValueError(f"set_parameters: expected {model.n_p} values")
    Q, xref, R, uref, P, xref_t = _stage_cost_data(nmpc)
    u_lb = np.where(np.isfinite(nmpc._u_lb), nmpc._u_lb, -1e30)
    u_ub = np.where(np.isfinite(nmpc._u_ub), nmpc._u_ub, 1e30)
    if np.any(np.isfinite(nmpc._x_lb)) or np.any(np.isfinite(nmpc._x_ub)):
        raise ValueError("embedded export supports input box constraints "
                         "only; state bounds need the host solver")
    rhs_body = generate_model_rhs_c(model)
    discrete = bool(model.discrete)

    code = f"""/* auto-generated nonlinear MPC: single-shooting Gauss-Newton SQP
 * with FISTA box-QP subproblems. Model: {model.name!r}. */
#include <math.h>

#define NX {nx}
#define NU {nu}
#define NH {N}
#define NUVEC {N * nu}
#define SQP_ITERS {sqp_iters}
#define FGM_ITERS {fgm_iters}
static const double DT = {dt:.17g};
{_fmt_array("P_VALS", p_vals) if p_vals.size else "static const double P_VALS[1] = {0};"}
{_fmt_array("Q_W", Q)}
{_fmt_array("R_W", R)}
{_fmt_array("P_W", P)}
{_fmt_array("X_REF", xref)}
{_fmt_array("U_REF", uref)}
{_fmt_array("XT_REF", xref_t)}
{_fmt_array("U_LB1", u_lb)}
{_fmt_array("U_UB1", u_ub)}

static double hilo_sign(double v) {{ return v > 0 ? 1.0 : (v < 0 ? -1.0 : 0.0); }}

static void model_rhs(const double *x, const double *u, double t, double *dx) {{
{rhs_body}
}}

/* one integration interval */
static void step_f(const double *x, const double *u, double t, double *xn) {{
"""
    if discrete:
        code += """    model_rhs(x, u, t, xn);
"""
    else:
        code += """    double k1[NX], k2[NX], k3[NX], k4[NX], tmp[NX];
    model_rhs(x, u, t, k1);
    for (int i = 0; i < NX; ++i) tmp[i] = x[i] + 0.5 * DT * k1[i];
    model_rhs(tmp, u, t + 0.5 * DT, k2);
    for (int i = 0; i < NX; ++i) tmp[i] = x[i] + 0.5 * DT * k2[i];
    model_rhs(tmp, u, t + 0.5 * DT, k3);
    for (int i = 0; i < NX; ++i) tmp[i] = x[i] + DT * k3[i];
    model_rhs(tmp, u, t + DT, k4);
    for (int i = 0; i < NX; ++i)
        xn[i] = x[i] + DT / 6.0 * (k1[i] + 2.0 * k2[i] + 2.0 * k3[i] + k4[i]);
"""
    code += """}

/* central-difference stage Jacobians A = dF/dx, B = dF/du */
static void stage_jac(const double *x, const double *u, double t,
                      double *A, double *B) {
    double xp[NX], xm[NX], fp[NX], fm[NX], up[NU], um[NU];
    for (int j = 0; j < NX; ++j) {
        double h = 1e-6 * (1.0 + fabs(x[j]));
        for (int i = 0; i < NX; ++i) { xp[i] = x[i]; xm[i] = x[i]; }
        xp[j] += h; xm[j] -= h;
        step_f(xp, u, t, fp); step_f(xm, u, t, fm);
        for (int i = 0; i < NX; ++i) A[i * NX + j] = (fp[i] - fm[i]) / (2.0 * h);
    }
    for (int j = 0; j < NU; ++j) {
        double h = 1e-6 * (1.0 + fabs(u[j]));
        for (int i = 0; i < NU; ++i) { up[i] = u[i]; um[i] = u[i]; }
        up[j] += h; um[j] -= h;
        step_f(x, up, t, fp); step_f(x, um, t, fm);
        for (int i = 0; i < NX; ++i) B[i * NU + j] = (fp[i] - fm[i]) / (2.0 * h);
    }
}

static double U_seq[NUVEC];

void nmpc_init(void) { for (int i = 0; i < NUVEC; ++i) U_seq[i] = 0.0; }

/* predicted trajectory of the last accepted iterate (NH+1 states) */
static double X_pred[(NH + 1) * NX];
const double *nmpc_prediction(void) { return X_pred; }

void nmpc_step(const double *x0, double *u_out) {
    static double S[NX * NUVEC];      /* sensitivities dx_k/dU */
    static double H[NUVEC * NUVEC], g[NUVEC];
    static double A[NX * NX], B[NX * NU];
    double x[NX], xn[NX];

    for (int sqp = 0; sqp < SQP_ITERS; ++sqp) {
        for (int i = 0; i < NUVEC * NUVEC; ++i) H[i] = 0.0;
        for (int i = 0; i < NUVEC; ++i) g[i] = 0.0;
        for (int i = 0; i < NX * NUVEC; ++i) S[i] = 0.0;
        for (int i = 0; i < NX; ++i) x[i] = x0[i];
        for (int i = 0; i < NX; ++i) X_pred[i] = x0[i];
        double t = 0.0;
        for (int k = 0; k < NH; ++k) {
            const double *uk = &U_seq[k * NU];
            /* input-cost contribution of stage k */
            for (int i = 0; i < NU; ++i) {
                double acc = 0.0;
                for (int j = 0; j < NU; ++j)
                    acc += R_W[i * NU + j] * (uk[j] - U_REF[j]);
                g[k * NU + i] += 2.0 * acc;
                for (int j = 0; j < NU; ++j)
                    H[(k * NU + i) * NUVEC + (k * NU + j)] += 2.0 * R_W[i * NU + j];
            }
            /* advance sensitivities and state */
            stage_jac(x, uk, t, A, B);
            step_f(x, uk, t, xn);
            /* S <- A S ; S[:, k] += B */
            static double Snew[NX * NUVEC];
            for (int i = 0; i < NX; ++i)
                for (int c = 0; c < NUVEC; ++c) {
                    double acc = 0.0;
                    for (int j = 0; j < NX; ++j)
                        acc += A[i * NX + j] * S[j * NUVEC + c];
                    Snew[i * NUVEC + c] = acc;
                }
            for (int i = 0; i < NX; ++i)
                for (int j = 0; j < NU; ++j)
                    Snew[i * NUVEC + (k * NU + j)] += B[i * NU + j];
            for (int i = 0; i < NX * NUVEC; ++i) S[i] = Snew[i];
            for (int i = 0; i < NX; ++i) x[i] = xn[i];
            for (int i = 0; i < NX; ++i) X_pred[(k + 1) * NX + i] = x[i];
            t += DT;
            /* state-cost contribution of x_{k+1} (terminal handled below) */
            const double *W = (k + 1 == NH) ? P_W : Q_W;
            const double *xr = (k + 1 == NH) ? XT_REF : X_REF;
            double Wdx[NX];
            for (int i = 0; i < NX; ++i) {
                double acc = 0.0;
                for (int j = 0; j < NX; ++j) acc += W[i * NX + j] * (x[j] - xr[j]);
                Wdx[i] = acc;
            }
            for (int c = 0; c < NUVEC; ++c) {
                double acc = 0.0;
                for (int i = 0; i < NX; ++i) acc += S[i * NUVEC + c] * Wdx[i];
                g[c] += 2.0 * acc;
            }
            /* H += 2 S^T W S (build W S once) */
            static double WS[NX * NUVEC];
            for (int i = 0; i < NX; ++i)
                for (int c = 0; c < NUVEC; ++c) {
                    double acc = 0.0;
                    for (int j = 0; j < NX; ++j)
                        acc += W[i * NX + j] * S[j * NUVEC + c];
                    WS[i * NUVEC + c] = acc;
                }
            for (int r = 0; r < NUVEC; ++r)
                for (int c = 0; c < NUVEC; ++c) {
                    double acc = 0.0;
                    for (int i = 0; i < NX; ++i)
                        acc += S[i * NUVEC + r] * WS[i * NUVEC + c];
                    H[r * NUVEC + c] += 2.0 * acc;
                }
        }
        /* Lipschitz estimate: a few power iterations on H */
        double v[NUVEC], Hv[NUVEC], L = 0.0;
        for (int i = 0; i < NUVEC; ++i) v[i] = 1.0 / (1.0 + i);
        for (int pi = 0; pi < 12; ++pi) {
            double nrm = 0.0;
            for (int r = 0; r < NUVEC; ++r) {
                double acc = 0.0;
                for (int c = 0; c < NUVEC; ++c) acc += H[r * NUVEC + c] * v[c];
                Hv[r] = acc;
            }
            for (int i = 0; i < NUVEC; ++i) nrm += Hv[i] * Hv[i];
            nrm = sqrt(nrm);
            if (nrm < 1e-300) break;
            L = nrm;
            for (int i = 0; i < NUVEC; ++i) v[i] = Hv[i] / nrm;
        }
        if (L < 1e-12) L = 1.0;
        double invL = 1.0 / (1.05 * L);
        /* FISTA on the step dU with bounds [lb - U, ub - U] */
        double dU[NUVEC], y[NUVEC], dU_prev[NUVEC];
        for (int i = 0; i < NUVEC; ++i) { dU[i] = 0.0; y[i] = 0.0; dU_prev[i] = 0.0; }
        double tk = 1.0;
        for (int it = 0; it < FGM_ITERS; ++it) {
            for (int r = 0; r < NUVEC; ++r) {
                double grad = g[r];
                for (int c = 0; c < NUVEC; ++c) grad += H[r * NUVEC + c] * y[c];
                double vnew = y[r] - invL * grad;
                double lo = U_LB1[r % NU] - U_seq[r];
                double hi = U_UB1[r % NU] - U_seq[r];
                if (vnew < lo) vnew = lo;
                if (vnew > hi) vnew = hi;
                dU[r] = vnew;
            }
            double tn = 0.5 * (1.0 + sqrt(1.0 + 4.0 * tk * tk));
            for (int i = 0; i < NUVEC; ++i) {
                y[i] = dU[i] + (tk - 1.0) / tn * (dU[i] - dU_prev[i]);
                dU_prev[i] = dU[i];
            }
            tk = tn;
        }
        double step_norm = 0.0;
        for (int i = 0; i < NUVEC; ++i) {
            U_seq[i] += dU[i];
            step_norm += dU[i] * dU[i];
        }
        if (step_norm < 1e-20) break;
    }
    for (int i = 0; i < NU; ++i) u_out[i] = U_seq[i];
    /* shift for the next call (warm start) */
    for (int k = 0; k < NH - 1; ++k)
        for (int i = 0; i < NU; ++i)
            U_seq[k * NU + i] = U_seq[(k + 1) * NU + i];
}
"""
    with open(path, "w") as f:
        f.write(code)
    return path


def load_nmpc(so_path: str, nx: int, nu: int, N: Optional[int] = None):
    """ctypes wrapper: returns `step(x0) -> u` backed by the compiled C NMPC."""
    lib = ctypes.CDLL(so_path)
    lib.nmpc_init()

    def step(x0):
        x_c = (ctypes.c_double * nx)(*np.asarray(x0, dtype=float).ravel())
        out = (ctypes.c_double * nu)()
        lib.nmpc_step(x_c, out)
        return np.array(out)

    return step


_CLOSED_LOOP_C = """
/* fully-native closed loop: controller + plant, zero host round-trips.
 * Each iteration: u_k = nmpc_step(x_k); x_{k+1} = plant step (same RK4).
 * States and inputs are logged into caller-provided buffers. */
void run_loop(const double *x0, int steps, double *xs_out, double *us_out) {
    double x[NX], u[NU], xn[NX];
    nmpc_init();
    for (int i = 0; i < NX; ++i) x[i] = x0[i];
    for (int k = 0; k < steps; ++k) {
        for (int i = 0; i < NX; ++i) xs_out[k * NX + i] = x[i];
        nmpc_step(x, u);
        for (int i = 0; i < NU; ++i) us_out[k * NU + i] = u[i];
        step_f(x, u, k * DT, xn);
        for (int i = 0; i < NX; ++i) x[i] = xn[i];
    }
    for (int i = 0; i < NX; ++i) xs_out[steps * NX + i] = x[i];
}
"""


def generate_closed_loop_c(nmpc, path: str, **kwargs) -> str:
    """Emit the NMPC controller PLUS a native closed-loop runner.

    SimpleControlLoop alternates Python-side controller and plant calls;
    here the whole loop — solve, apply, integrate — runs inside one C call
    (`run_loop`), the embedded analogue of the fused closed loops of
    parallel/closed_loop.py. The plant model is the controller's own
    model integrated with the same RK4/discrete step."""
    generate_nmpc_c(nmpc, path, **kwargs)
    with open(path, "a") as f:
        f.write(_CLOSED_LOOP_C)
    return path


def load_closed_loop(so_path: str, nx: int, nu: int):
    """ctypes wrapper: `run(x0, steps) -> (xs (steps+1, nx), us (steps, nu))`."""
    lib = ctypes.CDLL(so_path)

    def run(x0, steps: int):
        steps = int(steps)
        x_c = (ctypes.c_double * nx)(*np.asarray(x0, dtype=float).ravel())
        xs = (ctypes.c_double * ((steps + 1) * nx))()
        us = (ctypes.c_double * (steps * nu))()
        lib.run_loop(x_c, steps, xs, us)
        return (np.array(xs).reshape(steps + 1, nx),
                np.array(us).reshape(steps, nu))

    return run
