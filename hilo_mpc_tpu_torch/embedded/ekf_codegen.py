"""Embedded EKF: dependency-free C99 export of an extended Kalman filter.

PyTorch port of ``hilo_mpc_tpu/embedded/ekf_codegen.py``: the DSL→C
transpiler emits the model RHS and measurement map, the step is RK4 (or
the discrete map), Jacobians are central finite differences, and the
update uses the Joseph-form covariance with a Cholesky solve of the small
innovation system. Q, R and the parameters come from the port's filter.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from .nmpc_codegen import _CExpr, _c_float, _fmt_array, _model_parsed


def generate_meas_c(model) -> str:
    """C body for `static void model_meas(const double *x, const double *u,
    double t, double *y)` from the model's `y(k) = ...` DSL lines."""
    parsed = _model_parsed(model)
    if not parsed.meas_src:
        raise ValueError("embedded EKF export needs measurement equations "
                         "(`y(k) = ...` DSL lines)")
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
    for i, m in enumerate(parsed.measurements):
        lines.append(f"    y[{i}] = {tr.emit(parsed.meas_src[m])};")
    return "\n".join(lines)


def generate_ekf_c(ekf, path: str) -> str:
    """Emit a self-contained C99 EKF for a set-up (Extended)KalmanFilter.

    Exports `void ekf_step(double *x, double *P, const double *u,
    const double *y, double t)`: RK4/discrete predict with central-FD state
    Jacobian, measurement update with central-FD output Jacobian, Joseph
    covariance form, Cholesky solve of the innovation system. Q/R and model
    parameters are baked at export time (like the other embedded exports).
    """
    from .nmpc_codegen import generate_model_rhs_c

    model = ekf._model
    if model.n_z:
        raise ValueError("embedded EKF export does not support DAE models")
    nx, nu = model.n_x, model.n_u
    ny = len(model.measurements)
    dt = float(ekf._dt)
    p_vals = np.asarray(ekf._p_or_default(None), dtype=float)
    Qc = np.asarray(ekf.Q, dtype=float)
    Rc = np.asarray(ekf.R, dtype=float)
    rhs_body = generate_model_rhs_c(model)
    meas_body = generate_meas_c(model)
    discrete = bool(model.discrete)

    code = f"""/* auto-generated embedded EKF (predict: {'discrete map' if discrete else 'RK4'} + central-FD
 * Jacobian; update: Joseph form, Cholesky innovation solve).
 * Model: {model.name!r}. */
#include <math.h>

#define NX {nx}
#define NU {nu}
#define NY {ny}
static const double DT = {dt:.17g};
{_fmt_array("P_VALS", p_vals) if p_vals.size else "static const double P_VALS[1] = {0};"}
{_fmt_array("Q_C", Qc)}
{_fmt_array("R_C", Rc)}

static void model_rhs(const double *x, const double *u, double t, double *dx) {{
{rhs_body}
}}

static void model_meas(const double *x, const double *u, double t, double *y) {{
{meas_body}
}}

static void step_f(const double *x, const double *u, double t, double *xn) {{
"""
    if discrete:
        code += "    model_rhs(x, u, t, xn);\n"
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

/* central-difference Jacobians */
static void jac_F(const double *x, const double *u, double t, double *F) {
    double xp[NX], xm[NX], fp[NX], fm[NX];
    for (int j = 0; j < NX; ++j) {
        double h = 1e-6 * (1.0 + fabs(x[j]));
        for (int i = 0; i < NX; ++i) { xp[i] = x[i]; xm[i] = x[i]; }
        xp[j] += h; xm[j] -= h;
        step_f(xp, u, t, fp); step_f(xm, u, t, fm);
        for (int i = 0; i < NX; ++i)
            F[i * NX + j] = (fp[i] - fm[i]) / (2.0 * h);
    }
}

static void jac_H(const double *x, const double *u, double t, double *H) {
    double xp[NX], xm[NX], hp[NY], hm[NY];
    for (int j = 0; j < NX; ++j) {
        double h = 1e-6 * (1.0 + fabs(x[j]));
        for (int i = 0; i < NX; ++i) { xp[i] = x[i]; xm[i] = x[i]; }
        xp[j] += h; xm[j] -= h;
        model_meas(xp, u, t, hp); model_meas(xm, u, t, hm);
        for (int i = 0; i < NY; ++i)
            H[i * NX + j] = (hp[i] - hm[i]) / (2.0 * h);
    }
}

/* Cholesky solve of S X = B (S: NY x NY SPD, B: NY x m, row-major) */
static void chol_solve(double *S, double *B, int m) {
    double L[NY * NY];
    for (int i = 0; i < NY; ++i)
        for (int j = 0; j <= i; ++j) {
            double acc = S[i * NY + j];
            for (int l = 0; l < j; ++l)
                acc -= L[i * NY + l] * L[j * NY + l];
            L[i * NY + j] = (i == j) ? sqrt(acc) : acc / L[j * NY + j];
        }
    for (int c = 0; c < m; ++c) {
        double yv[NY];
        for (int i = 0; i < NY; ++i) {
            double acc = B[i * m + c];
            for (int l = 0; l < i; ++l) acc -= L[i * NY + l] * yv[l];
            yv[i] = acc / L[i * NY + i];
        }
        for (int i = NY - 1; i >= 0; --i) {
            double acc = yv[i];
            for (int l = i + 1; l < NY; ++l)
                acc -= L[l * NY + i] * B[l * m + c];
            B[i * m + c] = acc / L[i * NY + i];
        }
    }
}

/* one EKF step: (x, P) updated in place with (u, y) at time t */
void ekf_step(double *x, double *P, const double *u, const double *y,
              double t) {
    double F[NX * NX], xp[NX], Pp[NX * NX], tmp[NX * NX];
    /* predict */
    jac_F(x, u, t, F);
    step_f(x, u, t, xp);
    for (int i = 0; i < NX; ++i)           /* tmp = F P */
        for (int j = 0; j < NX; ++j) {
            double a = 0;
            for (int l = 0; l < NX; ++l) a += F[i * NX + l] * P[l * NX + j];
            tmp[i * NX + j] = a;
        }
    for (int i = 0; i < NX; ++i)           /* Pp = tmp F^T + Q */
        for (int j = 0; j < NX; ++j) {
            double a = Q_C[i * NX + j];
            for (int l = 0; l < NX; ++l) a += tmp[i * NX + l] * F[j * NX + l];
            Pp[i * NX + j] = a;
        }
    /* update */
    double H[NY * NX], yp[NY], S[NY * NY], PHt[NX * NY], K[NX * NY];
    jac_H(xp, u, t + DT, H);
    model_meas(xp, u, t + DT, yp);
    for (int i = 0; i < NX; ++i)           /* PHt = Pp H^T */
        for (int j = 0; j < NY; ++j) {
            double a = 0;
            for (int l = 0; l < NX; ++l) a += Pp[i * NX + l] * H[j * NX + l];
            PHt[i * NY + j] = a;
        }
    for (int i = 0; i < NY; ++i)           /* S = H PHt + R */
        for (int j = 0; j < NY; ++j) {
            double a = R_C[i * NY + j];
            for (int l = 0; l < NX; ++l) a += H[i * NX + l] * PHt[l * NY + j];
            S[i * NY + j] = a;
        }
    /* K^T from S K^T = (PHt)^T, i.e. solve S X = PHt^T (NY x NX) */
    double B[NY * NX];
    for (int i = 0; i < NY; ++i)
        for (int j = 0; j < NX; ++j) B[i * NX + j] = PHt[j * NY + i];
    chol_solve(S, B, NX);
    for (int i = 0; i < NX; ++i)
        for (int j = 0; j < NY; ++j) K[i * NY + j] = B[j * NX + i];
    for (int i = 0; i < NX; ++i) {         /* x = xp + K (y - yp) */
        double a = xp[i];
        for (int l = 0; l < NY; ++l) a += K[i * NY + l] * (y[l] - yp[l]);
        x[i] = a;
    }
    /* Joseph form: P = (I-KH) Pp (I-KH)^T + K R K^T */
    double IKH[NX * NX];
    for (int i = 0; i < NX; ++i)
        for (int j = 0; j < NX; ++j) {
            double a = (i == j) ? 1.0 : 0.0;
            for (int l = 0; l < NY; ++l) a -= K[i * NY + l] * H[l * NX + j];
            IKH[i * NX + j] = a;
        }
    for (int i = 0; i < NX; ++i)           /* tmp = IKH Pp */
        for (int j = 0; j < NX; ++j) {
            double a = 0;
            for (int l = 0; l < NX; ++l) a += IKH[i * NX + l] * Pp[l * NX + j];
            tmp[i * NX + j] = a;
        }
    for (int i = 0; i < NX; ++i)           /* P = tmp IKH^T + K R K^T */
        for (int j = 0; j < NX; ++j) {
            double a = 0;
            for (int l = 0; l < NX; ++l) a += tmp[i * NX + l] * IKH[j * NX + l];
            for (int l = 0; l < NY; ++l)
                for (int m2 = 0; m2 < NY; ++m2)
                    a += K[i * NY + l] * R_C[l * NY + m2] * K[j * NY + m2];
            P[i * NX + j] = a;
        }
    /* symmetrize against FD roundoff */
    for (int i = 0; i < NX; ++i)
        for (int j = 0; j < i; ++j) {
            double a = 0.5 * (P[i * NX + j] + P[j * NX + i]);
            P[i * NX + j] = a; P[j * NX + i] = a;
        }
}
"""
    with open(path, "w") as fh:
        fh.write(code)
    return path


def load_ekf(so_path: str, nx: int, ny: int, nu: int):
    """ctypes wrapper: returns `step(x, P, u, y, t) -> (x_new, P_new)`."""
    lib = ctypes.CDLL(os.path.abspath(so_path))
    fn = lib.ekf_step
    dp = ctypes.POINTER(ctypes.c_double)
    fn.argtypes = [dp, dp, dp, dp, ctypes.c_double]
    fn.restype = None

    def step(x, P, u, y, t=0.0):
        x = np.ascontiguousarray(np.asarray(x, np.float64).ravel())
        P = np.ascontiguousarray(np.asarray(P, np.float64).ravel())
        u = np.ascontiguousarray(np.asarray(u, np.float64).ravel())
        y = np.ascontiguousarray(np.asarray(y, np.float64).ravel())
        assert x.size == nx and P.size == nx * nx
        assert u.size == nu and y.size == ny
        fn(x.ctypes.data_as(dp), P.ctypes.data_as(dp),
           u.ctypes.data_as(dp), y.ctypes.data_as(dp), float(t))
        return x, P.reshape(nx, nx)

    return step
