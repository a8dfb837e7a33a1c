"""Embedded MHE: dependency-free C99 export of a moving-horizon estimator.

PyTorch port of ``hilo_mpc_tpu/embedded/mhe_codegen.py``: the window problem

    min_{x_0, w_0..w_{N-1}}  (x_0 - x̄)ᵀ P0⁻¹ (x_0 - x̄)
        + Σ_k (y_k - h(x_k))ᵀ R⁻¹ (y_k - h(x_k)) + Σ_k w_kᵀ Q⁻¹ w_k
    s.t. x_{k+1} = f(x_k, u_k) + w_k

is solved as damped Gauss-Newton over z = [x_0, w_0..w_{N-1}] with
finite-difference residual Jacobians and a dense normal-equation Cholesky.
Q/R/P0 are covariances, inverted at export time as the port's MHE inverts
them. The caller owns the measurement window (the contract of
``parallel.fused_closed_loop_mhe_fn``): pass y_0..y_N, the interval inputs
u_0..u_{N-1} and the arrival mean; receive x̂ = x_N and the next arrival
mean x_1.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from .ekf_codegen import generate_meas_c
from .nmpc_codegen import _fmt_array, generate_model_rhs_c


def generate_mhe_c(mhe, path: str, gn_iters: int = 15,
                   damping: float = 1e-8) -> str:
    """Emit a self-contained C99 MHE window solver for a set-up
    MovingHorizonEstimator (state estimation only, no estimated parameters).

    Exports `void mhe_solve(const double *Y, const double *U,
    const double *x_arr, double t, double *x_est, double *x_arr_next)`
    with Y (N+1)·NY row-major, U N·NU interval inputs.
    """
    model = mhe._model
    if model.n_z:
        raise ValueError("embedded MHE export does not support DAE models")
    if mhe._est_params:
        raise NotImplementedError(
            "embedded MHE export supports state estimation only")
    nx, nu = model.n_x, model.n_u
    ny = len(model.measurements)
    N = mhe._horizon
    dt = float(mhe._dt)
    p_vals = np.asarray(mhe._p_or_default(None), dtype=float)
    W_arr = np.linalg.inv(np.asarray(mhe.P0, dtype=float))
    W_meas = np.linalg.inv(np.asarray(mhe.R, dtype=float))
    W_noise = np.linalg.inv(np.asarray(mhe.Q, dtype=float))
    rhs_body = generate_model_rhs_c(model)
    meas_body = generate_meas_c(model)
    discrete = bool(model.discrete)

    code = f"""/* auto-generated embedded MHE: damped Gauss-Newton over
 * (x_0, w_0..w_N-1) with FD Jacobians + dense normal-equation Cholesky.
 * Model: {model.name!r}. */
#include <math.h>

#define NX {nx}
#define NU {nu}
#define NY {ny}
#define NW {N}
#define NZ (NX * (NW + 1))
#define GN_ITERS {gn_iters}
static const double DT = {dt:.17g};
static const double DAMP = {damping:.17g};
{_fmt_array("P_VALS", p_vals) if p_vals.size else "static const double P_VALS[1] = {0};"}
{_fmt_array("W_ARR", W_arr)}
{_fmt_array("W_MEAS", W_meas)}
{_fmt_array("W_NOISE", W_noise)}

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

#define NRES (NX + (NW + 1) * NY + NW * NX)

/* weighted residual vector at z = [x0, w_0..w_{NW-1}] */
static void residuals(const double *z, const double *Y, const double *U,
                      const double *x_arr, double t, double *r,
                      double *X_traj) {
    double x[NX], xn[NX], yv[NY];
    int ri = 0;
    for (int i = 0; i < NX; ++i) x[i] = z[i];
    /* arrival block: W_ARR^{1/2} would need a factorization; use the
     * equivalent normal-equation weighting by premultiplying residual
     * blocks with the full weight in the GN assembly instead — here r holds
     * the UNWEIGHTED residuals and the weights enter via block W in JtWJ. */
    for (int i = 0; i < NX; ++i) r[ri++] = x[i] - x_arr[i];
    for (int k = 0; k <= NW; ++k) {
        for (int i = 0; i < NX; ++i) X_traj[k * NX + i] = x[i];
        const double *u = (k < NW) ? &U[k * NU] : &U[(NW - 1) * NU];
        model_meas(x, u, t + k * DT, yv);
        for (int i = 0; i < NY; ++i) r[ri++] = Y[k * NY + i] - yv[i];
        if (k < NW) {
            step_f(x, u, t + k * DT, xn);
            for (int i = 0; i < NX; ++i) {
                r[ri++] = z[NX + k * NX + i];     /* w_k */
                x[i] = xn[i] + z[NX + k * NX + i];
            }
        }
    }
}

/* block weight of residual row i times vector entry: the residual layout is
 * [arr (NX)] [y_0 (NY)] [w_0 (NX)] [y_1 (NY)] [w_1 (NX)] ... [y_NW (NY)] */
static void weight_block(const double *r, double *wr) {
    int ri = 0;
    for (int i = 0; i < NX; ++i) {
        double a = 0;
        for (int j = 0; j < NX; ++j) a += W_ARR[i * NX + j] * r[j];
        wr[ri + i] = a;
    }
    ri += NX;
    for (int k = 0; k <= NW; ++k) {
        for (int i = 0; i < NY; ++i) {
            double a = 0;
            for (int j = 0; j < NY; ++j)
                a += W_MEAS[i * NY + j] * r[ri + j];
            wr[ri + i] = a;
        }
        ri += NY;
        if (k < NW) {
            for (int i = 0; i < NX; ++i) {
                double a = 0;
                for (int j = 0; j < NX; ++j)
                    a += W_NOISE[i * NX + j] * r[ri + j];
                wr[ri + i] = a;
            }
            ri += NX;
        }
    }
}

static void chol_solve_nz(double *A, double *b) {
    double L[NZ * NZ];
    for (int i = 0; i < NZ; ++i)
        for (int j = 0; j <= i; ++j) {
            double acc = A[i * NZ + j];
            for (int l = 0; l < j; ++l)
                acc -= L[i * NZ + l] * L[j * NZ + l];
            L[i * NZ + j] = (i == j) ? sqrt(acc) : acc / L[j * NZ + j];
        }
    double yv[NZ];
    for (int i = 0; i < NZ; ++i) {
        double acc = b[i];
        for (int l = 0; l < i; ++l) acc -= L[i * NZ + l] * yv[l];
        yv[i] = acc / L[i * NZ + i];
    }
    for (int i = NZ - 1; i >= 0; --i) {
        double acc = yv[i];
        for (int l = i + 1; l < NZ; ++l) acc -= L[l * NZ + i] * b[l];
        b[i] = acc / L[i * NZ + i];
    }
}

void mhe_solve(const double *Y, const double *U, const double *x_arr,
               double t, double *x_est, double *x_arr_next) {
    static double z[NZ], r0[NRES], rp[NRES], rm[NRES], J[NRES * NZ];
    static double wr[NRES], JtWJ[NZ * NZ], g[NZ], X_traj[(NW + 1) * NX];
    for (int i = 0; i < NX; ++i) z[i] = x_arr[i];
    for (int i = NX; i < NZ; ++i) z[i] = 0.0;
    for (int it = 0; it < GN_ITERS; ++it) {
        residuals(z, Y, U, x_arr, t, r0, X_traj);
        for (int j = 0; j < NZ; ++j) {          /* FD Jacobian column j */
            double h = 1e-6 * (1.0 + fabs(z[j]));
            double zs = z[j];
            z[j] = zs + h; residuals(z, Y, U, x_arr, t, rp, X_traj);
            z[j] = zs - h; residuals(z, Y, U, x_arr, t, rm, X_traj);
            z[j] = zs;
            for (int i = 0; i < NRES; ++i)
                J[i * NZ + j] = (rp[i] - rm[i]) / (2.0 * h);
        }
        weight_block(r0, wr);
        for (int j = 0; j < NZ; ++j) {          /* g = J^T W r */
            double a = 0;
            for (int i = 0; i < NRES; ++i) a += J[i * NZ + j] * wr[i];
            g[j] = -a;
        }
        for (int a2 = 0; a2 < NZ; ++a2)         /* JtWJ = J^T W J + damp I */
            for (int b2 = 0; b2 < NZ; ++b2)
                JtWJ[a2 * NZ + b2] = (a2 == b2) ? DAMP : 0.0;
        /* W J: weight each Jacobian column, accumulate */
        {
            static double wcol[NRES];
            for (int c = 0; c < NZ; ++c) {
                for (int i = 0; i < NRES; ++i) rp[i] = J[i * NZ + c];
                weight_block(rp, wcol);
                for (int a2 = 0; a2 < NZ; ++a2) {
                    double acc = 0;
                    for (int i = 0; i < NRES; ++i)
                        acc += J[i * NZ + a2] * wcol[i];
                    JtWJ[a2 * NZ + c] += acc;
                }
            }
        }
        chol_solve_nz(JtWJ, g);
        double step_norm = 0;
        for (int i = 0; i < NZ; ++i) { z[i] += g[i]; step_norm += g[i] * g[i]; }
        if (step_norm < 1e-20) break;
    }
    residuals(z, Y, U, x_arr, t, r0, X_traj);
    for (int i = 0; i < NX; ++i) {
        x_est[i] = X_traj[NW * NX + i];
        x_arr_next[i] = X_traj[1 * NX + i];
    }
}
"""
    with open(path, "w") as fh:
        fh.write(code)
    return path


def load_mhe(so_path: str, nx: int, ny: int, nu: int, N: int):
    """ctypes wrapper: returns `solve(Y, U, x_arr, t) ->
    (x_est, x_arr_next)` with Y (N+1, ny), U (N, nu)."""
    lib = ctypes.CDLL(os.path.abspath(so_path))
    fn = lib.mhe_solve
    dp = ctypes.POINTER(ctypes.c_double)
    fn.argtypes = [dp, dp, dp, ctypes.c_double, dp, dp]
    fn.restype = None

    def solve(Y, U, x_arr, t=0.0):
        Y = np.ascontiguousarray(np.asarray(Y, np.float64).reshape(N + 1, ny))
        U = np.ascontiguousarray(np.asarray(U, np.float64).reshape(N, nu))
        x_arr = np.ascontiguousarray(np.asarray(x_arr, np.float64).ravel())
        x_est = np.zeros(nx)
        x_next = np.zeros(nx)
        fn(Y.ctypes.data_as(dp), U.ctypes.data_as(dp),
           x_arr.ctypes.data_as(dp), float(t),
           x_est.ctypes.data_as(dp), x_next.ctypes.data_as(dp))
        return x_est, x_next

    return solve
