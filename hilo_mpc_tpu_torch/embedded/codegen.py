"""Embedded C code generation for controllers.

PyTorch port of ``hilo_mpc_tpu/embedded/codegen.py``: dependency-free C99
for a set-up controller of this package, its numbers read on the host in
float64 (the controllers may hold tensors on the card):

  - PID: velocity-form multi-loop controller (mirrors control/pid.py exactly),
  - LQR: static-gain state feedback,
  - LMPC: condensed box-constrained QP solved by the fast gradient method, H
    and the x0->gradient map condensed offline with numpy.

Every number is printed with ``%.17g``. ``compile_shared`` drives the host's
C compiler ($CC, cc, gcc or clang; none found is an error) and ``load_*``
wrap the shared object with ctypes, so that a generated controller can be
held against its Python counterpart. ``setup_solver`` writes, compiles and
loads into a fresh temporary directory unless it is given one.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from typing import Optional

import numpy as np
import torch


def host(a) -> np.ndarray:
    """A tensor (on any device) or array as float64 numpy on the host."""
    if hasattr(a, "detach"):
        a = a.detach().to("cpu", dtype=torch.float64)
    return np.asarray(a, dtype=float)


def _fmt_array(name: str, arr: np.ndarray) -> str:
    flat = ", ".join(f"{v:.17g}" for v in np.asarray(arr, dtype=float).ravel())
    return f"static const double {name}[{arr.size}] = {{{flat}}};"


def find_c_compiler() -> str:
    """The first of $CC, cc, gcc and clang on the PATH."""
    for cc in (os.environ.get("CC"), "cc", "gcc", "clang"):
        if cc and shutil.which(cc):
            return cc
    raise RuntimeError("no C compiler found (tried $CC, cc, gcc, clang)")


def compile_shared(src_path: str, out_path: Optional[str] = None) -> str:
    cc = find_c_compiler()
    if out_path is None:
        out_path = os.path.splitext(src_path)[0] + ".so"
    cmd = [cc, "-O2", "-fPIC", "-shared", "-o", out_path, src_path, "-lm"]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"C compilation failed:\n{res.stderr}")
    return out_path


# ---------------------------------------------------------------------------
# PID
# ---------------------------------------------------------------------------


def generate_pid_c(pid, path: str) -> str:
    """Emit C for a velocity-form PID (mirror of control/pid.py)."""
    n = pid.n_set_points
    lb, ub = pid._u_bounds
    lb = -1e30 if not np.isfinite(lb) else float(lb)
    ub = 1e30 if not np.isfinite(ub) else float(ub)
    ti = np.where(np.isfinite(pid.t_i), pid.t_i, 1e30)
    code = f"""/* auto-generated velocity-form PID ({n} loops) */
#include <math.h>

#define N_LOOPS {n}
{_fmt_array("K_P", pid.k_p)}
{_fmt_array("T_I", ti)}
{_fmt_array("T_D", pid.t_d)}
static const double DT = {pid._dt:.17g};
static const double U_LB = {lb:.17g};
static const double U_UB = {ub:.17g};
static const int P_ON_PV = {1 if pid._p_on_pv else 0};
static const int D_ON_PV = {1 if pid._d_on_pv else 0};

typedef struct {{
    double u[N_LOOPS];
    double pv1[N_LOOPS];
    double pv2[N_LOOPS];
    double sp1[N_LOOPS];
    double sp2[N_LOOPS];
}} pid_state;

void pid_init(pid_state *st) {{
    for (int i = 0; i < N_LOOPS; ++i) {{
        st->u[i] = 0.0; st->pv1[i] = 0.0; st->pv2[i] = 0.0;
        st->sp1[i] = 0.0; st->sp2[i] = 0.0;
    }}
}}

void pid_step(pid_state *st, const double *pv, const double *sp, double *u_out) {{
    for (int i = 0; i < N_LOOPS; ++i) {{
        /* windowed setpoints: each pv pairs with the sp active at its time */
        double e  = sp[i] - pv[i];
        double e1 = st->sp1[i] - st->pv1[i];
        double e2 = st->sp2[i] - st->pv2[i];
        double delta = P_ON_PV ? -(pv[i] - st->pv1[i]) : (e - e1);
        delta += DT / T_I[i] * e;
        if (D_ON_PV)
            delta -= T_D[i] / DT * (pv[i] - 2.0 * st->pv1[i] + st->pv2[i]);
        else
            delta += T_D[i] / DT * (e - 2.0 * e1 + e2);
        double u = st->u[i] + K_P[i] * delta;
        if (u > U_UB) u = U_UB;
        if (u < U_LB) u = U_LB;
        st->u[i] = u;
        st->pv2[i] = st->pv1[i];
        st->pv1[i] = pv[i];
        st->sp2[i] = st->sp1[i];
        st->sp1[i] = sp[i];
        u_out[i] = u;
    }}
}}
"""
    with open(path, "w") as f:
        f.write(code)
    return path


def load_pid(so_path: str, n_loops: int):
    lib = ctypes.CDLL(so_path)

    class PidState(ctypes.Structure):
        _fields_ = [("u", ctypes.c_double * n_loops),
                    ("pv1", ctypes.c_double * n_loops),
                    ("pv2", ctypes.c_double * n_loops),
                    ("sp1", ctypes.c_double * n_loops),
                    ("sp2", ctypes.c_double * n_loops)]

    state = PidState()
    lib.pid_init(ctypes.byref(state))
    arr = ctypes.c_double * n_loops

    def step(pv, sp):
        pv_c = arr(*np.asarray(pv, dtype=float).ravel())
        sp_c = arr(*np.asarray(sp, dtype=float).ravel())
        out = arr()
        lib.pid_step(ctypes.byref(state), pv_c, sp_c, out)
        return np.array(out)

    return step


# ---------------------------------------------------------------------------
# LQR
# ---------------------------------------------------------------------------


def generate_lqr_c(lqr, path: str) -> str:
    K = host(lqr.K)
    nu, nx = K.shape
    code = f"""/* auto-generated LQR state feedback u = -K x */
#define NX {nx}
#define NU {nu}
{_fmt_array("K_GAIN", K)}

void lqr_step(const double *x, double *u_out) {{
    for (int i = 0; i < NU; ++i) {{
        double acc = 0.0;
        for (int j = 0; j < NX; ++j) acc += K_GAIN[i * NX + j] * x[j];
        u_out[i] = -acc;
    }}
}}
"""
    with open(path, "w") as f:
        f.write(code)
    return path


def load_lqr(so_path: str, nx: int, nu: int):
    lib = ctypes.CDLL(so_path)

    def step(x):
        x_c = (ctypes.c_double * nx)(*np.asarray(x, dtype=float).ravel())
        out = (ctypes.c_double * nu)()
        lib.lqr_step(x_c, out)
        return np.array(out)

    return step


# ---------------------------------------------------------------------------
# Condensed linear MPC via the fast gradient method (muAO-MPC's algorithm family)
# ---------------------------------------------------------------------------


def condense_lmpc(A, B, Q, R, P, N):
    """Condense the LTI MPC QP onto the input sequence: J = 1/2 Uᵀ H U + x0ᵀ Gᵀ U.

    Prediction: X = Phi x0 + Gamma U  (Gamma lower block triangular of A^i B).
    H = Gammaᵀ Qbar Gamma + Rbar, G = Gammaᵀ Qbar Phi.
    """
    A = np.asarray(A, dtype=float)
    B = np.asarray(B, dtype=float)
    nx, nu = B.shape
    Phi = np.zeros(((N) * nx, nx))
    Gamma = np.zeros((N * nx, N * nu))
    Apow = np.eye(nx)
    for i in range(N):
        Apow = A @ Apow
        Phi[i * nx:(i + 1) * nx] = Apow
    # block (i, j) = A^(i-j) B for j <= i
    pows = [np.eye(nx)]
    for _ in range(N):
        pows.append(A @ pows[-1])
    for i in range(N):
        for j in range(i + 1):
            Gamma[i * nx:(i + 1) * nx, j * nu:(j + 1) * nu] = pows[i - j] @ B
    Qbar = np.kron(np.eye(N), np.asarray(Q, dtype=float))
    Qbar[-nx:, -nx:] = np.asarray(P if P is not None else Q, dtype=float)
    Rbar = np.kron(np.eye(N), np.asarray(R, dtype=float))
    H = Gamma.T @ Qbar @ Gamma + Rbar
    G = Gamma.T @ Qbar @ Phi
    return H, G


def generate_lmpc_c(lmpc, path: str, fgm_iters: int = 60) -> str:
    """Emit C for condensed LMPC solved by the projected fast gradient method."""
    model = lmpc._model
    A, B = model.A, model.B
    if A is None:
        A, B = (host(j) for j in model.jacobians(
            np.zeros(model.n_x), np.zeros(model.n_u)))
    if not model.discrete:
        raise ValueError("embedded LMPC export requires a discrete-time model")
    N = lmpc.horizon
    # factor 2: our quadratic costs are x'Qx (no 1/2); the condensed QP uses 1/2 U'HU
    H, G = condense_lmpc(A, B, 2 * lmpc.Q, 2 * lmpc.R,
                         2 * lmpc.P if lmpc.P is not None else None, N)
    nu = model.n_u
    nU = N * nu
    eigs = np.linalg.eigvalsh(H)
    L, mu_cvx = float(eigs[-1]), float(max(eigs[0], 1e-12))
    kappa = np.sqrt(L / mu_cvx)
    beta = (kappa - 1.0) / (kappa + 1.0)
    u_lb = np.tile(np.where(np.isfinite(lmpc._u_lb), lmpc._u_lb, -1e30), N)
    u_ub = np.tile(np.where(np.isfinite(lmpc._u_ub), lmpc._u_ub, 1e30), N)
    code = f"""/* auto-generated condensed linear MPC, projected fast gradient method */
#define NX {model.n_x}
#define NU {nu}
#define NSTEPS {N}
#define NUVEC {nU}
#define FGM_ITERS {fgm_iters}
{_fmt_array("H_MAT", H)}
{_fmt_array("G_MAT", G)}
{_fmt_array("U_LB", u_lb)}
{_fmt_array("U_UB", u_ub)}
static const double INV_L = {1.0 / L:.17g};
static const double BETA = {beta:.17g};

static double u_prev[NUVEC];

void lmpc_init(void) {{ for (int i = 0; i < NUVEC; ++i) u_prev[i] = 0.0; }}

/* one MPC solve: first control move written to u_out (NU entries) */
void lmpc_step(const double *x0, double *u_out) {{
    double g[NUVEC], u[NUVEC], y[NUVEC], u_new[NUVEC];
    for (int i = 0; i < NUVEC; ++i) {{
        double acc = 0.0;
        for (int j = 0; j < NX; ++j) acc += G_MAT[i * NX + j] * x0[j];
        g[i] = acc;
        u[i] = u_prev[i];
        y[i] = u_prev[i];
    }}
    for (int it = 0; it < FGM_ITERS; ++it) {{
        for (int i = 0; i < NUVEC; ++i) {{
            double grad = g[i];
            for (int j = 0; j < NUVEC; ++j) grad += H_MAT[i * NUVEC + j] * y[j];
            double v = y[i] - INV_L * grad;
            if (v > U_UB[i]) v = U_UB[i];
            if (v < U_LB[i]) v = U_LB[i];
            u_new[i] = v;
        }}
        for (int i = 0; i < NUVEC; ++i) {{
            y[i] = u_new[i] + BETA * (u_new[i] - u[i]);
            u[i] = u_new[i];
        }}
    }}
    for (int i = 0; i < NUVEC; ++i) u_prev[i] = u[i];
    for (int i = 0; i < NU; ++i) u_out[i] = u[i];
}}
"""
    with open(path, "w") as f:
        f.write(code)
    return path


def load_lmpc(so_path: str, nx: int, nu: int):
    lib = ctypes.CDLL(so_path)
    lib.lmpc_init()

    def step(x0):
        x_c = (ctypes.c_double * nx)(*np.asarray(x0, dtype=float).ravel())
        out = (ctypes.c_double * nu)()
        lib.lmpc_step(x_c, out)
        return np.array(out)

    return step


def setup_solver(controller, workdir: Optional[str] = None, **kwargs):
    """One-call export+compile+load: returns a `solver(x0) -> u` closure
    backed by compiled C (in ``workdir``, else a new temporary directory)."""
    workdir = workdir or tempfile.mkdtemp(prefix="hilo_embedded_")
    kind = getattr(controller, "_controller_type", type(controller).__name__)
    src = os.path.join(workdir, f"{kind.lower()}_gen.c")
    if kind == "PID":
        generate_pid_c(controller, src)
        so = compile_shared(src)
        step = load_pid(so, controller.n_set_points)
        return lambda pv: step(pv, controller.set_point)
    if kind == "LQR":
        generate_lqr_c(controller, src)
        so = compile_shared(src)
        return load_lqr(so, controller._model.n_x, controller._model.n_u)
    if kind == "LMPC":
        generate_lmpc_c(controller, src, **kwargs)
        so = compile_shared(src)
        return load_lmpc(so, controller._model.n_x, controller._model.n_u)
    if kind in ("NMPC", "OCP"):
        from .nmpc_codegen import generate_nmpc_c, load_nmpc

        generate_nmpc_c(controller, src, **kwargs)
        so = compile_shared(src)
        return load_nmpc(so, controller._model.n_x, controller._model.n_u)
    raise TypeError(f"no embedded export for controller type {kind}")
