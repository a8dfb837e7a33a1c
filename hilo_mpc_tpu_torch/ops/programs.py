"""Standalone LP/QP/NLP optimization programs.

PyTorch port of ``hilo_mpc_tpu/ops/programs.py``: a dense primal-dual
interior point for min f(x) s.t. lbx <= x <= ubx, lbg <= g(x) <= ubg, the
unstructured sibling of the stagewise OCP solver (ops/ip_solver.py), with
exact derivatives from ``torch.func``. The JAX function solves one program
and is ``vmap``ped for parameter sweeps; here ``solve_dense_nlp`` is the
batched solve itself: B programs of one structure (each with its own x0,
parameters and bounds) advance together, every derivative taken under
``torch.func.vmap`` over the batch. The user's f(x, p) and g(x, p) keep
the per-program signature: x is (n,), p is (n_p,).

Each program's iterate, barrier, iteration count and KKT error stop where
its own loop would stop (the JAX ``while_loop`` under ``vmap``): the batch
runs until its slowest program, and a converged one is carried unchanged.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.func import grad, hessian, jacfwd, vmap

from ..core.model import _device_matrix, resolve_device
from .ip_solver import _eigh

BIG = 1e20


@dataclasses.dataclass(frozen=True)
class DenseIPOptions:
    max_iter: int = 60
    tol: float = 1e-8
    mu_init: float = 1e-1
    n_linesearch: int = 12
    reg: float = 1e-9


class DenseSolution(NamedTuple):
    x: torch.Tensor           # (B, n)
    f: torch.Tensor           # (B,)
    g: torch.Tensor           # (B, m)
    kkt_error: torch.Tensor   # (B,)
    iterations: torch.Tensor  # (B,) int32
    converged: torch.Tensor   # (B,) bool


def _max0(v):
    """Row maximum floored at 0 (``jnp.max(..., initial=0.0)``), also of an
    empty row."""
    return torch.cat([v, v.new_zeros(v.shape[0], 1)], dim=1).amax(dim=1)


def _clip_bound(v):
    """Infinite bounds as +-1e20 (NaN as 0, as ``jnp.nan_to_num``)."""
    return torch.clamp(torch.nan_to_num(v, nan=0.0, neginf=-BIG, posinf=BIG), -BIG, BIG)


def solve_dense_nlp(f: Callable, g: Optional[Callable], n: int, m: int,
                    x0, p, lbx, ubx, lbg, ubg,
                    options: DenseIPOptions = DenseIPOptions()) -> DenseSolution:
    """Dense slack-based interior point on B programs at once.

    f(x, p) -> scalar and g(x, p) -> (m,) per program; x0 (B, n), p (B, n_p),
    lbx/ubx (B, n), lbg/ubg (B, m) tensors of one dtype on one device (a
    bound without the leading B is shared by the batch)."""
    opt = options
    x0 = torch.as_tensor(x0)
    B = x0.shape[0]
    kw = dict(dtype=x0.dtype, device=x0.device)

    def rows(v, k):
        return torch.as_tensor(v, **kw).expand(B, k)

    p = torch.as_tensor(p, **kw)
    p = (p.reshape(1, p.numel()) if p.dim() < 2 else p).expand(B, -1)
    lbx, ubx = _clip_bound(rows(lbx, n)), _clip_bound(rows(ubx, n))
    has_g = g is not None and m > 0
    if has_g:
        lbg, ubg = _clip_bound(rows(lbg, m)), _clip_bound(rows(ubg, m))
    else:
        lbg = ubg = x0.new_zeros(B, 0)
    n_c = 2 * n + 2 * m
    mask = torch.cat([ubx.abs() < BIG, lbx.abs() < BIG, ubg.abs() < BIG,
                      lbg.abs() < BIG], dim=1)
    mask_f = mask.to(x0.dtype)

    # per-program functions (x (n,), p, bounds (rows,), mask (n_c,))
    def cons_m(x, pp, lx, ux, lg, ug, mk):
        parts = [x - ux, lx - x]
        if has_g:
            gv = g(x, pp)
            parts += [gv - ug, lg - gv]
        return torch.where(mk, torch.cat(parts), -1.0)

    def lag_c(x, pp, lx, ux, lg, ug, mk, zm):
        return torch.dot(cons_m(x, pp, lx, ux, lg, ug, mk), zm)

    consts = (p, lbx, ubx, lbg, ubg, mask)
    v_obj = vmap(f)
    v_grad = vmap(grad(f))
    v_hess = vmap(hessian(f))
    v_cons = vmap(cons_m)
    v_jac = vmap(jacfwd(cons_m))
    v_lag_hess = vmap(hessian(lag_c))

    def merit(x, s, mu, nu, c):
        """The barrier merit of (x, s) with the constants ``c`` of each row."""
        bar = -mu * torch.sum(torch.log(torch.clamp(s, min=1e-30)) * c[-1].to(s.dtype),
                              dim=1)
        viol = torch.sum(torch.abs((v_cons(x, *c) + s) * c[-1].to(s.dtype)), dim=1)
        return v_obj(x, c[0]) + bar + nu * viol

    x = x0.clone()
    c0 = v_cons(x, *consts)
    s = torch.clamp(c0.abs(), min=1e-4)     # violated rows get scale-sized slacks
    mu = torch.full((B,), opt.mu_init, **kw)
    z = mu[:, None] / s * mask_f + (1 - mask_f)
    nu = torch.full((B,), 10.0, **kw)
    kkt = torch.full((B,), float("inf"), **kw)
    it = torch.zeros(B, dtype=torch.int32, device=x0.device)
    converged = torch.zeros(B, dtype=torch.bool, device=x0.device)
    L = opt.n_linesearch
    halves = 0.5 ** torch.arange(L, **kw)
    # the trial points' constants: each program's repeated L times
    consts_ls = tuple(a.repeat_interleave(L, dim=0) for a in consts)
    eye_idx = torch.arange(B, device=x0.device)

    while True:
        active = (it < opt.max_iter) & ~converged
        if not bool(active.any()):
            break
        gx = v_grad(x, p)
        H = v_hess(x, p)
        C = v_jac(x, *consts)
        c = v_cons(x, *consts)
        zm = z * mask_f
        # general-constraint curvature enters through the multipliers
        if has_g:
            H = H + v_lag_hess(x, *consts, zm)
        Ct = C.transpose(1, 2)
        # convergence on the current iterate
        r_stat = gx + (Ct @ zm[:, :, None])[..., 0]
        r_ineq = (c + s) * mask_f
        sz = s * z * mask_f
        s_d = torch.clamp(torch.sum(zm.abs(), dim=1) / max(n_c, 1), min=1.0)
        stat = r_stat.abs().amax(dim=1) / s_d
        err0 = torch.maximum(stat, torch.maximum(_max0(r_ineq.abs()),
                                                 _max0(sz.abs()) / s_d))
        err_mu = torch.maximum(stat, torch.maximum(
            _max0(r_ineq.abs()), _max0((sz - mu[:, None] * mask_f).abs()) / s_d))
        conv_now = err0 <= opt.tol
        mu_n = torch.where(err_mu <= 10.0 * mu,
                           torch.clamp(torch.minimum(0.2 * mu, mu ** 1.5),
                                       min=opt.tol / 10), mu)

        sigma = torch.where(mask, z / s, 0.0)
        zhat = torch.where(mask, (mu_n[:, None] + z * r_ineq) / s, 0.0)
        Hbar = H + (Ct * sigma[:, None, :]) @ C
        # symmetrize + regularize; eigenvalue clip for nonconvex objectives
        Hbar = 0.5 * (Hbar + Hbar.transpose(1, 2))
        w, V = _eigh(Hbar) if Hbar.is_cuda else torch.linalg.eigh(Hbar)
        w = torch.clamp(w, min=opt.reg + 1e-8)
        gbar = gx + (Ct @ zhat[:, :, None])[..., 0]
        dx = -((V * (1.0 / w)[:, None, :]) @ (V.transpose(1, 2) @ gbar[:, :, None]))[..., 0]
        dc = (C @ dx[:, :, None])[..., 0]
        ds = torch.where(mask, -r_ineq - dc, 0.0)
        dz = torch.where(mask, (mu_n[:, None] - s * z - z * ds) / s, 0.0)

        tau = torch.clamp(1.0 - mu_n, min=0.99)[:, None]

        def max_step(v, dv):
            ratio = torch.where((dv < 0) & mask,
                                -tau * v / torch.clamp(dv, max=-1e-30), 1.0)
            return torch.clamp(_min1(ratio), max=1.0)

        a_s = max_step(s, ds)
        a_z = max_step(z, dz)
        z_new_inf = _max0((z + dz).abs())
        nu_new = torch.maximum(nu, 1.5 * z_new_inf + 1.0)

        alphas = a_s[:, None] * halves                       # (B, L)
        rep = lambda v: v.repeat_interleave(L, dim=0)        # noqa: E731
        a_flat = alphas.reshape(-1, 1)
        phis = merit(rep(x) + a_flat * rep(dx), rep(s) + a_flat * rep(ds),
                     rep(mu_n), rep(nu_new), consts_ls).reshape(B, L)
        phi0 = merit(x, s, mu_n, nu_new, consts)
        ok = (phis <= (phi0 + 1e-12 * (1 + phi0.abs()))[:, None]) & torch.isfinite(phis)
        first_ok = torch.argmax(ok.to(torch.int32), dim=1)
        best = torch.argmin(torch.where(torch.isfinite(phis), phis, float("inf")), dim=1)
        alpha = torch.where(ok.any(dim=1), alphas[eye_idx, first_ok],
                            alphas[eye_idx, best])

        x_n = x + alpha[:, None] * dx
        s_n = torch.clamp(torch.where(mask, s + alpha[:, None] * ds, 1.0), min=1e-30)
        z_n = torch.clamp(torch.where(mask, z + a_z[:, None] * dz, 1.0), min=1e-30)
        bad = ~torch.isfinite(x_n).all(dim=1)
        move = (active & ~(conv_now | bad))[:, None]
        x = torch.where(move, x_n, x)
        s = torch.where(move, s_n, s)
        z = torch.where(move, z_n, z)
        mu = torch.where(active, mu_n, mu)
        nu = torch.where(active, nu_new, nu)
        kkt = torch.where(active, err0, kkt)
        it = it + active.to(torch.int32)
        converged = torch.where(active, conv_now, converged)

    gv = _g_vals(g, m, x, p)
    return DenseSolution(x=x, f=v_obj(x, p), g=gv, kkt_error=kkt, iterations=it,
                         converged=converged)


def _min1(v):
    """Row minimum capped at 1 (``jnp.min(..., initial=1.0)``)."""
    return torch.cat([v, v.new_ones(v.shape[0], 1)], dim=1).amin(dim=1)


def _g_vals(g, m, x, p):
    """g at the B programs' x: (B, m), (B, 0) without constraints."""
    if g is None or not m:
        return x.new_zeros(x.shape[0], 0)
    return vmap(g)(x, p)


def _n_args(fn) -> int:
    try:
        return len(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        return 2


def _as_tensor_out(v):
    """A user function's value as one tensor (a list of entries stacked)."""
    if isinstance(v, (list, tuple)):
        return torch.stack([torch.as_tensor(e) for e in v])
    return torch.as_tensor(v)


class NonlinearProgram:
    """User-facing NLP: set the decision variables, the objective and the
    constraints, ``setup`` on a device and dtype, then ``solve`` one
    program or ``solve_batch`` B of them."""

    _program_type = "NLP"

    def __init__(self, name: Optional[str] = None, solver: Optional[str] = None):
        self.name = name or self._program_type.lower()
        self._n = 0
        self._n_p = 0
        self._m = 0
        self._m_given: Optional[int] = None
        self._f: Optional[Callable] = None
        self._g: Optional[Callable] = None
        self._lb_raw = self._ub_raw = None
        self._lbg = None
        self._ubg = None
        self._setup_done = False
        self._opts = DenseIPOptions()
        self._device = torch.device("cpu")
        self._dtype = torch.float64
        self.stats: dict = {}

    def set_decision_variables(self, n_or_names):
        if isinstance(n_or_names, (int, np.integer)):
            self._n = int(n_or_names)
            self._var_names = [f"x_{i}" for i in range(self._n)]
        else:
            names = ([n_or_names] if isinstance(n_or_names, str)
                     else list(n_or_names))
            self._var_names = names
            self._n = len(names)
        return self

    def set_parameters(self, n_or_names):
        if isinstance(n_or_names, (int, np.integer)):
            self._n_p = int(n_or_names)
        else:
            names = ([n_or_names] if isinstance(n_or_names, str)
                     else list(n_or_names))
            self._n_p = len(names)
        return self

    def set_objective(self, fn: Callable):
        """fn(x) or fn(x, p) -> scalar, x of shape (n,)."""
        if _n_args(fn) == 1:
            self._f = lambda x, p: _as_tensor_out(fn(x)).squeeze()
        else:
            self._f = lambda x, p: _as_tensor_out(fn(x, p)).squeeze()
        return self

    def set_constraints(self, fn: Callable, lb=None, ub=None, n: Optional[int]
                        = None):
        """fn(x) or fn(x, p) -> (m,), with lbg <= fn <= ubg. Without ``n``
        the row count is read from one call on zeros at ``setup``, in the
        program's dtype and device."""
        if _n_args(fn) == 1:
            self._g = lambda x, p: torch.atleast_1d(_as_tensor_out(fn(x)))
        else:
            self._g = lambda x, p: torch.atleast_1d(_as_tensor_out(fn(x, p)))
        self._m_given = None if n is None else int(n)
        self._lb_raw, self._ub_raw = lb, ub
        if n is not None:
            self._set_rows(int(n))
        return self

    def _set_rows(self, n):
        self._m = n
        lb, ub = self._lb_raw, self._ub_raw
        self._lbg = (np.full(n, -np.inf) if lb is None
                     else np.broadcast_to(np.asarray(lb, float).ravel(), (n,)))
        self._ubg = (np.full(n, np.inf) if ub is None
                     else np.broadcast_to(np.asarray(ub, float).ravel(), (n,)))

    def setup(self, options: Optional[dict] = None, solver: Optional[str] = None,
              device="cuda", dtype=torch.float64, **kwargs):
        """Fix the options, the device and the dtype. The dtype defaults to
        float64: the default tolerance 1e-8 is out of float32's reach. A
        CUDA device that PyTorch cannot see raises."""
        if self._f is None:
            raise RuntimeError("set_objective first")
        if self._n == 0:
            raise RuntimeError("set_decision_variables first")
        options = options or {}
        self._opts = DenseIPOptions(
            max_iter=options.get("max_iter", 60),
            tol=options.get("tol", 1e-8),
        )
        self._device = resolve_device(device)
        self._dtype = dtype
        if self._g is not None and self._m_given is None:
            kw = dict(dtype=dtype, device=self._device)
            out = self._g(torch.zeros(self._n, **kw), torch.zeros(self._n_p, **kw))
            self._set_rows(int(out.shape[0]))
        self._setup_done = True
        return self

    def is_setup(self):
        return self._setup_done

    def _tensor(self, a):
        return torch.as_tensor(np.array(a, dtype=float), dtype=self._dtype,
                               device=self._device)

    def solve_batch(self, x0=None, p=None, lbx=None, ubx=None, lbg=None, ubg=None,
                    batch: Optional[int] = None) -> DenseSolution:
        """B programs at once: x0 (B, n), p (B, n_p), bounds (B, ...) or
        shared; numpy or tensors. Returns the DenseSolution of tensors on
        the program's device."""
        if not self._setup_done:
            self.setup()
        n, m = self._n, self._m

        def arg(v, default, k):
            v = default if v is None else v
            t = (v.to(dtype=self._dtype, device=self._device) if torch.is_tensor(v)
                 else self._tensor(v))
            return t.reshape(-1, k) if k else t.new_zeros(1, 0)

        B = batch or max((int(np.shape(v)[0]) for v in (x0, p, lbx, ubx, lbg, ubg)
                          if v is not None and len(np.shape(v)) > 1), default=1)
        x0 = arg(x0, np.zeros(n), n).expand(B, n).contiguous()
        p = arg(p, np.zeros(self._n_p), self._n_p).expand(B, self._n_p)
        lbx = arg(lbx, np.full(n, -np.inf), n)
        ubx = arg(ubx, np.full(n, np.inf), n)
        lbg = arg(lbg, self._lbg if m else np.zeros(0), m)
        ubg = arg(ubg, self._ubg if m else np.zeros(0), m)
        return solve_dense_nlp(self._f, self._g, n, m, x0, p, lbx, ubx, lbg, ubg,
                               options=self._opts)

    def solve(self, x0=None, p=None, lbx=None, ubx=None, lbg=None, ubg=None):
        """One program: returns {"x", "f", "g", "success"} (numpy and
        floats) and fills ``stats``."""
        n = self._n

        def one(v, k):
            return None if v is None else np.broadcast_to(np.asarray(v, float).ravel(), (k,))

        if not self._setup_done:
            self.setup()
        m = self._m
        sol = self.solve_batch(x0=None if x0 is None else np.asarray(x0, float).ravel(),
                               p=None if p is None else np.asarray(p, float).ravel(),
                               lbx=one(lbx, n), ubx=one(ubx, n),
                               lbg=one(lbg, m) if m else None,
                               ubg=one(ubg, m) if m else None, batch=1)
        self.stats = {
            "iterations": int(sol.iterations[0]),
            "kkt_error": float(sol.kkt_error[0]),
            "converged": bool(sol.converged[0]),
        }
        return {"x": sol.x[0].cpu().numpy(), "f": float(sol.f[0]),
                "g": sol.g[0].cpu().numpy(), "success": bool(sol.converged[0])}


class QuadraticProgram(NonlinearProgram):
    """min 1/2 xᵀHx + cᵀx s.t. bounds + linear constraints."""

    _program_type = "QP"

    def set_quadratic_objective(self, H, c=None):
        H = np.atleast_2d(np.asarray(H, dtype=float))
        if self._n == 0:
            self.set_decision_variables(H.shape[0])
        c = np.zeros(H.shape[0]) if c is None else np.asarray(c, float).ravel()
        H_of, c_of = _device_matrix(H), _device_matrix(c)
        self.set_objective(lambda x: 0.5 * x @ H_of(x) @ x + c_of(x) @ x)
        return self

    def set_linear_constraints(self, A, lb=None, ub=None):
        A = np.atleast_2d(np.asarray(A, dtype=float))
        A_of = _device_matrix(A)
        self.set_constraints(lambda x: A_of(x) @ x, lb=lb, ub=ub, n=A.shape[0])
        return self


class LinearProgram(QuadraticProgram):
    """min cᵀx s.t. bounds + linear constraints."""

    _program_type = "LP"

    def set_linear_objective(self, c):
        c = np.asarray(c, dtype=float).ravel()
        if self._n == 0:
            self.set_decision_variables(c.size)
        c_of = _device_matrix(c)
        self.set_objective(lambda x: c_of(x) @ x)
        return self


NLP = NonlinearProgram
QP = QuadraticProgram
LP = LinearProgram
