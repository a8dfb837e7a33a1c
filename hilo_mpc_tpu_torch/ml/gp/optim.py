"""Batched first-order and quasi-Newton minimizers for GP fits.

The JAX package fits a GP array with ``jax.vmap`` over ``optax.lbfgs`` or
``optax.adam`` inside ``lax.scan`` (hilo_mpc_tpu/ml/gp/gp.py:951-988). Here
the same algorithms run over a stack of G problems at once, (G, P)
parameter rows, every step one batched evaluation of all rows:

- ``adam``: optax's update (b1 0.9, b2 0.999, eps 1e-8, bias-corrected
  moments), optionally clipped to bounds after each step;
- ``lbfgs``: optax 0.2.6's ``lbfgs(learning_rate=None)``: the two-loop
  recursion over a memory of 10 differences with the scaled initial
  preconditioner (the first step scaled by min(1, 1/|g|)), and the zoom line
  search (Nocedal & Wright alg. 3.5/3.6 with Hager-Zhang's approximate
  decrease test: slope_rtol 1e-4, curv_rtol 0.9, approx_dec_rtol 1e-6,
  interval threshold 1e-5, at most 20 steps, initial step 1, doubling while
  it searches an interval, cubic then quadratic then bisection inside it,
  the safe step with sufficient decrease kept when it fails). The iterate
  is clipped to the bounds after each step, and the next iteration reuses
  the line search's value and gradient at the unclipped point, as
  ``optax.value_and_grad_from_state`` does there. Each row runs its own
  line search; finished rows are held by masks, so the rows follow the
  same steps as separate runs would.

``vag(W) -> (grads (G, P), values (G,))`` evaluates all rows.
"""
from __future__ import annotations

import math

import torch

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def _clip(W, lb, ub):
    if lb is None:
        return W
    return torch.minimum(torch.maximum(W, lb), ub)


def adam(grad_fn, W0, max_iter: int, learning_rate: float, lb=None, ub=None):
    """``max_iter`` Adam steps from W0; ``grad_fn(W, k) -> (grads, values)``
    at step k. Returns (W, the values at the start of the last step)."""
    W = W0
    mu = torch.zeros_like(W0)
    nu = torch.zeros_like(W0)
    vals = None
    for k in range(1, max_iter + 1):
        g, vals = grad_fn(W, k - 1)
        mu = (1 - _B1) * g + _B1 * mu
        nu = (1 - _B2) * g ** 2 + _B2 * nu
        mu_hat = mu / (1 - _B1 ** k)
        nu_hat = nu / (1 - _B2 ** k)
        W = _clip(W + (-learning_rate) * (mu_hat / (torch.sqrt(nu_hat) + _EPS)), lb, ub)
    return W, vals


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    r1 = fb - fa - C * db
    r2 = fc - fa - C * dc
    A = (dc ** 2 * r1 + (-(db ** 2)) * r2) / denom
    B = (-(dc ** 3) * r1 + db ** 3 * r2) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * B)


def _where(c, a, b):
    return torch.where(c[:, None] if a.dim() == 2 else c, a, b)


class _Zoom:
    """The zoom line search's state for G rows along directions d."""

    TOL, SLOPE, CURV, APPROX, THRESH = 0.0, 1e-4, 0.9, 1e-6, 1e-5

    def __init__(self, value, grad, d):
        z = torch.zeros_like(value)
        slope = torch.sum(d * grad, dim=-1)
        self.count = torch.zeros(value.shape, dtype=torch.int64, device=value.device)
        self.stepsize, self.value, self.grad, self.slope = z, value, grad, slope
        self.value_init, self.slope_init = value, slope
        self.dec = torch.full_like(value, math.inf)
        self.found = torch.zeros_like(value, dtype=torch.bool)
        self.done = torch.zeros_like(self.found)
        self.failed = torch.zeros_like(self.found)
        self.low, self.v_low, self.s_low = z, value, slope
        self.high, self.v_high, self.s_high = z, value, slope
        self.cref, self.v_cref = z, value
        self.safe, self.v_safe, self.g_safe = z, value, grad

    def _errors(self, eta, v, s):
        dec = v - self.value_init - self.SLOPE * eta * self.slope_init
        approx = torch.maximum(s - (2 * self.SLOPE - 1.0) * self.slope_init,
                               v - self.value_init - self.APPROX * torch.abs(self.value_init))
        dec = torch.clamp(torch.minimum(approx, dec), min=0.0)
        dec = torch.where(torch.isnan(dec), math.inf, dec)
        curv = torch.clamp(torch.abs(s) - self.CURV * torch.abs(self.slope_init), min=0.0)
        curv = torch.where(torch.isnan(curv), math.inf, curv)
        return dec, torch.maximum(dec, curv)

    def step(self, w, d, vag, max_steps: int):
        """One step of every row that is neither done nor failed."""
        active = ~(self.done | self.failed)
        # the interval search's next stepsize
        eta_s = torch.where(self.count == 0, torch.ones_like(self.stepsize),
                            2.0 * self.stepsize)
        # the zoom's next stepsize
        low, high = self.low, self.high
        delta = torch.abs(high - low)
        left, right = torch.minimum(high, low), torch.maximum(high, low)
        mc = _cubicmin(low, self.v_low, self.s_low, high, self.v_high, self.cref,
                       self.v_cref)
        use_cubic = (mc > left + 0.2 * delta) & (mc < right - 0.2 * delta)
        mq = _quadmin(low, self.v_low, self.s_low, high, self.v_high)
        use_quad = ~use_cubic & (mq > left + 0.1 * delta) & (mq < right - 0.1 * delta)
        middle = torch.where(use_cubic, mc, self.cref)
        middle = torch.where(use_quad, mq, middle)
        middle = torch.where(~use_cubic & ~use_quad, (low + high) / 2.0, middle)
        eta = torch.where(self.found, middle, eta_s)

        g, v = vag(w + eta[:, None] * d)
        s = torch.sum(g * d, dim=-1)
        dec, err = self._errors(eta, v, s)
        done = err <= self.TOL
        last = self.count + 1 >= max_steps

        # -- interval search (rows not yet in an interval) --------------------
        safe_dec = dec <= self.TOL
        s_safe = torch.where(safe_dec, eta, self.safe)
        s_vsafe = torch.where(safe_dec, v, self.v_safe)
        s_gsafe = _where(safe_dec, g, self.g_safe)
        hi_new = (dec > 0.0) | ((v >= self.value) & (self.count > 0))
        lo_new = (s >= 0.0) & ~hi_new
        s_low = torch.where(lo_new, eta, self.stepsize)
        s_vlow = torch.where(lo_new, v, self.value)
        s_slow = torch.where(lo_new, s, self.slope)
        s_high = torch.where(lo_new, self.stepsize, eta)
        s_vhigh = torch.where(lo_new, self.value, v)
        s_shigh = torch.where(lo_new, self.slope, s)
        s_found = hi_new | lo_new | done
        s_failed = last & ~done

        # -- zoom (rows inside an interval) ------------------------------------
        upd_safe = (dec <= self.TOL) & (v < self.v_safe)
        z_safe = torch.where(upd_safe, eta, self.safe)
        z_vsafe = torch.where(upd_safe, v, self.v_safe)
        z_gsafe = _where(upd_safe, g, self.g_safe)
        h_mid = (dec > 0.0) | (v >= self.v_low)
        h_low = (s * (high - low) >= 0.0) & ~h_mid
        l_mid = ~h_mid
        z_high = torch.where(h_low, low, torch.where(h_mid, eta, high))
        z_vhigh = torch.where(h_low, self.v_low, torch.where(h_mid, v, self.v_high))
        z_shigh = torch.where(h_low, self.s_low, torch.where(h_mid, s, self.s_high))
        z_low = torch.where(l_mid, eta, low)
        z_vlow = torch.where(l_mid, v, self.v_low)
        z_slow = torch.where(l_mid, s, self.s_low)
        moved_high = h_mid | h_low
        z_cref = torch.where(moved_high, high, low)
        z_vcref = torch.where(moved_high, self.v_high, self.v_low)
        z_failed = (last | ((delta <= self.THRESH) & (z_safe > 0.0))) & ~done

        zf = self.found
        new = dict(
            low=torch.where(zf, z_low, s_low), v_low=torch.where(zf, z_vlow, s_vlow),
            s_low=torch.where(zf, z_slow, s_slow), high=torch.where(zf, z_high, s_high),
            v_high=torch.where(zf, z_vhigh, s_vhigh),
            s_high=torch.where(zf, z_shigh, s_shigh),
            safe=torch.where(zf, z_safe, s_safe), v_safe=torch.where(zf, z_vsafe, s_vsafe),
            g_safe=_where(zf, z_gsafe, s_gsafe), failed=torch.where(zf, z_failed, s_failed),
            found=torch.where(zf, self.found, s_found), done=done, dec=dec,
            stepsize=eta, value=v, grad=g, slope=s, count=self.count + 1)
        new["cref"] = torch.where(zf, z_cref, new["low"])
        new["v_cref"] = torch.where(zf, z_vcref, new["v_low"])
        # a failed search falls back to the safe step (sufficient decrease),
        # or to it whenever the last trial left the function's domain
        use_safe = new["failed"] & ((new["safe"] > 0.0) | torch.isinf(dec))
        new["stepsize"] = torch.where(use_safe, new["safe"], eta)
        new["value"] = torch.where(use_safe, new["v_safe"], v)
        new["grad"] = _where(use_safe, new["g_safe"], g)
        for k, val in new.items():
            setattr(self, k, _where(active, val, getattr(self, k)))


def lbfgs(vag, W0, lb, ub, max_iter: int, memory: int = 10, max_linesearch: int = 20):
    """``max_iter`` L-BFGS iterations from W0 (G, P) within [lb, ub].
    Returns (W, the values at the start of the last iteration)."""
    G, P = W0.shape
    S = torch.zeros((memory, G, P), dtype=W0.dtype, device=W0.device)
    Yd = torch.zeros_like(S)
    rho = torch.zeros((memory, G), dtype=W0.dtype, device=W0.device)
    w = W0
    prev_w = prev_g = None
    ls_value = ls_grad = None
    value = None
    for k in range(max_iter):
        if ls_value is None or bool((~torch.isfinite(ls_value)).any()):
            g_new, v_new = vag(w)
            if ls_value is None:
                value, grad = v_new, g_new
            else:
                fresh = ~torch.isfinite(ls_value)
                value = torch.where(fresh, v_new, ls_value)
                grad = _where(fresh, g_new, ls_grad)
        else:
            value, grad = ls_value, ls_grad
        if k > 0:
            dp, du = w - prev_w, grad - prev_g
            vdot = torch.sum(du * dp, dim=-1)
            j = (k - 1) % memory
            S[j], Yd[j] = dp, du
            rho[j] = torch.where(vdot == 0.0, torch.zeros_like(vdot), 1.0 / vdot)
            den = torch.sum(du * du, dim=-1)
            gamma = torch.where(den > 0.0, vdot / den, torch.ones_like(den))
        else:
            gamma = torch.clamp(1.0 / torch.linalg.vector_norm(grad, dim=-1), max=1.0)
        order = [(k + j) % memory for j in range(memory)]
        vec, alphas = grad, {}
        for j in reversed(order):
            alphas[j] = rho[j] * torch.sum(S[j] * vec, dim=-1)
            vec = vec + (-alphas[j])[:, None] * Yd[j]
        vec = gamma[:, None] * vec
        for j in order:
            beta = rho[j] * torch.sum(Yd[j] * vec, dim=-1)
            vec = vec + (alphas[j] - beta)[:, None] * S[j]
        d = -vec
        ls = _Zoom(value, grad, d)
        for _ in range(max_linesearch):
            if not bool((~(ls.done | ls.failed)).any()):
                break
            ls.step(w, d, vag, max_linesearch)
        prev_w, prev_g = w, grad
        w = _clip(w + ls.stepsize[:, None] * d, lb, ub)
        ls_value, ls_grad = ls.value, ls.grad
    return w, value
