"""GP inference methods.

PyTorch port of ``hilo_mpc_tpu/ml/gp/inference.py``: exact inference
(Rasmussen & Williams alg. 2.1), the Laplace approximation (GPML 3.1/3.2),
expectation propagation (GPML 3.5/3.6, parallel form), the sparse FITC and
VFE approximations, the variational Gaussian (KL, Opper & Archambeau), the
Jaakkola-Jordan bound (VB) and stochastic variational inference (SVGP,
Hensman et al.). The states and objectives take one data set, X (n, d) and
y (n,) (a batched fit maps them with ``torch.func.vmap``); every ``predict``
is batch-first, x_star (..., d) -> (mu, var) each (...). Everything is
traceable under ``torch.func`` (fixed trip counts, ``torch.where`` guards,
no host reads), so the objectives differentiate through the mode search,
the sweeps and the Cholesky factors, and a prediction runs under the
interior point's nested ``jvp``/``vmap``.

Numbers follow the JAX package: the dtype-aware jitter floors (exact 1e-6
float32 / 1e-12 float64, Laplace's gram 1e-10 in float64, the inducing
gram 1e-5 / 1e-8), the variance floor eps·k(x, x), and a failed Cholesky
reads NaN (``cholesky_ex`` with its info flag kept on the device), as JAX's
factor does. JAX runs GP products at "highest" precision; here the callers
in ml/gp/gp.py turn TF32 off around them (``full_precision``).
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import grad

_LOG_2PI = math.log(2 * math.pi)


@contextlib.contextmanager
def full_precision():
    """TF32 off for every product inside, the caller's flags restored after:
    reduced-precision products flip posterior variances negative."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def vmax(x, c):
    """jnp.maximum(x, c): at a tie the derivative splits evenly (torch.clamp
    would pass all of it), which the interior point's Newton steps see."""
    return torch.maximum(x, x.new_tensor(c))


def vmin(x, c):
    return torch.minimum(x, x.new_tensor(c))


def _f32(t) -> bool:
    return t.dtype == torch.float32


def chol(K):
    """Lower Cholesky factor, NaN where the matrix is not positive definite."""
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where((info == 0)[..., None, None], L, torch.full_like(L, math.nan))


def cho_solve(L, b):
    return torch.cholesky_solve(b[..., None], L)[..., 0]


def tri_solve(L, B):
    """L^{-1} B for a matrix B."""
    return torch.linalg.solve_triangular(L, B, upper=False)


def tri_rows(L, K):
    """Rows of L^{-1} k for K (..., n): each row k of K solved, as one
    right-sided solve V Lᵀ = K over the rows (cuBLAS's left-sided solve with
    more than 65,535 right-hand sides takes a path ~10 s long on an H100)."""
    n = K.shape[-1]
    return torch.linalg.solve_triangular(L.mT, K.reshape(-1, n), upper=True,
                                         left=False).reshape(K.shape)


def _pick(values, idx):
    """values[idx] for a 0-d index tensor (traceable under vmap)."""
    return torch.take_along_dim(values, idx.reshape(1), 0)[0]


def _mean_at(mean, params, X):
    return mean.eval(params, X)


def k_star(kernel, params, X, x_star):
    """k(X_i, x*) for X (n, d), x_star (..., d): (..., n)."""
    return kernel.eval(params, X, x_star[..., None, :])


def _floor_var(var, k_ss):
    eps = 1e-6 if _f32(var) else 1e-12
    return torch.maximum(var, eps * k_ss)


def _diag_jitter(K, jitter):
    n = K.shape[-1]
    return K + jitter * torch.mean(torch.diagonal(K)) * torch.eye(
        n, dtype=K.dtype, device=K.device)


class Inference:
    pass


class ExactInference(Inference):
    @staticmethod
    def posterior_state(kernel, mean, params, X, y, noise_variance, jitter=None):
        """(L, alpha, resid) for training data X (n, d), y (n,), with the
        dtype-aware jitter floor relative to the gram diagonal."""
        n = X.shape[0]
        K = kernel.gram(params, X)
        if jitter is None:
            jitter = 1e-6 if _f32(K) else 1e-12
        floor = jitter * torch.mean(torch.diagonal(K))
        K = K + (noise_variance + floor) * torch.eye(n, dtype=K.dtype, device=K.device)
        L = chol(K)
        resid = y - _mean_at(mean, params, X)
        return L, cho_solve(L, resid), resid

    @staticmethod
    def log_marginal_likelihood(kernel, mean, params, X, y, noise_variance):
        n = X.shape[0]
        L, alpha, resid = ExactInference.posterior_state(
            kernel, mean, params, X, y, noise_variance)
        return (-0.5 * torch.dot(resid, alpha)
                - torch.sum(torch.log(torch.diagonal(L)))
                - 0.5 * n * _LOG_2PI)

    @staticmethod
    def predict(kernel, mean, params, X, L, alpha, x_star, noise_variance,
                include_noise=False):
        """Posterior mean and variance at x_star (..., d)."""
        ks = k_star(kernel, params, X, x_star)
        mu = mean.eval(params, x_star) + ks @ alpha
        v = tri_rows(L, ks)
        k_ss = kernel.eval(params, x_star, x_star)
        var = _floor_var(k_ss - torch.sum(v * v, dim=-1), k_ss)
        if include_noise:
            var = var + noise_variance
        return mu, var


class Laplace(Inference):
    """Laplace approximation (GPML algorithms 3.1/3.2): a fixed-trip Newton
    mode search in the stable B = I + W^{1/2} K W^{1/2} form with a
    backtracking line search over eight halvings, differentiable through the
    search."""

    #: curvature floor for non-log-concave likelihoods (Student's t)
    W_FLOOR = 1e-8
    NEWTON_ITERS = 25

    @staticmethod
    def _gram(kernel, params, X):
        K = kernel.gram(params, X)
        return _diag_jitter(K, 1e-6 if _f32(K) else 1e-10)

    @staticmethod
    def mode_state(kernel, mean, params, X, y, sn2, likelihood, iters: int = None):
        """``(f_hat, g, sW, L, lml)``: the mode, grad log p(y|f_hat),
        W^{1/2}, chol(I + sW K sW) and the Laplace log marginal likelihood."""
        iters = Laplace.NEWTON_ITERS if iters is None else iters
        n = X.shape[0]
        K = Laplace._gram(kernel, params, X)
        m = _mean_at(mean, params, X)
        y = torch.as_tensor(y).to(K)

        def lp_sum(f):
            return torch.sum(likelihood.log_pdf(f, y, sn2))

        grad_lp = grad(lp_sum)

        def curvature(f):
            d2 = grad(lambda ff: torch.sum(grad_lp(ff)))(f)
            return vmax(-d2, Laplace.W_FLOOR)

        eye = torch.eye(n, dtype=K.dtype, device=K.device)
        alphas = 0.5 ** torch.arange(8, dtype=K.dtype, device=K.device)
        f, a = m, torch.zeros_like(m)
        for _ in range(iters):
            W = curvature(f)
            sW = torch.sqrt(W)
            L = chol(eye + sW[:, None] * K * sW[None, :])
            b = W * (f - m) + grad_lp(f)
            t = cho_solve(L, sW * (K @ b))
            a_full = b - sW * t
            f_full = K @ a_full + m
            # backtracking on psi(f) = log p(y|f) - 0.5 (f-m)' K^-1 (f-m),
            # candidates interpolated linearly in (a, f)
            al = alphas[:, None]
            a_c = (1.0 - al) * a + al * a_full
            f_c = (1.0 - al) * f + al * f_full
            v = (torch.sum(likelihood.log_pdf(f_c, y, sn2), dim=-1)
                 - 0.5 * torch.sum(a_c * (f_c - m), dim=-1))
            vals = torch.where(torch.isfinite(v), v, -math.inf)
            best = torch.argmax(vals)
            al = _pick(alphas, best)
            f_new = (1.0 - al) * f + al * f_full
            a_new = (1.0 - al) * a + al * a_full
            ok = torch.all(torch.isfinite(f_new)) & (_pick(vals, best) > -math.inf)
            f, a = torch.where(ok, f_new, f), torch.where(ok, a_new, a)

        W = curvature(f)
        sW = torch.sqrt(W)
        L = chol(eye + sW[:, None] * K * sW[None, :])
        g = grad_lp(f)
        b = W * (f - m) + g
        t = cho_solve(L, sW * (K @ b))
        a = b - sW * t
        lml = (-0.5 * torch.dot(a, f - m) + torch.sum(likelihood.log_pdf(f, y, sn2))
               - torch.sum(torch.log(torch.diagonal(L))))
        return f, g, sW, L, lml

    @staticmethod
    def log_marginal_likelihood(kernel, mean, params, X, y, sn2, likelihood,
                                iters: int = None):
        return Laplace.mode_state(kernel, mean, params, X, y, sn2, likelihood,
                                  iters=iters)[4]

    @staticmethod
    def predict(kernel, mean, params, X, g, sW, L, x_star):
        """Latent posterior (mu, var) at x_star (..., d) (GPML alg. 3.2)."""
        ks = k_star(kernel, params, X, x_star)
        mu = mean.eval(params, x_star) + ks @ g
        v = tri_rows(L, sW * ks)
        k_ss = kernel.eval(params, x_star, x_star)
        return mu, _floor_var(k_ss - torch.sum(v * v, dim=-1), k_ss)


def _log_erfc(x):
    """Stable log(erfc(x)): direct below the underflow knee, the erfcx
    asymptotic series beyond it."""
    xs = vmax(x, 5.0)
    asym = (-xs * xs - torch.log(xs) - 0.5 * math.log(math.pi)
            + torch.log1p(-0.5 / (xs * xs) + 0.75 / (xs * xs * xs * xs)))
    direct = torch.log(torch.special.erfc(vmin(x, 5.0)))
    return torch.where(x < 5.0, direct, asym)


def _log_ncdf(z):
    """Stable log Phi(z) = log(erfc(-z/sqrt(2))) - log 2."""
    return _log_erfc(-z / math.sqrt(2.0)) - math.log(2.0)


def _norm_logpdf(z):
    return -0.5 * z * z - 0.5 * _LOG_2PI


class ExpectationPropagation(Inference):
    """Parallel expectation propagation (GPML algorithms 3.5/3.6) for probit
    classification (closed-form moments) and Laplacian robust regression
    (the Gaussian-x-Laplacian tilted moments, their mean and variance from
    derivatives of log Z); damped site updates, differentiable through the
    sweeps."""

    SWEEPS = 40
    DAMPING = 0.7
    TAU_FLOOR = 1e-10

    @staticmethod
    def site_state(kernel, mean, params, X, y, sweeps: int = None,
                   damping: float = None, likelihood=None, sn2=None):
        """``(w, sqrt_tau, L, lml)``: w = K^{-1}(mu_post - m), the site
        precisions' square roots, chol(I + S^{1/2} K S^{1/2}) and the EP log
        marginal likelihood."""
        sweeps = ExpectationPropagation.SWEEPS if sweeps is None else sweeps
        damping = ExpectationPropagation.DAMPING if damping is None else damping
        n = X.shape[0]
        K = Laplace._gram(kernel, params, X)
        m = _mean_at(mean, params, X)
        y = torch.as_tensor(y).to(K)
        eye = torch.eye(n, dtype=K.dtype, device=K.device)
        floor = ExpectationPropagation.TAU_FLOOR
        lik_name = "probit" if likelihood is None else likelihood.name

        def posterior(tt, tn):
            stt = torch.sqrt(tt)
            L = chol(eye + stt[:, None] * K * stt[None, :])
            V = tri_solve(L, stt[:, None] * K)
            Sigma = K - V.T @ V
            return Sigma, m + Sigma @ (tn - tt * m), L

        def cavity(Sigma, mu, tt, tn):
            sig2 = torch.diagonal(Sigma)
            return vmax(1.0 / sig2 - tt, floor), mu / sig2 - tn

        def probit_moments(tau_c, nu_c):
            mu_c = nu_c / tau_c
            s2_c = 1.0 / tau_c
            denom = torch.sqrt(1.0 + s2_c)
            z = y * mu_c / denom
            logcdf = torch.special.log_ndtr(z)
            ratio = torch.exp(_norm_logpdf(z) - logcdf)
            mu_hat = mu_c + y * s2_c * ratio / denom
            s2_hat = s2_c - s2_c ** 2 * ratio * (z + ratio) / (1.0 + s2_c)
            return mu_hat, vmax(s2_hat, floor), logcdf

        def laplace_logZ(mu_c, s2_c):
            # log of the integral of Lap(y | f, b) N(f | mu_c, s2_c), split at
            # f = y into two exp-shifted normal CDFs, in log space
            b = math.sqrt(sn2 / 2.0) if not torch.is_tensor(sn2) else torch.sqrt(sn2 / 2.0)
            r = y - mu_c
            sig = torch.sqrt(s2_c)
            t1 = -r / b + _log_ncdf((r - s2_c / b) / sig)
            t2 = r / b + _log_ncdf(-(r + s2_c / b) / sig)
            log2b = torch.log(2.0 * b) if torch.is_tensor(b) else math.log(2.0 * b)
            return s2_c / (2.0 * b * b) - log2b + torch.logaddexp(t1, t2)

        def laplacian_moments(tau_c, nu_c):
            mu_c = nu_c / tau_c
            s2_c = 1.0 / tau_c
            logZ = laplace_logZ(mu_c, s2_c)
            alpha_fn = grad(lambda mu: torch.sum(laplace_logZ(mu, s2_c)))
            alpha = alpha_fn(mu_c)
            beta = grad(lambda mu: torch.sum(alpha_fn(mu)))(mu_c)
            mu_hat = mu_c + s2_c * alpha
            s2_hat = vmax(s2_c * (1.0 + s2_c * beta), floor)
            return mu_hat, s2_hat, logZ

        tilted = laplacian_moments if lik_name == "laplacian" else probit_moments

        tt = torch.full((n,), floor, dtype=K.dtype, device=K.device)
        tn = torch.zeros(n, dtype=K.dtype, device=K.device)
        for _ in range(sweeps):
            Sigma, mu, _ = posterior(tt, tn)
            tau_c, nu_c = cavity(Sigma, mu, tt, tn)
            mu_hat, s2_hat, _ = tilted(tau_c, nu_c)
            tt_new = vmax(1.0 / s2_hat - tau_c, floor)
            tn_new = mu_hat / s2_hat - nu_c
            tt_d = (1.0 - damping) * tt + damping * tt_new
            tn_d = (1.0 - damping) * tn + damping * tn_new
            ok = torch.all(torch.isfinite(tt_d)) & torch.all(torch.isfinite(tn_d))
            tt, tn = torch.where(ok, tt_d, tt), torch.where(ok, tn_d, tn)

        Sigma, mu, L = posterior(tt, tn)
        stt = torch.sqrt(tt)
        r = tn - tt * m
        w = r - stt * cho_solve(L, stt * (K @ r))

        tau_c, nu_c = cavity(Sigma, mu, tt, tn)
        _, _, log_phis = tilted(tau_c, nu_c)
        mu_c = nu_c / tau_c
        mu_site = tn / tt
        s_tot = 1.0 / tau_c + 1.0 / tt
        site_norm = 0.5 * (torch.log(2 * math.pi * s_tot)
                           + (mu_c - mu_site) ** 2 / s_tot)
        u = tri_solve(L, (stt * (mu_site - m))[:, None])[:, 0]
        log_det = 2.0 * torch.sum(torch.log(torch.diagonal(L))) - torch.sum(torch.log(tt))
        log_gauss = -0.5 * (n * _LOG_2PI + log_det + torch.dot(u, u))
        lml = torch.sum(log_phis + site_norm) + log_gauss
        return w, stt, L, lml

    @staticmethod
    def log_marginal_likelihood(kernel, mean, params, X, y, sweeps: int = None,
                                damping: float = None, likelihood=None, sn2=None):
        return ExpectationPropagation.site_state(
            kernel, mean, params, X, y, sweeps=sweeps, damping=damping,
            likelihood=likelihood, sn2=sn2)[3]

    @staticmethod
    def predict(kernel, mean, params, X, w, sqrt_tau, L, x_star):
        """Latent posterior (mu, var) at x_star (..., d) (GPML alg. 3.6)."""
        return Laplace.predict(kernel, mean, params, X, w, sqrt_tau, L, x_star)


class SparseFITC(Inference):
    """Sparse regression with inducing points, FITC (Snelson & Ghahramani
    2006): O(n m^2) with an m-sized predictive state; with Z = X it is exact
    inference."""

    @staticmethod
    def state(kernel, mean, params, X, y, Z, sn2):
        """``(Luu, La, beta, lml)``."""
        return _sparse_state(kernel, mean, params, X, y, Z, sn2, heteroscedastic=True)

    @staticmethod
    def log_marginal_likelihood(kernel, mean, params, X, y, Z, sn2):
        return SparseFITC.state(kernel, mean, params, X, y, Z, sn2)[3]

    @staticmethod
    def predict(kernel, mean, params, Z, Luu, La, beta, x_star, sn2,
                include_noise=False):
        """(mu, var) at x_star (..., d) from the m-sized state."""
        w = tri_rows(Luu, k_star(kernel, params, Z, x_star))
        t = tri_rows(La, w)
        mu = mean.eval(params, x_star) + t @ beta
        k_ss = kernel.eval(params, x_star, x_star)
        var = _floor_var(k_ss - torch.sum(w * w, dim=-1) + torch.sum(t * t, dim=-1),
                         k_ss)
        if include_noise:
            var = var + sn2
        return mu, var


def _inducing_jitter(K):
    return 1e-5 if _f32(K) else 1e-8


def _sparse_state(kernel, mean, params, X, y, Z, sn2, heteroscedastic):
    """The inducing-point algebra of FITC (lam_i = kff_i - [V'V]_ii + sn2)
    and VFE (lam_i = sn2 and the trace term tr(Kff - Qff)/(2 sn2))."""
    n, m = X.shape[0], Z.shape[0]
    Kuu = kernel.gram(params, Z)
    jitter = _inducing_jitter(Kuu)
    Kuu = _diag_jitter(Kuu, jitter)
    Kuf = kernel.gram(params, Z, X)
    kff = kernel.eval(params, X, X)
    Luu = chol(Kuu)
    V = tri_solve(Luu, Kuf)
    defect = vmax(kff - torch.sum(V * V, dim=0), 0.0)
    if heteroscedastic:
        lam = torch.maximum(defect + sn2, jitter * torch.mean(kff) + 1e-30)
        trace_penalty = 0.0
    else:
        lam = torch.zeros(n, dtype=Kuu.dtype, device=Kuu.device) + sn2
        trace_penalty = torch.sum(defect) / (2.0 * sn2)
    Vs = V / torch.sqrt(lam)[None, :]
    A = torch.eye(m, dtype=Kuu.dtype, device=Kuu.device) + Vs @ Vs.T
    La = chol(A)
    ytil = (torch.as_tensor(y).to(Kuu) - _mean_at(mean, params, X)) / torch.sqrt(lam)
    beta = tri_solve(La, (Vs @ ytil)[:, None])[:, 0]
    lml = -0.5 * (n * _LOG_2PI + torch.sum(torch.log(lam))
                  + 2.0 * torch.sum(torch.log(torch.diagonal(La)))
                  + torch.dot(ytil, ytil) - torch.dot(beta, beta)) - trace_penalty
    return Luu, La, beta, lml


class SparseVFE(Inference):
    """Titsias's variational free energy (AISTATS 2009): the FITC algebra
    with lam = sn2 and the trace regularizer, a lower bound on the exact
    LML (equal at Z = X)."""

    @staticmethod
    def state(kernel, mean, params, X, y, Z, sn2):
        return _sparse_state(kernel, mean, params, X, y, Z, sn2, heteroscedastic=False)

    @staticmethod
    def log_marginal_likelihood(kernel, mean, params, X, y, Z, sn2):
        return SparseVFE.state(kernel, mean, params, X, y, Z, sn2)[3]

    predict = staticmethod(SparseFITC.predict)


class KullbackLeibler(Inference):
    """Variational Gaussian inference (Opper & Archambeau 2009) for every
    likelihood: q = N(m + K nu, (K^{-1} + Lambda)^{-1}), Gauss-Hermite
    expectations with the score identities for their derivatives, damped
    lambda steps and a backtracked Newton step in nu; the ELBO is the fitting
    objective. The predictive state has Laplace's layout."""

    SWEEPS = 60
    DAMPING = 0.5
    GH_POINTS = 32
    LAM_FLOOR = 1e-8

    @staticmethod
    def _gh(like):
        t, w = np.polynomial.hermite.hermgauss(KullbackLeibler.GH_POINTS)
        return (torch.as_tensor(t, dtype=like.dtype, device=like.device),
                torch.as_tensor(w / np.sqrt(np.pi), dtype=like.dtype, device=like.device))

    @staticmethod
    def variational_state(kernel, mean, params, X, y, sn2, likelihood,
                          sweeps: int = None, damping: float = None):
        """``(nu, sqrt(lam), L, elbo)``."""
        sweeps = KullbackLeibler.SWEEPS if sweeps is None else sweeps
        damping = KullbackLeibler.DAMPING if damping is None else damping
        n = X.shape[0]
        K = Laplace._gram(kernel, params, X)
        m = _mean_at(mean, params, X)
        y = torch.as_tensor(y).to(K)
        eye = torch.eye(n, dtype=K.dtype, device=K.device)
        floor = KullbackLeibler.LAM_FLOOR
        t_gh, w_gh = KullbackLeibler._gh(K)
        sqrt2 = math.sqrt(2.0)
        diagK = torch.diagonal(K)

        def nodes(mu, s2):
            return mu[None, :] + sqrt2 * torch.sqrt(s2)[None, :] * t_gh[:, None]

        def E_sum(mu, s2):
            vals = likelihood.log_pdf(nodes(mu, s2), y[None, :], sn2)
            return torch.sum(w_gh[:, None] * vals)

        def E_derivs(mu, s2):
            sig = torch.sqrt(s2)
            wv = w_gh[:, None] * likelihood.log_pdf(nodes(mu, s2), y[None, :], sn2)
            e1 = torch.sum(wv * sqrt2 * t_gh[:, None], dim=0) / sig
            e2 = torch.sum(wv * (2.0 * t_gh[:, None] ** 2 - 1.0), dim=0) / (2.0 * s2)
            return e1, e2

        alphas = 0.5 ** torch.arange(8, dtype=K.dtype, device=K.device)

        def factor(lam):
            sl = torch.sqrt(lam)
            L = chol(eye + sl[:, None] * K * sl[None, :])
            V = tri_solve(L, sl[:, None] * K)
            return sl, L, vmax(diagK - torch.sum(V * V, dim=0), floor)

        nu = torch.zeros(n, dtype=K.dtype, device=K.device)
        lam = torch.ones(n, dtype=K.dtype, device=K.device)
        for _ in range(sweeps):
            sl, L, s2 = factor(lam)
            mu = K @ nu + m
            e1, e2 = E_derivs(mu, s2)
            lam_t = vmax(-2.0 * e2, floor)
            lam_new = (1.0 - damping) * lam + damping * lam_t
            r = e1 - nu
            nu_full = nu + (r - sl * cho_solve(L, sl * (K @ r)))
            mu_full = K @ nu_full + m
            al = alphas[:, None]
            nu_c = (1.0 - al) * nu + al * nu_full
            mu_c = (1.0 - al) * mu + al * mu_full
            vals_e = torch.sum(w_gh[None, :, None] * likelihood.log_pdf(
                mu_c[:, None, :] + sqrt2 * torch.sqrt(s2)[None, None, :]
                * t_gh[None, :, None], y[None, None, :], sn2), dim=(1, 2))
            v = vals_e - 0.5 * torch.sum(nu_c * (mu_c - m), dim=-1)
            vals = torch.where(torch.isfinite(v), v, -math.inf)
            best = torch.argmax(vals)
            a = _pick(alphas, best)
            nu_new = (1.0 - a) * nu + a * nu_full
            ok = (torch.all(torch.isfinite(nu_new)) & torch.all(torch.isfinite(lam_new))
                  & (_pick(vals, best) > -math.inf))
            nu, lam = torch.where(ok, nu_new, nu), torch.where(ok, lam_new, lam)

        sl, L, s2 = factor(lam)
        mu = K @ nu + m
        elbo = (E_sum(mu, s2) - torch.sum(torch.log(torch.diagonal(L)))
                - 0.5 * torch.dot(nu, mu - m) + 0.5 * torch.dot(lam, s2))
        return nu, sl, L, elbo

    @staticmethod
    def log_marginal_likelihood(kernel, mean, params, X, y, sn2, likelihood,
                                sweeps: int = None, damping: float = None):
        return KullbackLeibler.variational_state(
            kernel, mean, params, X, y, sn2, likelihood, sweeps=sweeps,
            damping=damping)[3]

    predict = staticmethod(Laplace.predict)


class VariationalBayes(Inference):
    """The Jaakkola-Jordan bound for logistic classification: coordinate
    ascent between the bounded Gaussian posterior and xi_i^2 = E_q[f_i^2];
    the final bound is the fitting objective, the predictive state Laplace's
    layout."""

    ITERS = 50
    XI_FLOOR = 1e-6

    @staticmethod
    def bound_state(kernel, mean, params, X, y, iters: int = None):
        """``(nu, sA, L, bound)``."""
        iters = VariationalBayes.ITERS if iters is None else iters
        n = X.shape[0]
        K = Laplace._gram(kernel, params, X)
        m = _mean_at(mean, params, X)
        y = torch.as_tensor(y).to(K)
        eye = torch.eye(n, dtype=K.dtype, device=K.device)
        b = 0.5 * y
        diagK = torch.diagonal(K)

        def lam_of(xi):
            xi = vmax(xi, VariationalBayes.XI_FLOOR)
            return torch.tanh(0.5 * xi) / (4.0 * xi)

        def posterior(lam):
            A = 2.0 * lam
            sA = torch.sqrt(A)
            L = chol(eye + sA[:, None] * K * sA[None, :])
            V = tri_solve(L, sA[:, None] * K)
            Sigma_diag = diagK - torch.sum(V * V, dim=0)
            r = b - A * m
            mu = m + K @ (r - sA * cho_solve(L, sA * (K @ r)))
            return mu, vmax(Sigma_diag, 0.0), L, r, sA

        xi2 = torch.ones(n, dtype=K.dtype, device=K.device)
        for _ in range(iters):
            mu, Sdiag, _, _, _ = posterior(lam_of(torch.sqrt(xi2)))
            xi2_new = Sdiag + mu * mu
            xi2 = torch.where(torch.all(torch.isfinite(xi2_new)), xi2_new, xi2)

        xi = torch.sqrt(vmax(xi2, VariationalBayes.XI_FLOOR ** 2))
        lam = lam_of(xi)
        mu, _, L, r, sA = posterior(lam)
        nu = r - 2.0 * lam * (mu - m)
        bound = (torch.sum(F.logsigmoid(xi) - 0.5 * xi + lam * xi * xi)
                 - torch.sum(torch.log(torch.diagonal(L)))
                 + 0.5 * (torch.dot(r, mu) + torch.dot(m, b)))
        return nu, sA, L, bound

    @staticmethod
    def log_marginal_likelihood(kernel, mean, params, X, y, iters: int = None):
        return VariationalBayes.bound_state(kernel, mean, params, X, y, iters=iters)[3]

    predict = staticmethod(Laplace.predict)


class StochasticVariational(Inference):
    """SVGP (Hensman et al. 2013/2015): an uncollapsed whitened q(v) =
    N(mv, Lv Lv') over u = m_Z + Luu v; the ELBO sums over data points, so
    it trains from minibatches, and takes every likelihood (closed form for
    the Gaussian, Gauss-Hermite otherwise). The predictive state
    (Z, Luu, mv, Lv) is m-sized."""

    GH_POINTS = 20

    @staticmethod
    def chol_kuu(kernel, params, Z):
        Kuu = kernel.gram(params, Z)
        return chol(_diag_jitter(Kuu, _inducing_jitter(Kuu)))

    @staticmethod
    def chol_q(Lraw):
        """Raw (m, m) parameter -> lower-triangular Lv with positive diagonal
        (Lraw = 0 gives Lv = I)."""
        return (torch.tril(Lraw, -1)
                + torch.diag_embed(torch.exp(vmin(vmax(torch.diagonal(Lraw), -30.0), 30.0))))

    @staticmethod
    def latent_moments(kernel, mean, params, Z, Luu, mv, Lv, x_star):
        """(mu, var) of q(f(x*)) at x_star (..., d)."""
        a = tri_rows(Luu, k_star(kernel, params, Z, x_star))
        mu = mean.eval(params, x_star) + a @ mv
        k_ss = kernel.eval(params, x_star, x_star)
        La = a @ Lv
        var = k_ss - torch.sum(a * a, dim=-1) + torch.sum(La * La, dim=-1)
        return mu, _floor_var(var, k_ss)

    @staticmethod
    def expected_log_lik(likelihood, mu, var, y, sn2, n_quad: int = None):
        """E_{f ~ N(mu, var)}[log p(y | f)], elementwise."""
        if likelihood.name == "gaussian":
            r = y - mu
            log2pisn2 = (torch.log(2 * math.pi * sn2) if torch.is_tensor(sn2)
                         else math.log(2 * math.pi * sn2))
            return -0.5 * (r * r + var) / sn2 - 0.5 * log2pisn2
        n_quad = StochasticVariational.GH_POINTS if n_quad is None else int(n_quad)
        t, w = np.polynomial.hermite_e.hermegauss(n_quad)  # weight e^{-t^2/2}
        t = torch.as_tensor(t, dtype=mu.dtype, device=mu.device)
        w = torch.as_tensor(w / np.sqrt(2.0 * np.pi), dtype=mu.dtype, device=mu.device)
        f = mu[:, None] + torch.sqrt(var)[:, None] * t[None, :]
        return likelihood.log_pdf(f, y[:, None], sn2) @ w

    @staticmethod
    def elbo(kernel, mean, params, Xb, yb, Z, sn2, likelihood, mv, Lraw,
             n_total=None, n_quad: int = None):
        """The evidence lower bound (minibatch estimate for a subset)."""
        b = Xb.shape[0]
        n_total = b if n_total is None else n_total
        mv = torch.atleast_1d(mv)
        m = mv.shape[0]
        Lv = StochasticVariational.chol_q(Lraw.reshape(m, m))
        Luu = StochasticVariational.chol_kuu(kernel, params, Z)
        mu, var = StochasticVariational.latent_moments(kernel, mean, params, Z, Luu,
                                                       mv, Lv, Xb)
        ell = StochasticVariational.expected_log_lik(
            likelihood, mu, var, torch.as_tensor(yb).to(mu), sn2, n_quad)
        kl = (0.5 * (torch.dot(mv, mv) + torch.sum(Lv * Lv) - m)
              - torch.sum(torch.log(torch.diagonal(Lv))))
        return (n_total / b) * torch.sum(ell) - kl

    @staticmethod
    def state(kernel, mean, params, Z, mv, Lraw):
        """``(Luu, mv, Lv)``."""
        mv = torch.atleast_1d(mv)
        m = mv.shape[0]
        Lv = StochasticVariational.chol_q(Lraw.reshape(m, m))
        return StochasticVariational.chol_kuu(kernel, params, Z), mv, Lv

    @staticmethod
    def predict(kernel, mean, params, Z, Luu, mv, Lv, x_star,
                noise_variance=0.0, include_noise=False):
        mu, var = StochasticVariational.latent_moments(kernel, mean, params, Z, Luu,
                                                       mv, Lv, x_star)
        if include_noise:
            var = var + noise_variance
        return mu, var
