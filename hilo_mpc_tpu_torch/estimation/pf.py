"""Sampling-importance-resampling particle filter.

PyTorch port of ``hilo_mpc_tpu/estimation/pf.py``: particles propagate through
the model integrator as one batch-first call with additive process noise,
Gaussian likelihood weights, systematic resampling (cumsum + searchsorted),
optional roughening, Latin-hypercube initial sampling (``lhsnorm``, numpy and
SciPy, so it is the same in both packages).

The random draws come from an explicit ``torch.Generator`` on the filter's
device, seeded by ``seed``. The step is split in two: ``step_draws`` takes
its draws as arguments (standard normal process noise (M, nx), the
resampling offset's uniform draw, standard normal roughening noise (M, nx));
the public step draws them from the generator and calls it. A test can so
hand the port the draws the JAX filter made (its keys give other numbers).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.integrators import IntegratorSpec, make_step
from ..core.model import records_setup, resolve_device
from ..ops.smallalg import chol_small, solve_small
from .base import Estimator


def lhsnorm(mean, cov, n: int, seed: int = 0) -> np.ndarray:
    """Latin-hypercube sampling from N(mean, cov) (reference: pf.py:425)."""
    from scipy.stats import norm

    rng = np.random.default_rng(seed)
    mean = np.atleast_1d(np.asarray(mean, dtype=float))
    d = mean.size
    u = (rng.permuted(np.tile(np.arange(n), (d, 1)), axis=1).T
         + rng.uniform(size=(n, d))) / n
    z = norm.ppf(np.clip(u, 1e-12, 1 - 1e-12))
    L = np.linalg.cholesky(np.atleast_2d(np.asarray(cov, dtype=float))
                           + 1e-12 * np.eye(d))
    return mean[None, :] + z @ L.T


class ParticleFilter(Estimator):
    """SIR particle filter: batched particle propagation, Gaussian
    likelihoods, systematic resampling, optional roughening, LHS initial
    sampling."""

    _estimator_type = "PF"

    def __init__(self, model, n_particles: int = 100, roughening: bool = False,
                 roughening_tuning: float = 0.2, seed: int = 0, **kwargs):
        super().__init__(model, **kwargs)
        if n_particles < 1:
            raise ValueError("n_particles must be >= 1")
        if model.is_linear:
            import warnings
            # reference parity: a PF on a linear model works but a Kalman
            # filter is exact and cheaper (reference: pf.py linear warning)
            warnings.warn("The supplied model is linear. For better "
                          "performance use the Kalman filter.")
        self.n_particles = int(n_particles)
        self.roughening = bool(roughening)
        self.roughening_tuning = float(roughening_tuning)
        self._seed = seed
        self._particles: Optional[np.ndarray] = None
        self._pdf = lhsnorm
        self._transpose_pdf: Optional[bool] = None

    @records_setup
    def setup(self, dt: Optional[float] = None, integration_method: str = "rk4",
              device="cuda", dtype=torch.float32, **options):
        """Build the filter step on ``device`` in ``dtype`` and seed its
        generator. A CUDA device that PyTorch cannot see raises; pass
        ``device="cpu"`` to run on the CPU."""
        m = self._model
        self._dt = float(dt if dt is not None else (m.dt or 1.0))
        self._device = resolve_device(device)
        self._dtype = dtype
        method = "discrete" if m.discrete else integration_method
        spec = IntegratorSpec(method=method, degree=options.get("degree", 3),
                              substeps=options.get("substeps", 1))
        self._core = make_step(m.ode_fn(), m.alg_fn(), m.n_x, m.n_z, spec)
        self._generator = torch.Generator(device=self._device)
        self._generator.manual_seed(int(self._seed))
        self._register_solution()
        self._time = 0.0
        self._setup_done = True
        return self

    def step_draws(self, parts, u, p, y, t, noise, offset, rough=None):
        """One filter step from given draws: (particles (M, nx), u, p, y, t,
        standard normal noise (M, nx), the offset's uniform draw in [0, 1),
        standard normal roughening noise (M, nx) or None) -> (particles+,
        x_est, y_est). The noise is scaled by the Cholesky factor of Q here,
        the offset by 1 / M."""
        if not self._setup_done:
            raise RuntimeError("call setup() first")
        m = self._model
        M, nx = parts.shape
        h = self._dt
        kw = dict(dtype=parts.dtype, device=parts.device)
        Q = torch.as_tensor(self._Q, **kw)
        R = torch.as_tensor(self._R, **kw)
        z = parts.new_zeros((M, m.n_z))
        U, Pm = u.expand(M, -1), p.expand(M, -1)
        # propagate + additive process noise w ~ N(0, Q)
        parts_pr = self._core(parts, z, U, Pm, t, h)[0]
        Lq = chol_small(Q + 1e-12 * torch.eye(nx, **kw))
        parts_pr = parts_pr + noise @ Lq.T
        # likelihood weights
        ysig = m.meas_fn()(parts_pr, z, U, Pm, t + h)
        innov = y[None, :] - ysig
        logw = -0.5 * torch.sum(innov.T * solve_small(R, innov.T), dim=0)
        logw = logw - torch.max(logw)
        w = torch.exp(logw)
        w = w / torch.sum(w)
        x_est = torch.einsum("m,mn->n", w, parts_pr)
        y_est = torch.einsum("m,mn->n", w, ysig)
        # systematic resampling
        edges = torch.cumsum(w, dim=0)
        pts = offset / M + torch.arange(M, **kw) / M
        idx = torch.clamp(torch.searchsorted(edges, pts), 0, M - 1)
        parts_new = parts_pr[idx]
        if self.roughening:
            spread = (torch.amax(parts_new, dim=0) - torch.amin(parts_new, dim=0))
            sig = self.roughening_tuning * spread * M ** (-1.0 / nx)
            parts_new = parts_new + sig[None, :] * rough
        return parts_new, x_est, y_est

    def step(self, parts, u, p, y, t):
        """One filter step with draws from the filter's generator:
        (particles (M, nx), u, p, y, t) -> (particles+, x_est, y_est)."""
        g, kw = self._generator, dict(dtype=parts.dtype, device=parts.device)
        noise = torch.randn(parts.shape, generator=g, **kw)
        offset = torch.rand((), generator=g, **kw)
        rough = (torch.randn(parts.shape, generator=g, **kw) if self.roughening
                 else None)
        return self.step_draws(parts, u, p, y, t, noise, offset, rough)

    def step_fn(self):
        if not self._setup_done:
            raise RuntimeError("call setup() first")
        return self.step

    def set_initial_guess(self, x0, P0=None):
        super().set_initial_guess(x0, P0)
        if self._setup_done:
            self._init_particles()
        return self

    # -- initial sampling distribution (reference: pf.py:195-224) -----------------
    @property
    def probability_density_function(self):
        """Sampler drawing the initial particle cloud: pdf(mu, sigma, n) ->
        (n, nx) array. Defaults to Latin-hypercube normal sampling."""
        return self._pdf

    @probability_density_function.setter
    def probability_density_function(self, pdf):
        import inspect
        import typing

        if not callable(pdf):
            raise TypeError("probability density function (pdf) must be "
                            "callable")
        # resolve annotations (handles PEP 563 string annotations); when they
        # cannot be resolved, accept the callable unvalidated
        try:
            hints = typing.get_type_hints(pdf)
        except Exception:
            hints = {}
        if hints:
            try:
                params = list(inspect.signature(pdf).parameters)
            except (TypeError, ValueError):
                params = []
            expected = (np.ndarray, np.ndarray, int)
            # check by PARAMETER POSITION, only where an annotation exists
            for i, arg in enumerate(params[:3]):
                if arg in hints and hints[arg] is not expected[i]:
                    no = ("first", "second", "third")[i]
                    raise TypeError(
                        f"The {no} argument to the probability density "
                        f"function (pdf) needs to be {expected[i].__name__}")
            ret = hints.get("return")
            if ret is not None and ret is not np.ndarray:
                raise TypeError("The return value of the probability density "
                                "function (pdf) needs to be numpy.ndarray")
        self._pdf = pdf
        self._transpose_pdf = None  # re-detect output orientation

    # reference alias for the particle count used by the initial sampling
    @property
    def sample_size(self):
        return self.n_particles

    @sample_size.setter
    def sample_size(self, n):
        n = int(n)
        if n < 1:
            raise ValueError("sample_size must be >= 1")
        self.n_particles = n
        self._particles = None

    def _init_particles(self):
        if self._pdf is lhsnorm:
            X = lhsnorm(self._x0, self._P0, self.n_particles, seed=self._seed)
        else:
            X = np.asarray(self._pdf(np.asarray(self._x0), np.asarray(self._P0),
                                     self.n_particles), dtype=float)
            # accept (n, nx) or the reference's (nx, n) column layout
            if self._transpose_pdf is None:
                self._transpose_pdf = X.shape != (self.n_particles, self.n_x)
            if self._transpose_pdf:
                X = X.T
            if X.shape != (self.n_particles, self.n_x):
                raise ValueError(
                    f"Dimension mismatch. Expected dimension "
                    f"{self.n_particles}x{self.n_x}, got {X.shape}")
        self._particles = X

    def estimate(self, y, u=None, p=None):
        if not self._setup_done:
            raise RuntimeError("call setup() first")
        if self._x0 is None:
            raise ValueError("call set_initial_guess(x0) first")
        if self._particles is None:
            self._init_particles()
        y = np.atleast_2d(np.asarray(y, dtype=float))
        if y.shape[1] != self.n_y:
            y = y.T
        steps = y.shape[0]
        if u is None:
            u = np.zeros((steps, self.n_u))
        else:
            u = np.atleast_2d(np.asarray(u, dtype=float))
            if u.shape[0] == 1:
                u = np.tile(u, (steps, 1))
            if u.shape[1] != self.n_u and u.shape[0] == self.n_u:
                u = u.T
        p_vec = self._tensor(self._p_or_default(p))
        parts = self._tensor(self._particles)
        x_est = None
        for k in range(steps):
            parts, x_est, y_est = self.step(parts, self._tensor(u[k]), p_vec,
                                            self._tensor(y[k]), self._time)
            self._time += self._dt
            P = np.cov(parts.cpu().numpy().T).reshape(self.n_x, self.n_x)
            self.solution.append(self._time, x=x_est.cpu().numpy(),
                                 y=y_est.cpu().numpy(), P=P.ravel())
        self._particles = parts.cpu().numpy()
        return x_est.cpu().numpy()

    @property
    def particles(self):
        return None if self._particles is None else np.array(self._particles)
