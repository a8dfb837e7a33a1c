"""Gaussian process regression and classification with hyperparameter fitting.

PyTorch port of ``hilo_mpc_tpu/ml/gp/gp.py``. The negative log marginal
likelihood (or the method's variational bound) is a torch function of the
unconstrained (log-space) hyperparameters, fitted by SciPy's L-BFGS-B on
torch's value and gradient, or by Adam; ``predict_fn()`` returns a
batch-first function (..., d) -> (mu (...), var (...)), traceable under
``torch.func`` and ``make_fx``, so a fitted GP embeds into MPC stage costs,
the SMPC surrogate (control/smpc.py) and hybrid models (ml/hybrid.py, where
``mean_fn()`` gives the posterior mean alone, with no triangular solve).

A GP computes on ``device`` in ``dtype`` (the constructor's, or
``setup``'s): ``"cuda"`` unless the caller passes ``device="cpu"``; a missing
card is an error when the GP first computes. The exact posterior is
factorized on the host in float64 with the JAX package's jitter ladder, as
JAX does; every other state is computed on the device and kept as float64
arrays. ``GPArray.fit_model_batched`` fits all outputs as ONE batched
optimization (``torch.func.vmap`` of the objective, ml/gp/optim.py).

Random draws: the SVGP minibatches come from a ``torch.Generator`` seeded
by ``fit_seed`` (JAX draws them from ``jax.random``; the bits differ by
design); ``fit_model(_indices=...)`` takes the index sequence instead.
"""
from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Union

import numpy as np
import scipy.linalg
import torch
from torch.func import grad_and_value, vmap

from ...core.model import resolve_device
from ..hyperparameters import Hyperparameter
from ..nn import _cached
from . import optim
from .inference import (ExactInference, ExpectationPropagation, KullbackLeibler,
                        Laplace, SparseFITC, SparseVFE, StochasticVariational,
                        VariationalBayes, full_precision)
from .kernels import Kernel, SquaredExponentialKernel, hp_tensor
from .likelihood import (Gaussian, Laplacian, Likelihood, Logistic, Probit,
                         StudentsT)
from .means import Mean, ZeroMean

_INFERENCES = ("exact", "exactinference", "laplace", "expectation_propagation", "ep",
               "kullback_leibler", "kl", "variational_bayes", "vb", "fitc", "sparse",
               "sparse_fitc", "vfe", "titsias", "sparse_vfe", "svgp", "svi",
               "stochastic_variational", "hensman")
_OPTION_KEYS = {"laplace_iters", "ep_sweeps", "ep_damping", "kl_sweeps", "kl_damping",
                "vb_iters", "n_inducing", "inducing_points", "optimize_inducing",
                "batch_size", "n_quadrature", "fit_seed"}


def _likelihood_of(likelihood) -> Likelihood:
    if isinstance(likelihood, Likelihood):
        # a custom instance must be usable: fail at construction, not deep
        # inside a derivative
        if type(likelihood).log_pdf is Likelihood.log_pdf:
            raise ValueError(
                f"{type(likelihood).__name__} does not override "
                f"Likelihood.log_pdf — a likelihood instance must "
                f"implement log_pdf(f, y, sn2)")
        if (likelihood.name == Likelihood.name
                and type(likelihood).name is Likelihood.name):
            raise ValueError(
                f"{type(likelihood).__name__} must set a distinct "
                f"`name` class attribute (used to route inference "
                f"compatibility checks)")
        return likelihood
    key = likelihood.lower().replace(" ", "_").replace("-", "_").replace("'", "")
    if key in ("gaussian", "normal"):
        return Gaussian()
    if key == "logistic":
        return Logistic()
    if key == "probit":
        return Probit()
    if key in ("students_t", "studentst", "student_t"):
        return StudentsT()
    if key == "laplacian":
        return Laplacian()
    raise ValueError(f"Likelihood {likelihood!r} not recognized")


def _inference_of(inf_key: str, lik: str) -> str:
    if inf_key in ("svgp", "svi", "stochastic_variational", "hensman"):
        return "svgp"
    if inf_key in ("fitc", "sparse", "sparse_fitc", "vfe", "titsias", "sparse_vfe"):
        if lik != "gaussian":
            raise ValueError(
                "sparse FITC/VFE inference is Gaussian-likelihood regression; got "
                f"{lik!r} — use 'laplace'/'ep'/'kl' for non-Gaussian likelihoods")
        return "vfe" if inf_key in ("vfe", "titsias", "sparse_vfe") else "fitc"
    if inf_key in ("kullback_leibler", "kl"):
        return "kl"
    if inf_key in ("variational_bayes", "vb"):
        if lik != "logistic":
            raise ValueError(
                "variational-bayes inference is the Jaakkola-Jordan sigmoid bound — "
                f"logistic likelihood only; got {lik!r} — use inference='kl' (the "
                "generic variational Gaussian) instead")
        return "vb"
    if inf_key in ("expectation_propagation", "ep"):
        if lik not in ("probit", "laplacian"):
            raise ValueError(
                "expectation propagation requires a likelihood with closed-form "
                "tilted moments (probit classification, GPML 3.6, or Laplacian "
                f"robust regression); got {lik!r} — use inference='laplace' instead")
        return "ep"
    if inf_key == "laplace":
        if lik == "laplacian":
            raise ValueError(
                "the Laplacian likelihood's log-density is piecewise linear (zero "
                "curvature a.e.), which defeats the Laplace approximation's Newton "
                "mode search — use inference='ep' for Laplacian robust regression")
        return "laplace"
    if lik != "gaussian":
        alt = "ep" if lik == "laplacian" else "laplace"
        raise ValueError(
            f"exact inference requires the Gaussian likelihood (the reference "
            f"enforces the same, gp/inference.py:194); use inference='{alt}' "
            f"(or the generic variational 'kl') for {lik!r}")
    return "exact"


def _check_options(opts: dict, inference: str, d: int) -> dict:
    opts = dict(opts or {})
    unknown = set(opts) - _OPTION_KEYS
    if unknown:
        raise ValueError(f"unknown inference_options {sorted(unknown)}; "
                         f"valid keys: {sorted(_OPTION_KEYS)}")
    for key in ("laplace_iters", "ep_sweeps", "kl_sweeps", "vb_iters", "n_inducing",
                "n_quadrature"):
        if opts.get(key) is not None and int(opts[key]) < 1:
            raise ValueError(f"{key} must be >= 1")
    for key in ("ep_damping", "kl_damping"):
        if opts.get(key) is not None and not 0.0 < float(opts[key]) <= 1.0:
            raise ValueError(f"{key} must be in (0, 1]")
    zp = opts.get("inducing_points")
    if zp is not None:
        zp = np.atleast_2d(np.asarray(zp, dtype=float))
        if zp.shape[1] != d:
            raise ValueError(f"inducing_points must be (m, {d}); got {zp.shape}")
        opts["inducing_points"] = zp
    if opts.get("optimize_inducing") is not None:
        if inference not in ("fitc", "vfe", "svgp"):
            raise ValueError(
                "optimize_inducing only applies to sparse inference "
                f"('fitc'/'vfe'/'svgp'); this GP uses {inference!r}")
        opts["optimize_inducing"] = bool(opts["optimize_inducing"])
    bs = opts.get("batch_size")
    if bs is not None:
        if inference != "svgp":
            raise ValueError(
                "batch_size (minibatch ELBO training) only applies to "
                f"inference='svgp'; this GP uses {inference!r} — "
                "the collapsed bounds need the full data per step")
        if int(bs) < 1:
            raise ValueError("batch_size must be >= 1")
    return opts


class GaussianProcess:
    def __init__(self, features: Union[str, List[str]], labels: Union[str, List[str]],
                 kernel: Optional[Kernel] = None, mean: Optional[Mean] = None,
                 noise_variance: float = 1.0, inference: str = "exact",
                 likelihood: str = "gaussian", solver: str = "scipy",
                 inference_options: Optional[dict] = None, id: Optional[str] = None,
                 name: Optional[str] = None, device="cuda", dtype=torch.float32):
        self.features = [features] if isinstance(features, str) else list(features)
        labels = [labels] if isinstance(labels, str) else list(labels)
        if len(labels) != 1:
            raise ValueError("one GP handles one output; use GPArray for "
                             "multi-output regression")
        self.labels = labels
        self.kernel = kernel if kernel is not None else SquaredExponentialKernel(
            length_scales=np.ones(len(self.features)))
        self.mean = mean if mean is not None else ZeroMean()
        inf_key = inference.lower().replace(" ", "_").replace("-", "_")
        if inf_key not in _INFERENCES:
            raise ValueError(f"Inference {inference!r} not recognized")
        self.likelihood = _likelihood_of(likelihood)
        self.inference = _inference_of(inf_key, self.likelihood.name)
        self.inference_options = _check_options(inference_options, self.inference,
                                                len(self.features))
        # trainable inducing locations (optimize_inducing) and the SVGP
        # variational parameters (whitened mean mv, raw Cholesky Lraw):
        # ordinary hyperparameters, seeded in set_training_data
        self._z_hp: Optional[Hyperparameter] = None
        self._svgp_mv: Optional[Hyperparameter] = None
        self._svgp_lraw: Optional[Hyperparameter] = None
        self.noise_variance = Hyperparameter("GP.noise_variance", value=noise_variance,
                                             positive=True)
        if not self.likelihood.uses_noise:
            self.noise_variance.fixed = True
        self.solver = solver
        self.name = name or "gp"
        self.X_train: Optional[np.ndarray] = None   # (n, d)
        self.y_train: Optional[np.ndarray] = None   # (n,)
        self._state = None
        self._setup_done = False
        self._device_arg = device
        self._dtype = dtype

    # -- device ----------------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return resolve_device(self._device_arg)

    @property
    def dtype(self) -> torch.dtype:
        return self._dtype

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=float), dtype=self._dtype,
                               device=self.device)

    # -- data ------------------------------------------------------------------
    def set_training_data(self, X, y):
        if self._setup_done:
            warnings.warn(
                "Gaussian process was already executed. Use the fit_model() "
                "method again to optimize with respect to the newly set "
                "training data.")
        X = np.asarray(X, dtype=float)
        y = np.asarray(y, dtype=float)
        d = len(self.features)
        if X.ndim == 1:
            X = X[:, None] if d == 1 else X[None, :]
        if X.shape[1] != d and X.shape[0] == d:
            X = X.T
        if X.shape[1] != d:
            raise ValueError(f"X has {X.shape[1]} features, expected {d}")
        y = y.ravel()
        if y.size != X.shape[0]:
            raise ValueError(f"{X.shape[0]} samples but {y.size} labels")
        if self.likelihood.name in ("logistic", "probit"):
            vals = set(np.unique(y).tolist())
            if vals <= {0.0, 1.0}:
                y = 2.0 * y - 1.0
            elif not vals <= {-1.0, 1.0}:
                raise ValueError(
                    f"{self.likelihood.name} likelihood needs binary labels "
                    f"in {{0,1}} or {{-1,+1}}, got values {sorted(vals)[:5]}")
        self.X_train, self.y_train = X, y
        if self.inference == "svgp":
            # q(v) starts at the whitened prior N(0, I)
            m = int(np.asarray(self._subset_inducing(X)).shape[0])
            self._svgp_mv = Hyperparameter("GP.svgp_mv", value=np.zeros(m),
                                           positive=False)
            self._svgp_lraw = Hyperparameter("GP.svgp_Lraw", value=np.zeros((m, m)),
                                             positive=False)
        if self.inference_options.get("optimize_inducing"):
            self._z_hp = Hyperparameter("GP.inducing_points",
                                        value=np.asarray(self._subset_inducing(X)),
                                        positive=False)
        self._state = None
        return self

    @property
    def n_samples(self):
        return 0 if self.X_train is None else self.X_train.shape[0]

    # -- hyperparameters ----------------------------------------------------------
    @property
    def hyperparameters(self) -> List[Hyperparameter]:
        hps = self.kernel.hyperparameters + self.mean.hyperparameters + [
            self.noise_variance]
        if self._z_hp is not None:
            hps = hps + [self._z_hp]
        if self._svgp_mv is not None:
            hps = hps + [self._svgp_mv, self._svgp_lraw]
        return hps

    def _params(self, dtype=None, device=None) -> Dict[str, torch.Tensor]:
        dtype = self._dtype if dtype is None else dtype
        device = self.device if device is None else device
        return {hp.key: hp_tensor(hp, dtype, device) for hp in self.hyperparameters}

    def _pack(self):
        """Trainable hyperparameters -> flat unconstrained vector + bounds."""
        w0, specs, bounds = [], [], []
        for hp in self.hyperparameters:
            if hp.fixed:
                continue
            w = hp.to_unconstrained().ravel()
            specs.append((hp, len(w)))
            w0.append(w)
            if hp.bounds is not None:
                lb, ub = hp.bounds
                lb = np.log(lb) if hp.positive else lb
                ub = np.log(ub) if hp.positive else ub
                bounds += [(lb, ub)] * len(w)
            elif hp.positive:
                # exp(-35) underflows to 0.0 and would break positivity
                bounds += [(-30.0, 30.0)] * len(w)
            else:
                bounds += [(None, None)] * len(w)
        return (np.concatenate(w0) if w0 else np.zeros(0)), specs, bounds

    def _unpack(self, w, specs, base=None):
        params = dict(self._params(w.dtype, w.device) if base is None else base)
        off = 0
        for hp, n in specs:
            val = w[off:off + n]
            off += n
            val = torch.exp(val) if hp.positive else val
            params[hp.key] = (val.reshape(()) if hp.size == 1
                              else val.reshape(np.shape(hp.value)))
        return params

    def _subset_inducing(self, X):
        """The seed inducing set: explicit ``inducing_points``, else an evenly
        strided subset of the training data (static indices)."""
        zp = self.inference_options.get("inducing_points")
        if zp is not None:
            return torch.as_tensor(zp).to(X) if torch.is_tensor(X) else zp
        n = X.shape[0]
        m = min(int(self.inference_options.get("n_inducing", 64)), n)
        idx = np.unique(np.linspace(0, n - 1, m).round().astype(int))
        return X[idx.tolist()] if torch.is_tensor(X) else X[idx]

    def _inducing(self, X, params=None):
        """The inducing set in effect: the trainable locations (from
        ``params`` inside a fit objective), else the seed subset."""
        if self._z_hp is not None:
            if params is not None and self._z_hp.key in params:
                return params[self._z_hp.key]
            return torch.as_tensor(self._z_hp.value).to(X)
        return self._subset_inducing(X)

    # -- objective ---------------------------------------------------------------
    def _lml(self, params, X, y):
        """Log marginal likelihood (or its variational bound) of (X, y):
        pure in (params, X, y), so it vmaps over a GPArray."""
        sn2 = params[self.noise_variance.key] ** 2
        opts = self.inference_options
        if self.inference == "laplace":
            return Laplace.log_marginal_likelihood(
                self.kernel, self.mean, params, X, y, sn2, self.likelihood,
                iters=opts.get("laplace_iters"))
        if self.inference == "ep":
            return ExpectationPropagation.log_marginal_likelihood(
                self.kernel, self.mean, params, X, y, sweeps=opts.get("ep_sweeps"),
                damping=opts.get("ep_damping"), likelihood=self.likelihood, sn2=sn2)
        if self.inference == "kl":
            return KullbackLeibler.log_marginal_likelihood(
                self.kernel, self.mean, params, X, y, sn2, self.likelihood,
                sweeps=opts.get("kl_sweeps"), damping=opts.get("kl_damping"))
        if self.inference == "vb":
            return VariationalBayes.log_marginal_likelihood(
                self.kernel, self.mean, params, X, y, iters=opts.get("vb_iters"))
        if self.inference in ("fitc", "vfe"):
            inf = SparseVFE if self.inference == "vfe" else SparseFITC
            return inf.log_marginal_likelihood(self.kernel, self.mean, params, X, y,
                                               self._inducing(X, params), sn2)
        if self.inference == "svgp":
            return StochasticVariational.elbo(
                self.kernel, self.mean, params, X, y, self._inducing(X, params), sn2,
                self.likelihood, params[self._svgp_mv.key],
                params[self._svgp_lraw.key], n_quad=opts.get("n_quadrature"))
        return ExactInference.log_marginal_likelihood(self.kernel, self.mean, params,
                                                      X, y, sn2)

    def _log_prior(self, params, hps=None):
        logp = 0.0
        for hp in (self.hyperparameters if hps is None else hps):
            if hp.prior is not None:
                logp = logp + hp.log_prior(params[hp.key])
        return logp

    def _nll(self, params):
        lml = self._lml(params, self._t(self.X_train), self._t(self.y_train))
        return -(lml + self._log_prior(params))

    @property
    def log_marginal_likelihood(self) -> float:
        with full_precision():
            return float(-self._nll(self._params()))

    # -- setup / fit -------------------------------------------------------------
    def setup(self, device=None, dtype=None):
        """Compute the predictive state (on ``device`` in ``dtype`` when
        given; else the constructor's)."""
        if device is not None:
            self._device_arg = device
        if dtype is not None:
            self._dtype = dtype
        if self.X_train is None:
            raise RuntimeError("call set_training_data(X, y) first")
        self._refresh_state()
        self._setup_done = True
        return self

    def _refresh_state(self):
        if self.X_train is None:
            raise RuntimeError("call set_training_data(X, y) first")
        with full_precision():
            self._state = self._compute_state()

    def _compute_state(self):
        params = self._params()
        sn2 = float(np.squeeze(self.noise_variance.value)) ** 2
        X, y = self._t(self.X_train), self._t(self.y_train)
        opts = self.inference_options

        def host(*ts):
            return tuple(t.detach().cpu().double().numpy() for t in ts)

        if self.inference == "laplace":
            _, g, sW, L, _ = Laplace.mode_state(
                self.kernel, self.mean, params, X, y, sn2, self.likelihood,
                iters=opts.get("laplace_iters"))
            return ("laplace",) + host(g, sW, L)
        if self.inference == "ep":
            w, stt, L, _ = ExpectationPropagation.site_state(
                self.kernel, self.mean, params, X, y, sweeps=opts.get("ep_sweeps"),
                damping=opts.get("ep_damping"), likelihood=self.likelihood, sn2=sn2)
            return ("ep",) + host(w, stt, L)
        if self.inference == "kl":
            nu, sl, L, _ = KullbackLeibler.variational_state(
                self.kernel, self.mean, params, X, y, sn2, self.likelihood,
                sweeps=opts.get("kl_sweeps"), damping=opts.get("kl_damping"))
            return ("kl",) + host(nu, sl, L)
        if self.inference == "vb":
            nu, sA, L, _ = VariationalBayes.bound_state(
                self.kernel, self.mean, params, X, y, iters=opts.get("vb_iters"))
            return ("vb",) + host(nu, sA, L)
        if self.inference == "svgp":
            Z = self._inducing(X)
            Luu, mv, Lv = StochasticVariational.state(
                self.kernel, self.mean, params, Z, params[self._svgp_mv.key],
                params[self._svgp_lraw.key])
            return ("svgp",) + host(Z, Luu, mv, Lv)
        if self.inference in ("fitc", "vfe"):
            Z = self._inducing(X)
            inf = SparseVFE if self.inference == "vfe" else SparseFITC
            Luu, La, beta, _ = inf.state(self.kernel, self.mean, params, X, y, Z, sn2)
            # one sparse tag: the predictive algebra is the same for both
            return ("fitc",) + host(Luu, La, beta, Z)
        # the gram on the device, factorized on the host in float64 with the
        # JAX package's jitter ladder: with small noise the system has
        # condition ~1/(sn2 + jitter), beyond float32
        K, m = host(self.kernel.gram(params, X), self.mean.eval(params, X))
        n = K.shape[0]
        resid = np.asarray(self.y_train, dtype=np.float64) - m
        for jitter in (1e-10, 1e-8, 1e-6, 1e-4, 1e-2):
            try:
                Kj = K + (sn2 + jitter * float(np.mean(np.diagonal(K)))) * np.eye(n)
                L = np.linalg.cholesky(Kj)
                break
            except np.linalg.LinAlgError:
                continue
        else:
            raise RuntimeError("GP gram matrix is not factorizable")
        return L, scipy.linalg.cho_solve((L, True), resid)

    def is_setup(self):
        return self._setup_done

    def _write_back(self, w, specs):
        params = self._unpack(torch.as_tensor(np.asarray(w, dtype=float),
                                              dtype=torch.float64), specs)
        for hp, _ in specs:
            hp.value = params[hp.key].numpy()

    def fit_model(self, solver: Optional[str] = None, max_iter: int = 200,
                  learning_rate: float = 5e-2, _indices=None):
        """Maximize the (prior-weighted) log marginal likelihood.
        ``_indices`` (max_iter, batch_size): the SVGP minibatch indices of
        each step, instead of the ``fit_seed`` generator's draws."""
        if self.X_train is None:
            raise RuntimeError("call set_training_data(X, y) first")
        solver = solver or self.solver
        w0, specs, bounds = self._pack()
        if w0.size == 0:
            self._refresh_state()
            return self
        with full_precision():
            w_best = self._fit(solver, w0, specs, bounds, max_iter, learning_rate,
                               _indices)
        self._write_back(w_best, specs)
        self._refresh_state()
        self._setup_done = True
        return self

    def _fit(self, solver, w0, specs, bounds, max_iter, learning_rate, indices):
        dev, dt = self.device, self._dtype
        base = self._params()
        bs = self.inference_options.get("batch_size") if self.inference == "svgp" else None
        if bs is not None and int(bs) < self.n_samples:
            # minibatch SVGP (Hensman 2013): unbiased ELBO gradients from
            # random subsets, Adam whatever ``solver`` says
            b, n = int(bs), self.n_samples
            X, y = self._t(self.X_train), self._t(self.y_train)
            n_quad = self.inference_options.get("n_quadrature")
            if indices is None:
                gen = torch.Generator(device=dev).manual_seed(
                    int(self.inference_options.get("fit_seed", 0)))
                draw = lambda k: torch.randperm(n, generator=gen, device=dev)[:b]
            else:
                idx_all = torch.as_tensor(np.asarray(indices), dtype=torch.int64,
                                          device=dev)
                draw = lambda k: idx_all[k]

            def nll_batch(w, idx):
                params = self._unpack(w, specs, base)
                sn2 = params[self.noise_variance.key] ** 2
                elbo = StochasticVariational.elbo(
                    self.kernel, self.mean, params, X[idx], y[idx],
                    self._inducing(X, params), sn2, self.likelihood,
                    params[self._svgp_mv.key], params[self._svgp_lraw.key],
                    n_total=n, n_quad=n_quad)
                return -(elbo + self._log_prior(params))

            def step_grad(W, k):
                g, v = grad_and_value(nll_batch)(W[0], draw(k))
                return g[None], v[None]

            W, _ = optim.adam(step_grad, self._t(w0)[None], max_iter, learning_rate)
            return W[0].detach().cpu().numpy()

        def nll(w):
            return self._nll(self._unpack(w, specs, base))

        if solver in ("scipy", "lbfgs", "ipopt"):
            # 'ipopt' maps to L-BFGS-B as in the JAX package
            from scipy.optimize import minimize

            vg = grad_and_value(nll)
            cache = {}

            def evaluate(w):
                key = np.asarray(w, dtype=float).tobytes()
                if key not in cache:
                    cache.clear()
                    g, v = vg(self._t(w))
                    cache[key] = (float(v), g.detach().cpu().double().numpy())
                return cache[key]

            # NaN guard: a trial step where the Cholesky fails reads as a huge
            # objective (and a zero gradient), so the line search backtracks
            def f_np(w):
                v = evaluate(w)[0]
                return v if np.isfinite(v) else 1e12

            def g_np(w):
                return np.nan_to_num(evaluate(w)[1], nan=0.0, posinf=1e6, neginf=-1e6)

            res = minimize(f_np, w0, jac=g_np, method="L-BFGS-B", bounds=bounds,
                           options={"maxiter": max_iter})
            return res.x
        if solver == "adam":
            g1 = grad_and_value(nll)

            def step_grad(W, k):
                g, v = g1(W[0])
                return g[None], v[None]

            W, _ = optim.adam(step_grad, self._t(w0)[None], max_iter, learning_rate)
            return W[0].detach().cpu().numpy()
        raise ValueError(f"unknown solver {solver!r} (scipy | adam)")

    # -- prediction ----------------------------------------------------------------
    def _constants(self):
        """The predictive state's numbers as float64 CPU tensors, and the
        state's tag."""
        if self._state is None:
            self._refresh_state()
        f64 = dict(dtype=torch.float64)
        consts = {"params": {k: v.cpu() for k, v in self._params(torch.float64,
                                                                  torch.device("cpu")).items()},
                  "X": torch.as_tensor(self.X_train, **f64)}
        st = self._state
        tag = st[0] if isinstance(st[0], str) else "exact"
        arrays = st[1:] if isinstance(st[0], str) else st
        consts["state"] = [torch.as_tensor(a, **f64) for a in arrays]
        return tag, consts

    def predict_fn(self, include_noise: bool = False):
        """(mu, var) = f(x) for x (..., d), batch-first: a plain function of
        the state as it is now (one copy of its numbers per dtype and device
        it computes in), traceable into Model and NMPC functions. It computes
        in the wider of the argument's dtype and the GP's own, and returns
        the argument's: a float64 GP under a float32 controller predicts in
        float64, as JAX's float64 state promotes a float32 query. In float32
        the exact mean k(x)ᵀα cancels (|α| ~ 150 against a mean of ~0.05 on
        golden smpc_chance's GP), and its rounding, ~1e-5 and different at
        every point, made the SMPC's merit line search reject good steps."""
        tag, c = self._constants()
        params = {k: _cached(v) for k, v in c["params"].items()}
        X = _cached(c["X"])
        state = [_cached(v) for v in c["state"]]
        sn2 = float(np.squeeze(self.noise_variance.value)) ** 2
        kernel, mean, lik = self.kernel, self.mean, self.likelihood
        noisy = include_noise and lik.uses_noise
        own = self._dtype

        def fn(x_star):
            x_star = torch.atleast_1d(x_star)
            wide = torch.promote_types(x_star.dtype, own)
            if wide == x_star.dtype:
                return predict(x_star)
            mu, var = predict(x_star.to(wide))
            return mu.to(x_star.dtype), var.to(x_star.dtype)

        def predict(x_star):
            with full_precision():
                p = {k: get(x_star) for k, get in params.items()}
                s = [get(x_star) for get in state]
                if tag == "svgp":
                    mu, var = StochasticVariational.predict(kernel, mean, p, *s, x_star)
                elif tag == "fitc":
                    Luu, La, beta, Z = s
                    return SparseFITC.predict(kernel, mean, p, Z, Luu, La, beta, x_star,
                                              sn2, include_noise=include_noise)
                elif tag == "exact":
                    L, alpha = s
                    return ExactInference.predict(kernel, mean, p, X(x_star), L, alpha,
                                                  x_star, sn2,
                                                  include_noise=include_noise)
                else:   # laplace, kl, vb, ep: the (weights, sqrt, chol) layout
                    mu, var = Laplace.predict(kernel, mean, p, X(x_star), *s, x_star)
            if noisy:
                # the likelihood's own noise second moment
                var = var + lik.noise_pred_variance(sn2)
            return mu, var

        return fn

    def _mean_weights(self):
        """(points P (m, d), weights c (m,)) of the posterior mean
        m(x) + k(x, P) c, float64 on the host."""
        tag, c = self._constants()
        s = [v.numpy() for v in c["state"]]
        if tag == "exact":
            return c["X"], torch.as_tensor(s[1])
        if tag in ("laplace", "kl", "vb", "ep"):
            return c["X"], torch.as_tensor(s[0])
        solve = lambda L, v: scipy.linalg.solve_triangular(L, v, lower=True, trans="T")
        if tag == "fitc":
            Luu, La, beta, Z = s
            return torch.as_tensor(Z), torch.as_tensor(solve(Luu, solve(La, beta)))
        Z, Luu, mv, _ = s
        return torch.as_tensor(Z), torch.as_tensor(solve(Luu, mv))

    def mean_fn(self):
        """The posterior mean alone, m(x) + k(x, P) c for x (..., d): the
        weights c are solved once here, so the function has no triangular
        solve (what a hybrid model substitutes)."""
        P, w = self._mean_weights()
        params = {k: _cached(v) for k, v in self._constants()[1]["params"].items()}
        P, w = _cached(P), _cached(w)
        kernel, mean = self.kernel, self.mean

        def fn(x_star):
            x_star = torch.atleast_1d(x_star)
            with full_precision():
                p = {k: get(x_star) for k, get in params.items()}
                ks = kernel.eval(p, P(x_star), x_star[..., None, :])
                return mean.eval(p, x_star) + ks @ w(x_star)

        return fn

    def _query(self, X_query) -> torch.Tensor:
        Xq = np.asarray(X_query, dtype=float)
        d = len(self.features)
        if Xq.ndim == 1:
            Xq = Xq[:, None] if d == 1 else Xq[None, :]
        if Xq.shape[1] != d and Xq.shape[0] == d:
            Xq = Xq.T
        return self._t(Xq)

    def predict(self, X_query, include_noise: bool = False):
        """Batch prediction on this GP's device in its dtype: numpy in,
        (means, variances) numpy out."""
        with torch.no_grad():
            mu, var = self.predict_fn(include_noise=include_noise)(self._query(X_query))
        return mu.cpu().numpy(), var.cpu().numpy()

    def predict_proba(self, X_query):
        """p(y = +1 | x): exact for the probit likelihood, the probit
        approximation for the logistic one."""
        if self.likelihood.name not in ("logistic", "probit"):
            raise RuntimeError(
                "predict_proba requires a classification likelihood "
                f"(logistic or probit; this GP uses {self.likelihood.name!r})")
        mu, var = self.predict(X_query)
        if self.likelihood.name == "probit":
            from scipy.stats import norm

            return norm.cdf(mu / np.sqrt(1.0 + var))
        from scipy.special import expit

        return expit(mu / np.sqrt(1.0 + np.pi * var / 8.0))

    def predict_quantiles(self, X_query, quantiles=(0.025, 0.975)):
        """Gaussian quantiles of the predictive distribution, noise included
        (the likelihood's own second moment)."""
        from scipy.stats import norm

        mu, var = self.predict(X_query, include_noise=True)
        std = np.sqrt(var)
        return [mu + norm.ppf(q) * std for q in quantiles]

    def __repr__(self):
        return (f"GaussianProcess(features={self.features}, labels={self.labels}, "
                f"kernel={self.kernel!r}, n={self.n_samples})")


def _same(a, b) -> bool:
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


class GPArray:
    """Array of independent single-output GPs."""

    def __init__(self, n_gps: int):
        if n_gps < 1:
            raise ValueError("n_gps must be >= 1")
        self._gps: List[Optional[GaussianProcess]] = [None] * int(n_gps)
        self.last_fit_nll: Optional[np.ndarray] = None

    def __len__(self):
        return len(self._gps)

    def __getitem__(self, i):
        return self._gps[i]

    def __setitem__(self, i, gp):
        if not isinstance(gp, GaussianProcess):
            raise TypeError("GPArray elements must be GaussianProcess instances")
        self._gps[i] = gp

    def __iter__(self):
        return iter(self._gps)

    def setup(self, device=None, dtype=None):
        for gp in self._gps:
            gp.setup(device=device, dtype=dtype)
        return self

    def fit_model(self, **kwargs):
        for gp in self._gps:
            gp.fit_model(**kwargs)
        return self

    def _check_batchable(self):
        gps = list(self._gps)
        if any(gp is None for gp in gps):
            raise RuntimeError("assign every GPArray slot before fitting")
        if any(gp.X_train is None for gp in gps):
            raise RuntimeError("call set_training_data on every GP first")
        gp0 = gps[0]
        for gp in gps:
            if gp.inference != gp0.inference:
                raise ValueError(
                    "fit_model_batched needs the same inference across the "
                    f"array (got {gp.inference!r} vs {gp0.inference!r})")
            if not (type(gp.likelihood) is type(gp0.likelihood)
                    and _same(vars(gp.likelihood), vars(gp0.likelihood))):
                raise ValueError("fit_model_batched needs an identical likelihood "
                                 "configuration across the array")
            if not _same(gp.inference_options, gp0.inference_options):
                raise ValueError("fit_model_batched needs identical inference_options "
                                 "across the array")
        packs = [gp._pack() for gp in gps]
        specs0 = packs[0][1]
        fixed0 = [hp for hp in gp0.hyperparameters if hp.fixed]
        for gp, (_, specs, _) in zip(gps, packs):
            if [(hp.name, n) for hp, n in specs] != [(hp.name, n) for hp, n in specs0]:
                raise ValueError(
                    "fit_model_batched needs identical hyperparameter "
                    "structure across the array (same kernel/mean families)")
            if ([(hp.name, hp.size) for hp in gp.hyperparameters if hp.fixed]
                    != [(hp.name, hp.size) for hp in fixed0]):
                raise ValueError("fit_model_batched needs the same FIXED hyperparameter "
                                 "structure across the array")
            for hp_a, hp_b in zip(gp0.hyperparameters, gp.hyperparameters):
                pa, pb = hp_a.prior, hp_b.prior
                if not ((pa is None) == (pb is None) and (
                        pa is None or (type(pa) is type(pb) and vars(pa) == vars(pb)))):
                    raise ValueError(
                        f"fit_model_batched needs identical priors across "
                        f"the array ({hp_a.name} differs); use fit_model() "
                        f"per GP for heterogeneous priors")
            if gp.X_train.shape != gp0.X_train.shape:
                raise ValueError("fit_model_batched needs equal training-set "
                                 "shapes across the array")
        return gps, packs, fixed0

    def fit_model_batched(self, max_iter: int = 200, learning_rate: float = 5e-2,
                          solver: str = "lbfgs"):
        """Fit ALL outputs as ONE batched optimization on the first GP's device
        in its dtype: L-BFGS with the zoom line search (optax.lbfgs's
        semantics) or Adam over the (G, P) stack of unconstrained
        hyperparameters, every evaluation one ``vmap`` of the objective over
        the outputs, the iterate clipped to each output's bounds after every
        step. A failed Cholesky reads as 1e12. Needs the same
        hyperparameter structure, inference, likelihood, options, priors and
        training-set shape across the array; fixed values may differ.
        ``last_fit_nll``: each output's objective at the start of its last
        step."""
        if solver not in ("lbfgs", "adam"):
            raise ValueError(f"unknown solver {solver!r} (lbfgs | adam)")
        gps, packs, fixed0 = self._check_batchable()
        gp0 = gps[0]
        w0s, specs0, _ = packs[0]
        if w0s.size == 0:
            for gp in gps:
                gp._refresh_state()
                gp._setup_done = True
            return self
        t = gp0._t
        W0 = t(np.stack([w for w, _, _ in packs]))
        Xs = t(np.stack([gp.X_train for gp in gps]))
        ys = t(np.stack([gp.y_train for gp in gps]))
        fixed_stacks = tuple(
            t(np.stack([np.atleast_1d(np.asarray(
                [h for h in gp.hyperparameters if h.fixed][j].value)) for gp in gps]))
            for j in range(len(fixed0)))
        LB = t(np.stack([[-np.inf if b[0] is None else b[0] for b in bnds]
                         for _, _, bnds in packs]))
        UB = t(np.stack([[np.inf if b[1] is None else b[1] for b in bnds]
                         for _, _, bnds in packs]))
        prior_hps = [hp for hp in gp0.hyperparameters if hp.prior is not None]
        base = gp0._params()

        def nll(w, X, y, fixed_vals):
            params = gp0._unpack(w, specs0, base)
            for hp, val in zip(fixed0, fixed_vals):
                params[hp.key] = (val.reshape(()) if hp.size == 1
                                  else val.reshape(np.shape(hp.value)))
            v = -(gp0._lml(params, X, y) + gp0._log_prior(params, prior_hps))
            # a failed Cholesky in a trial step reads as a huge value, so the
            # line search backtracks instead of poisoning w
            return torch.where(torch.isfinite(v), v, torch.full_like(v, 1e12))

        batched = vmap(grad_and_value(nll))

        def vag(W):
            return batched(W, Xs, ys, fixed_stacks)

        with full_precision():
            if solver == "lbfgs":
                W, finals = optim.lbfgs(vag, W0, LB, UB, max_iter)
            else:
                W, finals = optim.adam(lambda W, k: vag(W), W0, max_iter, learning_rate,
                                       LB, UB)
        W = W.detach().cpu().double().numpy()
        for i, (gp, (_, specs, _)) in enumerate(zip(gps, packs)):
            gp._write_back(W[i], specs)
            gp._refresh_state()
            gp._setup_done = True
        self.last_fit_nll = finals.detach().cpu().double().numpy()
        return self

    def predict(self, X_query, **kwargs):
        out = [gp.predict(X_query, **kwargs) for gp in self._gps]
        return (np.stack([m for m, _ in out], axis=-1),
                np.stack([v for _, v in out], axis=-1))
