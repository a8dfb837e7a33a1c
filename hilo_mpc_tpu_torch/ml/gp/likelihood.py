"""GP observation likelihoods.

PyTorch port of ``hilo_mpc_tpu/ml/gp/likelihood.py``: Gaussian, Logistic,
Probit, Student's-t and Laplacian, each an elementwise
``log_pdf(f, y, sn2)`` (log p(y|f) given the latent value f and the squared
noise scale sn2) on tensors, differentiable in f, and
``noise_pred_variance(sn2)``, the noise that ``predict(include_noise=True)``
adds to the latent variance. Exact inference takes the Gaussian; the
Laplace approximation, EP, KL and VB take the others (ml/gp/gp.py says
which).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _log(v):
    return torch.log(v) if torch.is_tensor(v) else math.log(v)


def _sqrt(v):
    return torch.sqrt(v) if torch.is_tensor(v) else math.sqrt(v)


class Likelihood:
    """Base: elementwise log p(y | f)."""

    name = "likelihood"
    #: True when log p(y|f) is concave in f for fixed y
    log_concave = True
    #: True when this likelihood uses the GP noise_variance hyperparameter
    uses_noise = True

    def log_pdf(self, f, y, sn2):
        raise NotImplementedError

    def noise_pred_variance(self, sn2):
        return sn2 if self.uses_noise else 0.0


class Gaussian(Likelihood):
    name = "gaussian"

    def log_pdf(self, f, y, sn2):
        r = y - f
        return -0.5 * (r * r / sn2 + _log(2 * math.pi * sn2))


class Logistic(Likelihood):
    """p(y=+1|f) = sigma(f), labels in {-1, +1}; no noise parameter."""

    name = "logistic"
    uses_noise = False

    def log_pdf(self, f, y, sn2):
        return F.logsigmoid(y * f)


class Probit(Likelihood):
    """p(y=+1|f) = Phi(f), labels in {-1, +1}; no noise parameter."""

    name = "probit"
    uses_noise = False

    def log_pdf(self, f, y, sn2):
        return torch.special.log_ndtr(y * f)


class StudentsT(Likelihood):
    """Student's-t noise of scale sqrt(sn2) and ``df`` degrees of freedom
    (fixed); not log-concave."""

    name = "students_t"
    log_concave = False

    def __init__(self, df: float = 4.0):
        if df <= 1.0:
            raise ValueError("Student's-t degrees of freedom must be > 1")
        self.df = float(df)

    def log_pdf(self, f, y, sn2):
        nu = self.df
        r2 = (y - f) ** 2
        return (math.lgamma((nu + 1.0) / 2.0) - math.lgamma(nu / 2.0)
                - 0.5 * _log(nu * math.pi * sn2)
                - 0.5 * (nu + 1.0) * torch.log1p(r2 / (nu * sn2)))

    def noise_pred_variance(self, sn2):
        # sn2 nu/(nu-2) for nu > 2, infinite below
        if self.df <= 2.0:
            return float("inf")
        return sn2 * self.df / (self.df - 2.0)


class Laplacian(Likelihood):
    """p(y|f) = exp(-|y-f|/b)/(2b), b = sqrt(sn2/2) (noise variance sn2);
    taken by EP and KL, not by the Laplace approximation."""

    name = "laplacian"

    def log_pdf(self, f, y, sn2):
        b = _sqrt(sn2 / 2.0)
        return -torch.abs(y - f) / b - _log(2.0 * b)
