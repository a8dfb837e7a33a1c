"""Hyperparameter priors: Gaussian, Laplace, Student's t and Delta log-pdfs,
contributed to a fit objective.

PyTorch port of ``hilo_mpc_tpu/ml/priors.py``. ``log_pdf`` takes a tensor
(or anything ``torch.as_tensor`` takes, as float64) and returns a 0-d
tensor of its dtype, differentiable in ``value``.
"""
from __future__ import annotations

import math

import torch


def _tensor(value) -> torch.Tensor:
    return value if torch.is_tensor(value) else torch.as_tensor(value,
                                                                 dtype=torch.float64)


class Prior:
    def log_pdf(self, value):
        raise NotImplementedError


class GaussianPrior(Prior):
    def __init__(self, mean: float = 0.0, variance: float = 1.0):
        if variance <= 0:
            raise ValueError("variance must be > 0")
        self.mean = float(mean)
        self.variance = float(variance)

    def log_pdf(self, value):
        d = _tensor(value) - self.mean
        return torch.sum(-0.5 * d * d / self.variance
                         - 0.5 * math.log(2 * math.pi * self.variance))


class LaplacePrior(Prior):
    def __init__(self, mean: float = 0.0, scale: float = 1.0):
        if scale <= 0:
            raise ValueError("scale must be > 0")
        self.mean = float(mean)
        self.scale = float(scale)

    def log_pdf(self, value):
        return torch.sum(-torch.abs(_tensor(value) - self.mean) / self.scale
                         - math.log(2 * self.scale))


class StudentsTPrior(Prior):
    def __init__(self, mean: float = 0.0, scale: float = 1.0, nu: float = 3.0):
        if scale <= 0 or nu <= 0:
            raise ValueError("scale and nu must be > 0")
        self.mean = float(mean)
        self.scale = float(scale)
        self.nu = float(nu)

    def log_pdf(self, value):
        v = _tensor(value)
        z = (v - self.mean) / self.scale
        nu = self.nu
        half = torch.tensor([(nu + 1) / 2, nu / 2], dtype=v.dtype, device=v.device)
        lg = torch.lgamma(half)
        const = (lg[0] - lg[1] - 0.5 * math.log(nu * math.pi) - math.log(self.scale))
        return torch.sum(const - (nu + 1) / 2 * torch.log1p(z * z / nu))


class DeltaPrior(Prior):
    """Fixes the parameter at a point (infinite density; excluded from fitting)."""

    def __init__(self, value: float = 0.0):
        self.value = float(value)

    def log_pdf(self, value):
        v = _tensor(value)
        return torch.zeros((), dtype=v.dtype, device=v.device)
