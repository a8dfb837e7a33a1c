"""GP mean functions.

PyTorch port of ``hilo_mpc_tpu/ml/gp/means.py``: Zero, One, Constant,
Linear and Polynomial means with the Sum/Product/Scale/Power algebra of the
kernels. ``eval(params, x)`` is batch-first: x (..., d) -> (...).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..hyperparameters import Hyperparameter
from .kernels import _unique, as_points, values_of


class Mean:
    acronym = "m"

    def __init__(self, active_dims=None):
        self.active_dims = (None if active_dims is None
                            else np.atleast_1d(np.asarray(active_dims, dtype=int)))
        self._hyperparameters: List[Hyperparameter] = []

    def _add_hp(self, name, value, positive=False, fixed=False):
        hp = Hyperparameter(f"{self.acronym}.{name}", value=value,
                            positive=positive, fixed=fixed)
        self._hyperparameters.append(hp)
        return hp

    @property
    def hyperparameters(self):
        return list(self._hyperparameters)

    def param_values(self, dtype=torch.float64, device="cpu"):
        return values_of(self.hyperparameters, dtype, device)

    def _select(self, x):
        if self.active_dims is None:
            return x
        return x[..., self.active_dims.tolist()]

    def eval(self, params, x):
        raise NotImplementedError

    def __call__(self, X):
        X = as_points(X)
        return self.eval(self.param_values(X.dtype, X.device), X)

    def __add__(self, other):
        return MeanSum(self, other if isinstance(other, Mean)
                       else ConstantMean(float(other)))

    def __radd__(self, other):
        return self.__add__(other)

    def __mul__(self, other):
        if isinstance(other, Mean):
            return MeanProduct(self, other)
        return MeanScale(self, float(other))

    def __rmul__(self, other):
        return self.__mul__(other)

    def __pow__(self, p):
        return MeanPower(self, float(p))


def _zeros(x):
    return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)


class ZeroMean(Mean):
    acronym = "zero"

    def eval(self, params, x):
        return _zeros(x)


class OneMean(Mean):
    acronym = "one"

    def eval(self, params, x):
        return _zeros(x) + 1.0


class ConstantMean(Mean):
    acronym = "const"

    def __init__(self, bias: float = 1.0, active_dims=None):
        super().__init__(active_dims)
        self.bias = self._add_hp("bias", bias)

    def eval(self, params, x):
        return params[self.bias.key] + _zeros(x)


def _check_coefficients(mean, xs):
    if mean.coefficient.size not in (1, xs.shape[-1]):
        raise ValueError(
            f"{type(mean).__name__}: {mean.coefficient.size} ARD coefficients but "
            f"{xs.shape[-1]} active input dimensions")


class LinearMean(Mean):
    acronym = "lin"

    def __init__(self, coefficient=1.0, active_dims=None):
        super().__init__(active_dims)
        coeff = np.atleast_1d(np.asarray(coefficient, dtype=float))
        self.coefficient = self._add_hp("coefficient", coeff)

    def eval(self, params, x):
        xs = self._select(x)
        _check_coefficients(self, xs)
        return torch.sum(params[self.coefficient.key] * xs, dim=-1)


class PolynomialMean(Mean):
    acronym = "poly"

    def __init__(self, degree: int = 2, coefficient=1.0, offset: float = 0.0,
                 active_dims=None):
        super().__init__(active_dims)
        if int(degree) < 1:
            raise ValueError("degree must be >= 1")
        self.degree = int(degree)
        coeff = np.atleast_1d(np.asarray(coefficient, dtype=float))
        self.coefficient = self._add_hp("coefficient", coeff)
        self.offset = self._add_hp("offset", offset)

    def eval(self, params, x):
        xs = self._select(x)
        _check_coefficients(self, xs)
        return (torch.sum(params[self.coefficient.key] * xs, dim=-1)
                + params[self.offset.key]) ** self.degree


class MeanOperator(Mean):
    def __init__(self, m1: Mean, m2: Optional[Mean] = None):
        super().__init__(None)
        self.mean_1 = m1
        self.mean_2 = m2

    @property
    def hyperparameters(self):
        hps = list(self.mean_1.hyperparameters)
        if self.mean_2 is not None:
            hps += self.mean_2.hyperparameters
        return _unique(hps + self._hyperparameters)


class MeanSum(MeanOperator):
    acronym = "msum"

    def eval(self, params, x):
        return self.mean_1.eval(params, x) + self.mean_2.eval(params, x)


class MeanProduct(MeanOperator):
    acronym = "mprod"

    def eval(self, params, x):
        return self.mean_1.eval(params, x) * self.mean_2.eval(params, x)


class MeanScale(MeanOperator):
    acronym = "mscale"

    def __init__(self, mean: Mean, scale: float):
        super().__init__(mean)
        self.scale = float(scale)

    def eval(self, params, x):
        return self.scale * self.mean_1.eval(params, x)


class MeanPower(MeanOperator):
    acronym = "mpow"

    def __init__(self, mean: Mean, power: float):
        super().__init__(mean)
        self.power = float(power)

    def eval(self, params, x):
        return self.mean_1.eval(params, x) ** self.power
