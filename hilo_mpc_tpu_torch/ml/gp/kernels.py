"""GP covariance kernels.

PyTorch port of ``hilo_mpc_tpu/ml/gp/kernels.py``: the 14 kernels, ``Warp``
and the operator algebra (k1 + k2, k1 * k2, k ** p, scale * k). Every kernel
exposes

  - ``hyperparameters``: the ``Hyperparameter`` objects (positive ones fitted
    in log space),
  - ``eval(params, x, y)``: the covariance of two points, batch-first: x and
    y are (..., d), broadcast against each other, and the result is (...);
    traceable under ``torch.func`` and ``make_fx`` (squared distances are
    written out as arithmetic, so forward-mode derivatives of any order go
    through them),
  - ``gram(params, X, X_bar)``: (..., n, d), (..., m, d) -> (..., n, m),
  - ``__call__(X, X_bar=None)``: the gram with the current values.

``params`` maps each hyperparameter's ``key`` to a tensor; size-1 values
are 0-d. The guards are the JAX package's: ``+ 1e-36`` under every square
root of a squared distance.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from ..hyperparameters import Hyperparameter

Tensor = torch.Tensor


def hp_tensor(hp: Hyperparameter, dtype=torch.float64, device="cpu") -> Tensor:
    """A hyperparameter's value as a tensor; size 1 gives a 0-d tensor."""
    v = torch.as_tensor(np.asarray(hp.value, dtype=float), dtype=dtype, device=device)
    return v.reshape(()) if hp.size == 1 else v


def values_of(hps, dtype=torch.float64, device="cpu") -> Dict[str, Tensor]:
    return {hp.key: hp_tensor(hp, dtype, device) for hp in hps}


def as_points(X, like: Optional[Tensor] = None) -> Tensor:
    """Numeric input as an (n, d) tensor: a tensor keeps its dtype and device
    (or takes ``like``'s), anything else becomes float64 on the CPU; 1-D
    input is one column."""
    if torch.is_tensor(X):
        t = X if like is None else X.to(like)
    else:
        t = torch.as_tensor(np.asarray(X, dtype=float),
                            dtype=torch.float64 if like is None else like.dtype,
                            device="cpu" if like is None else like.device)
    return t[:, None] if t.dim() == 1 else t


def _unique(hps):
    seen, out = set(), []
    for hp in hps:
        if id(hp) not in seen:
            seen.add(id(hp))
            out.append(hp)
    return out


class Kernel:
    """Base class. Subclasses define ``eval(params, x, y)``."""

    acronym = "K"

    def __init__(self, active_dims=None):
        self.active_dims = (None if active_dims is None
                            else np.atleast_1d(np.asarray(active_dims, dtype=int)))
        self._hyperparameters: List[Hyperparameter] = []

    def _add_hp(self, name: str, value, positive: bool = True, fixed: bool = False,
                bounds=None) -> Hyperparameter:
        hp = Hyperparameter(f"{self.acronym}.{name}", value=value,
                            positive=positive, fixed=fixed, bounds=bounds)
        self._hyperparameters.append(hp)
        return hp

    @property
    def hyperparameters(self) -> List[Hyperparameter]:
        return list(self._hyperparameters)

    def param_values(self, dtype=torch.float64, device="cpu") -> Dict[str, Tensor]:
        return values_of(self.hyperparameters, dtype, device)

    def _select(self, x: Tensor) -> Tensor:
        if self.active_dims is None:
            return x
        return x[..., self.active_dims.tolist()]

    def eval(self, params: Dict[str, Tensor], x: Tensor, y: Tensor) -> Tensor:
        raise NotImplementedError

    def gram(self, params, X: Tensor, X_bar: Optional[Tensor] = None) -> Tensor:
        Xb = X if X_bar is None else X_bar
        return self.eval(params, X[..., :, None, :], Xb[..., None, :, :])

    def _check_dims(self, d: int):
        """ARD length scales against the (active) input dimension."""
        d_eff = len(self.active_dims) if self.active_dims is not None else d
        if self.active_dims is not None and np.any(self.active_dims >= d):
            raise ValueError(f"active_dims {self.active_dims.tolist()} out of "
                             f"range for {d}-dimensional input")
        for hp in self._hyperparameters:
            if (hp.name.endswith("length_scales") and hp.size > 1
                    and hp.size != d_eff):
                raise ValueError(
                    f"{hp.name}: {hp.size} ARD length scales for "
                    f"{d_eff} input dimension(s)")

    def __call__(self, X, X_bar=None) -> Tensor:
        X = as_points(X)
        Xb = None
        if X_bar is not None:
            Xb = as_points(X_bar, like=X)
            if Xb.shape[1] != X.shape[1]:
                raise ValueError(
                    f"X and X_bar do not have the same input space "
                    f"dimensions ({X.shape[1]} vs {Xb.shape[1]})")
        self._check_dims(X.shape[1])
        return self.gram(self.param_values(X.dtype, X.device), X, Xb)

    def diag(self, X) -> Tensor:
        X = as_points(X)
        self._check_dims(X.shape[1])
        return self.eval(self.param_values(X.dtype, X.device), X, X)

    # -- operator algebra ---------------------------------------------------
    def __add__(self, other):
        if not isinstance(other, Kernel):
            other = _wrap_const(other)
        return Sum(self, other)

    def __radd__(self, other):
        return Sum(_wrap_const(other), self)

    def __mul__(self, other):
        if isinstance(other, Kernel):
            return Product(self, other)
        return Scale(self, other)

    def __rmul__(self, other):
        return Scale(self, other)

    def __pow__(self, power):
        return Power(self, power)

    def __repr__(self):
        hps = ", ".join(f"{h.name}={np.asarray(h.value)}" for h in
                        self.hyperparameters)
        return f"{type(self).__name__}({hps})"


def _wrap_const(c):
    c = float(c)
    if c < 0:
        raise ValueError("adding a negative constant does not give a valid "
                         "covariance function")
    k = ConstantKernel(bias=c ** 0.5)  # bias is squared in the covariance
    k.bias.fixed = True
    return k


def _batch_zeros(x: Tensor, y: Tensor) -> Tensor:
    return torch.zeros(torch.broadcast_shapes(x.shape[:-1], y.shape[:-1]),
                       dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# stationary family
# ---------------------------------------------------------------------------


class ConstantKernel(Kernel):
    """k(x, x') = bias^2: the stored value acts as a standard deviation."""

    acronym = "Const"

    def __init__(self, bias: float = 1.0, active_dims=None, bounds=None):
        super().__init__(active_dims)
        self.bias = self._add_hp("bias", bias, bounds=bounds)

    def eval(self, params, x, y):
        return params[self.bias.key] ** 2 + _batch_zeros(x, y)


class StationaryKernel(Kernel):
    """Kernels of the scaled distance r̄² = Σ ((x_i - y_i)/ℓ_i)²."""

    def __init__(self, active_dims=None, signal_variance: float = 1.0,
                 length_scales=1.0, ard: Optional[int] = None, bounds=None):
        super().__init__(active_dims)
        self.signal_variance = self._add_hp("signal_variance", signal_variance)
        ls = np.atleast_1d(np.asarray(length_scales, dtype=float))
        self.length_scales = self._add_hp("length_scales", ls)

    def _r2(self, params, x, y):
        d = (self._select(x) - self._select(y)) / params[self.length_scales.key]
        return torch.sum(d * d, dim=-1)


class GammaExponentialKernel(StationaryKernel):
    acronym = "GE"

    def __init__(self, active_dims=None, signal_variance=1.0, gamma: float = 1.0,
                 length_scales=1.0, alpha=None, **kw):
        super().__init__(active_dims, signal_variance, length_scales)
        if alpha is not None:
            gamma = alpha
        if not 0 < gamma <= 2:
            raise ValueError("gamma must be in (0, 2]")
        self.gamma = self._add_hp("gamma", gamma, fixed=True)

    def eval(self, params, x, y):
        r2 = self._r2(params, x, y)
        g = params[self.gamma.key]
        return params[self.signal_variance.key] ** 2 * torch.exp(
            -0.5 * (r2 + 1e-36) ** (g / 2.0))


class SquaredExponentialKernel(StationaryKernel):
    acronym = "SE"

    def eval(self, params, x, y):
        return params[self.signal_variance.key] ** 2 * torch.exp(
            -0.5 * self._r2(params, x, y))


class MaternKernel(StationaryKernel):
    """Matern of half-integer smoothness nu = p + 1/2 in the polynomial form
    k = sv^2 exp(-d) Γ(p+1)/Γ(2p+1) Σ_i (p+i)!/(i!(p-i)!) (2d)^(p-i),
    d = sqrt(2 nu) r (Rasmussen & Williams eq. 4.16)."""

    acronym = "M"

    def __init__(self, nu: float = 1.5, active_dims=None, signal_variance=1.0,
                 length_scales=1.0, **kw):
        super().__init__(active_dims, signal_variance, length_scales)
        p = nu - 0.5
        if p < 0 or abs(p - round(p)) > 1e-12:
            raise ValueError("nu must be a half-integer: 0.5, 1.5, 2.5, 3.5, ...")
        self.nu = nu
        self._p = pp = int(round(p))
        norm = math.factorial(pp) / math.factorial(2 * pp)
        # _poly[k] multiplies d^k (k = 0 .. p)
        self._poly = np.array(
            [norm * math.factorial(pp + i) / (math.factorial(i) * math.factorial(pp - i))
             * 2.0 ** (pp - i) for i in range(pp + 1)][::-1])

    def eval(self, params, x, y):
        r = torch.sqrt(self._r2(params, x, y) + 1e-36)
        sv = params[self.signal_variance.key] ** 2
        d = math.sqrt(2.0 * self.nu) * r
        f = torch.zeros_like(d)
        for c in self._poly[::-1]:   # Horner
            f = f * d + float(c)
        return sv * f * torch.exp(-d)


class ExponentialKernel(MaternKernel):
    acronym = "E"

    def __init__(self, active_dims=None, signal_variance=1.0, length_scales=1.0,
                 **kw):
        super().__init__(0.5, active_dims, signal_variance, length_scales)


class Matern32Kernel(MaternKernel):
    acronym = "M32"

    def __init__(self, active_dims=None, signal_variance=1.0, length_scales=1.0,
                 **kw):
        super().__init__(1.5, active_dims, signal_variance, length_scales)


class Matern52Kernel(MaternKernel):
    acronym = "M52"

    def __init__(self, active_dims=None, signal_variance=1.0, length_scales=1.0,
                 **kw):
        super().__init__(2.5, active_dims, signal_variance, length_scales)


class RationalQuadraticKernel(StationaryKernel):
    acronym = "RQ"

    def __init__(self, active_dims=None, signal_variance=1.0, length_scales=1.0,
                 alpha: float = 1.0, **kw):
        super().__init__(active_dims, signal_variance, length_scales)
        self.alpha = self._add_hp("alpha", alpha)

    def eval(self, params, x, y):
        r2 = self._r2(params, x, y)
        a = params[self.alpha.key]
        return params[self.signal_variance.key] ** 2 * (1.0 + r2 / (2.0 * a)) ** (-a)


class PiecewisePolynomialKernel(StationaryKernel):
    """Compact-support piecewise polynomial (Rasmussen & Williams eq. 4.21),
    q in {0, 1, 2, 3}."""

    acronym = "PP"

    def __init__(self, q: int = 0, active_dims=None, signal_variance=1.0,
                 length_scales=1.0, degree: Optional[int] = None, **kw):
        super().__init__(active_dims, signal_variance, length_scales)
        if degree is not None:
            q = degree
        if q not in (0, 1, 2, 3):
            raise ValueError("q (degree) must be one of 0, 1, 2, 3")
        self.q = int(q)

    def eval(self, params, x, y):
        D = self._select(x).shape[-1]
        j = D // 2 + self.q + 1
        r = torch.sqrt(self._r2(params, x, y) + 1e-36)
        base = torch.maximum(1.0 - r, r.new_tensor(0.0))
        q = self.q
        if q == 0:
            poly = torch.ones_like(r)
            e = j
        elif q == 1:
            poly = (j + 1) * r + 1.0
            e = j + 1
        elif q == 2:
            poly = ((j ** 2 + 4 * j + 3) * r ** 2 + (3 * j + 6) * r + 3.0) / 3.0
            e = j + 2
        else:
            poly = ((j ** 3 + 9 * j ** 2 + 23 * j + 15) * r ** 3
                    + (6 * j ** 2 + 36 * j + 45) * r ** 2
                    + (15 * j + 45) * r + 15.0) / 15.0
            e = j + 3
        return params[self.signal_variance.key] ** 2 * base ** e * poly


# ---------------------------------------------------------------------------
# dot-product family
# ---------------------------------------------------------------------------


class DotProductKernel(Kernel):
    acronym = "DP"

    def __init__(self, active_dims=None, signal_variance=1.0, length_scales=1.0,
                 offset: float = 1.0, **kw):
        super().__init__(active_dims)
        self.signal_variance = self._add_hp("signal_variance", signal_variance)
        ls = np.atleast_1d(np.asarray(length_scales, dtype=float))
        self.length_scales = self._add_hp("length_scales", ls)
        self.offset = self._add_hp("offset", offset, positive=False)

    def _dot(self, params, x, y):
        ls = params[self.length_scales.key]
        return (torch.sum((self._select(x) / ls) * (self._select(y) / ls), dim=-1)
                + params[self.offset.key])

    def eval(self, params, x, y):
        return params[self.signal_variance.key] ** 2 * self._dot(params, x, y)


class PolynomialKernel(DotProductKernel):
    acronym = "Poly"

    def __init__(self, degree: int, active_dims=None, signal_variance=1.0,
                 length_scales=1.0, offset: float = 1.0, **kw):
        super().__init__(active_dims, signal_variance, length_scales, offset)
        if int(degree) < 1:
            raise ValueError("degree must be >= 1")
        self.degree = int(degree)

    def eval(self, params, x, y):
        return params[self.signal_variance.key] ** 2 * self._dot(
            params, x, y) ** self.degree


class LinearKernel(PolynomialKernel):
    acronym = "Lin"

    def __init__(self, active_dims=None, signal_variance=1.0, length_scales=1.0,
                 **kw):
        super().__init__(1, active_dims, signal_variance, length_scales,
                         offset=0.0)
        self.offset.fixed = True


class NeuralNetworkKernel(Kernel):
    """Arcsine (MLP) kernel:
    k = sv^2 asin((1 + x.y) / (sqrt(wv^2 + 1 + x.x) sqrt(wv^2 + 1 + y.y)))."""

    acronym = "NN"

    def __init__(self, active_dims=None, signal_variance=1.0,
                 weight_variance: float = 1.0, **kw):
        super().__init__(active_dims)
        self.signal_variance = self._add_hp("signal_variance", signal_variance)
        self.weight_variance = self._add_hp("weight_variance", weight_variance)

    def eval(self, params, x, y):
        xs, ys = self._select(x), self._select(y)
        wv2 = params[self.weight_variance.key] ** 2
        num = 1.0 + torch.sum(xs * ys, dim=-1)
        den = torch.sqrt((wv2 + 1.0 + torch.sum(xs * xs, dim=-1))
                         * (wv2 + 1.0 + torch.sum(ys * ys, dim=-1)))
        return params[self.signal_variance.key] ** 2 * torch.asin(
            torch.minimum(torch.maximum(num / den, num.new_tensor(-1.0)),
                          num.new_tensor(1.0)))


class PeriodicKernel(Kernel):
    acronym = "Per"

    def __init__(self, active_dims=None, signal_variance=1.0, length_scales=1.0,
                 period: float = 1.0, **kw):
        super().__init__(active_dims)
        self.signal_variance = self._add_hp("signal_variance", signal_variance)
        ls = np.atleast_1d(np.asarray(length_scales, dtype=float))
        self.length_scales = self._add_hp("length_scales", ls)
        self.period = self._add_hp("period", period)

    def eval(self, params, x, y):
        ls = params[self.length_scales.key]
        p = params[self.period.key]
        s = torch.sin(math.pi * torch.abs(self._select(x) - self._select(y)) / p) / ls
        return params[self.signal_variance.key] ** 2 * torch.exp(
            -2.0 * torch.sum(s * s, dim=-1))


# ---------------------------------------------------------------------------
# operator algebra
# ---------------------------------------------------------------------------


class KernelOperator(Kernel):
    def __init__(self, kernel_1: Kernel, kernel_2: Optional[Kernel] = None):
        super().__init__(None)
        self.kernel_1 = kernel_1
        self.kernel_2 = kernel_2

    def _check_dims(self, d: int):
        self.kernel_1._check_dims(d)
        if self.kernel_2 is not None:
            self.kernel_2._check_dims(d)

    @property
    def hyperparameters(self):
        hps = list(self.kernel_1.hyperparameters)
        if self.kernel_2 is not None:
            hps += self.kernel_2.hyperparameters
        return _unique(hps + self._hyperparameters)


class Sum(KernelOperator):
    acronym = "Sum"

    def eval(self, params, x, y):
        return self.kernel_1.eval(params, x, y) + self.kernel_2.eval(params, x, y)


class Product(KernelOperator):
    acronym = "Prod"

    def eval(self, params, x, y):
        return self.kernel_1.eval(params, x, y) * self.kernel_2.eval(params, x, y)


class Scale(KernelOperator):
    acronym = "Scale"

    def __init__(self, kernel: Kernel, scale: float):
        super().__init__(kernel)
        self.scale = self._add_hp("scale", float(scale), fixed=True)

    def eval(self, params, x, y):
        return params[self.scale.key] * self.kernel_1.eval(params, x, y)


class Power(KernelOperator):
    acronym = "Pow"

    def __init__(self, kernel: Kernel, power: float):
        super().__init__(kernel)
        self.power = float(power)

    def eval(self, params, x, y):
        return self.kernel_1.eval(params, x, y) ** self.power


class Warp(KernelOperator):
    """Input warping: k_w(x, x') = k(f(x), f(x')). ``warp`` is a batch-first
    torch function (..., d) -> (..., d') (a value of shape (...) is taken
    as d' = 1). The warped kernel stays positive semi-definite for any
    warp: it is the base kernel on transformed inputs."""

    acronym = "Warp"

    def __init__(self, kernel: Kernel, warp):
        if not callable(warp):
            raise TypeError("warp must be a callable x -> warped x")
        super().__init__(kernel)
        self.warp = warp

    def _check_dims(self, d: int):
        # the base kernel sees the warped space, unknown until evaluation
        pass

    def _warped(self, x):
        fx = self.warp(x)
        return fx[..., None] if fx.dim() < x.dim() else fx

    def eval(self, params, x, y):
        return self.kernel_1.eval(params, self._warped(x), self._warped(y))
