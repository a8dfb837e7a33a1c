"""Hyperparameters with positivity transforms, bounds, fixed flags and priors.

PyTorch port of ``hilo_mpc_tpu/ml/hyperparameters.py``: a positive
parameter is fitted in log space, ``fixed`` (or ``bounds="fixed"``)
excludes it from fitting, ``bounds`` clip the search space, and an optional
prior (ml/priors.py) contributes its log-pdf to the fit objective. The
value is kept as a float64 numpy array; the transforms take numpy arrays or
tensors and return the same kind.
"""
from __future__ import annotations

import numpy as np
import torch


class Hyperparameter:
    # a serial per instance gives every instance its own params-dict key: two
    # kernels or means of one family in one composite must not alias each
    # other's entries; ``name`` stays the readable identifier
    _serial = 0

    def __init__(self, name: str, value=1.0, positive: bool = True,
                 fixed: bool = False, bounds=None, prior=None):
        self.name = name
        Hyperparameter._serial += 1
        self.key = f"{name}#{Hyperparameter._serial}"
        self.positive = bool(positive)
        self.fixed = bool(fixed)
        if prior is not None and not hasattr(prior, "log_pdf"):
            raise TypeError(
                f"{name}: prior must be a Prior distribution with a log_pdf "
                f"(got {type(prior).__name__})")
        self.prior = prior
        self._value = np.atleast_1d(np.asarray(value, dtype=float))
        if self.positive and np.any(self._value <= 0):
            raise ValueError(f"{name}: positive hyperparameter must be > 0")
        if bounds == "fixed":
            self.fixed = True
            bounds = None
        self.bounds = bounds

    @property
    def value(self) -> np.ndarray:
        return self._value

    @value.setter
    def value(self, v):
        v = np.atleast_1d(np.asarray(v, dtype=float))
        if self.positive and np.any(v <= 0):
            raise ValueError(f"{self.name}: must be > 0")
        self._value = v

    @property
    def size(self) -> int:
        return self._value.size

    # -- transform to/from the unconstrained fitting space -------------------
    def to_unconstrained(self) -> np.ndarray:
        return np.log(self._value) if self.positive else np.array(self._value)

    def from_unconstrained(self, w):
        if torch.is_tensor(w):
            return torch.exp(w) if self.positive else w
        return np.exp(w) if self.positive else np.asarray(w)

    def log_prior(self, value):
        if self.prior is None:
            return 0.0
        return self.prior.log_pdf(value)

    def __repr__(self):
        return (f"Hyperparameter({self.name!r}, value={self._value}, "
                f"positive={self.positive}, fixed={self.fixed})")
