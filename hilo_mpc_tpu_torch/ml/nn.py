"""Feedforward neural networks that embed into control problems.

PyTorch port of ``hilo_mpc_tpu/ml/nn.py``. ``ArtificialNeuralNetwork`` is a
``torch.nn.Module`` holding one weight ``W`` (in, out) and bias ``b`` per
dense layer (parameters ``W0``, ``b0``, ``W1``, ...; the list of
``{"W", "b"}`` dicts is ``_params``), on the device and in the dtype given
to ``setup`` (``"cuda"`` unless the caller passes ``device="cpu"``).
``predict_fn()`` is a plain function of one sample (or of a batch,
batch-first), traceable under ``torch.func`` and ``make_fx``, so a network
composes into Model and NMPC functions as it is (ml/hybrid.py).

``train`` keeps the JAX package's semantics rather than a typical torch
loop: feature and label scalers from the whole data, a train/validation
split from ``numpy.random.default_rng(seed)``, ``max(1, n_train //
batch_size)`` minibatches per epoch from a fresh permutation, every epoch
run, the parameters of the lowest validation loss over all epochs kept
(patience only truncates the history afterwards), Adam with optax's
defaults (``torch.optim.Adam`` computes the same update), dropout only in
training. Random draws (the initial weights, the permutations, dropout)
come from explicit ``torch.Generator``s seeded from ``seed``, so the bits
differ from ``jax.random`` by design; tests carry weights across.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch._C._functorch import peek_interpreter_stack
from torch.fx.experimental.proxy_tensor import get_proxy_mode

from ..core.model import resolve_device

_ACTIVATIONS = {
    "linear": lambda x: x,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    # jax.nn.softplus is logaddexp(x, 0) (torch's softplus turns linear
    # above a threshold)
    "softplus": lambda x: torch.logaddexp(x, torch.zeros_like(x)),
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "elu": F.elu,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "swish": F.silu,
    "leakyrelu": F.leaky_relu,
}

_LOSSES = {
    "mse": lambda pred, y: torch.mean((pred - y) ** 2),
    "mae": lambda pred, y: torch.mean(torch.abs(pred - y)),
    "huber": lambda pred, y: torch.mean(
        torch.where(torch.abs(pred - y) < 1.0, 0.5 * (pred - y) ** 2,
                    torch.abs(pred - y) - 0.5)),
    "rmse": lambda pred, y: torch.sqrt(torch.mean((pred - y) ** 2) + 1e-12),
    "msle": lambda pred, y: torch.mean(
        (torch.log1p(torch.clamp(pred, min=-1 + 1e-6))
         - torch.log1p(torch.clamp(y, min=-1 + 1e-6))) ** 2),
    "mape": lambda pred, y: torch.mean(torch.abs((y - pred) / (torch.abs(y) + 1e-8))),
    "logcosh": lambda pred, y: torch.mean(
        torch.log(torch.cosh(torch.clamp(pred - y, -30.0, 30.0)))),
}


@dataclasses.dataclass
class Layer:
    """Layer spec (``Layer.dense`` / ``Layer.dropout``)."""

    kind: str
    units: int = 0
    activation: str = "linear"
    rate: float = 0.0

    @staticmethod
    def dense(units: int, activation: str = "linear") -> "Layer":
        act = activation.lower()
        if act not in _ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}; "
                             f"available: {sorted(_ACTIVATIONS)}")
        if units < 1:
            raise ValueError("units must be >= 1")
        return Layer(kind="dense", units=int(units), activation=act)

    @staticmethod
    def dropout(rate: float = 0.5) -> "Layer":
        if not 0 <= rate < 1:
            raise ValueError("dropout rate must be in [0, 1)")
        return Layer(kind="dropout", rate=float(rate))


def _cast(src: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``src`` in the dtype and on the device of ``like``. Under ``make_fx``
    the cast is traced from ``src`` itself, so a trace (the whole-solve
    kernel's, ops/codegen_fx.py) holds the network's own numbers, exact in
    the kernel's float64 instance whatever the traced controller's dtype."""
    return src.to(device=like.device, dtype=like.dtype)


def _cached(src: torch.Tensor):
    """get(like) -> ``_cast(src, like)``, one copy per (dtype, device) made
    outside every ``torch.func`` transform and every trace (as
    ``core/model.py:_device_matrix`` keeps its matrices), so the general
    path casts a layer's weights once."""
    cache = {}

    def get(like):
        key = (like.dtype, like.device)
        tracing = get_proxy_mode() is not None
        if key in cache and not tracing:
            return cache[key]
        t = _cast(src, like)
        if peek_interpreter_stack() is None and not tracing:
            cache[key] = t
        return t

    return get


def Dense(units: int, activation: str = "linear") -> Layer:
    return Layer.dense(units, activation)


def Dropout(rate: float = 0.5) -> Layer:
    return Layer.dropout(rate)


class ArtificialNeuralNetwork(torch.nn.Module):
    """MLP with named input features and output labels."""

    def __init__(self, features=None, labels=None, id: Optional[str] = None,
                 name: Optional[str] = None, seed: int = 0):
        super().__init__()
        self.name = name or "ann"
        self._layers: List[Layer] = []
        self.features: List[str] = ([features] if isinstance(features, str)
                                    else list(features or []))
        self.labels: List[str] = ([labels] if isinstance(labels, str)
                                  else list(labels or []))
        self._data_set = None
        self._n_params = 0
        self._seed = seed
        self._scaler_mean: Optional[np.ndarray] = None
        self._scaler_scale: Optional[np.ndarray] = None
        self._label_mean: Optional[np.ndarray] = None
        self._label_scale: Optional[np.ndarray] = None
        self._normalize = True
        self._setup_done = False
        self._device = torch.device("cpu")
        self._dtype = torch.float32
        self._consts: dict = {}     # id(scaler) -> (scaler, its _cached getter)
        self.history: dict = {}

    # -- declaration ----------------------------------------------------------
    def add_layers(self, *layers: Union[Layer, Sequence[Layer]]):
        """Append layers: a single Layer, a sequence, or several as varargs."""
        for entry in layers:
            if isinstance(entry, Layer):
                self._layers.append(entry)
            else:
                self._layers.extend(entry)
        return self

    def set_features(self, names):
        self.features = [names] if isinstance(names, str) else list(names)
        return self

    def set_labels(self, names):
        self.labels = [names] if isinstance(names, str) else list(names)
        return self

    @property
    def n_inputs(self):
        return len(self.features)

    @property
    def n_outputs(self):
        return len(self.labels)

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def dtype(self) -> torch.dtype:
        return self._dtype

    # -- parameters -------------------------------------------------------------
    @property
    def _params(self) -> Optional[list]:
        """[{"W": (in, out), "b": (out,)}] per dense layer, the output layer
        last (the module's parameters), or None before setup()."""
        if not self._n_params:
            return None
        return [{"W": getattr(self, f"W{i}"), "b": getattr(self, f"b{i}")}
                for i in range(self._n_params)]

    @_params.setter
    def _params(self, params):
        """Set every layer's W and b from arrays or tensors (a network's
        weights carried over), as parameters in this network's dtype on its
        device."""
        for i, p in enumerate(params):
            for k in ("W", "b"):
                v = p[k].detach().cpu().numpy() if torch.is_tensor(p[k]) else p[k]
                t = torch.as_tensor(np.array(v, dtype=float), dtype=self._dtype,
                                    device=self._device)
                setattr(self, f"{k}{i}", torch.nn.Parameter(t))
        self._n_params = len(params)

    # -- build ------------------------------------------------------------------
    def setup(self, normalize: bool = True, device="cuda", dtype=torch.float32,
              **kwargs):
        """He-normal weights (from ``torch.Generator().manual_seed(seed)``,
        drawn on the CPU in float64) and zero biases, on ``device`` in
        ``dtype``; ``normalize`` makes ``train`` fit feature and label
        scalers."""
        if not self.features or not self.labels:
            raise RuntimeError("set_features(...) and set_labels(...) first")
        if not any(l.kind == "dense" for l in self._layers):
            raise RuntimeError("add at least one dense layer (add_layers)")
        self._device = resolve_device(device)
        self._dtype = dtype
        dims = [self.n_inputs]
        for layer in self._layers:
            if layer.kind == "dense":
                dims.append(layer.units)
        dims.append(self.n_outputs)
        gen = torch.Generator().manual_seed(self._seed)
        self._params = [
            {"W": torch.randn((dims[i], dims[i + 1]), generator=gen,
                              dtype=torch.float64) * math.sqrt(2.0 / dims[i]),
             "b": torch.zeros(dims[i + 1], dtype=torch.float64)}
            for i in range(len(dims) - 1)]
        self._normalize = normalize
        self._setup_done = True
        return self

    def is_setup(self):
        return self._setup_done

    def _apply(self, params, x=None, *, train: bool = False, generator=None, **kw):
        """The network on x (..., n_inputs) -> (..., n_outputs) with
        ``params`` (``_params``' layout), the scalers applied; dropout only
        with ``train`` and a ``generator``. Called with one function
        argument it is ``torch.nn.Module._apply`` (``.to()``, ``.double()``,
        ...), whose name the JAX package's method shares."""
        if x is None:
            return super()._apply(params, **kw)
        h = x
        if self._scaler_mean is not None:
            h = (h - self._const(self._scaler_mean, h)) / self._const(self._scaler_scale, h)
        li = 0
        for layer in self._layers:
            if layer.kind == "dense":
                p = params[li]
                h = _ACTIVATIONS[layer.activation](h @ p["W"].to(h) + p["b"].to(h))
                li += 1
            elif layer.kind == "dropout" and train and generator is not None:
                keep = torch.rand(h.shape, generator=generator, dtype=h.dtype,
                                  device=h.device) < 1.0 - layer.rate
                h = torch.where(keep, h / (1.0 - layer.rate), torch.zeros_like(h))
        p = params[-1]
        out = h @ p["W"].to(h) + p["b"].to(h)
        if self._label_mean is not None:
            out = out * self._const(self._label_scale, out) + self._const(
                self._label_mean, out)
        return out

    def _const(self, arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
        """A scaler as a tensor of the dtype and device of ``like``, through
        ``_cached`` (one getter per array: ``train`` sets new ones)."""
        hit = self._consts.get(id(arr))
        if hit is None or hit[0] is not arr:
            hit = self._consts[id(arr)] = (arr, _cached(torch.as_tensor(
                arr, dtype=torch.float64)))
        return hit[1](like)

    def forward(self, x):
        return self._apply(self._params, x)

    def eval(self):
        """Inference mode of ``torch.nn.Module`` (this class's ``train`` is
        the JAX package's training loop, so ``eval`` does not call it)."""
        self.training = False
        return self

    def add_data_set(self, data):
        """Attach training data: a DataSet, a pandas DataFrame with named
        columns, or a dict of named columns."""
        self._data_set = data
        return self

    def _data_from_attached(self):
        data = self._data_set
        if data is None:
            raise RuntimeError("no training data: pass X/y or add_data_set(...)")
        if hasattr(data, "features_values"):
            return data.features_values, data.labels_values
        # pandas DataFrame or dict of columns
        getcol = (data.__getitem__ if not hasattr(data, "loc")
                  else (lambda k: data[k].to_numpy()))
        X = np.stack([np.asarray(getcol(k), dtype=float)
                      for k in self.features], axis=1)
        y = np.stack([np.asarray(getcol(k), dtype=float)
                      for k in self.labels], axis=1)
        return X, y

    # -- training -----------------------------------------------------------------
    def train(self, batch_size: int = 64, epochs: int = 500, X=None, y=None,
              data_set=None, learning_rate: float = 1e-3,
              validation_split: float = 0.2, test_split: Optional[float] = None,
              patience: int = 50, loss: str = "mse", verbose: int = 0,
              shuffle: bool = True, tensorboard: bool = False,
              tensorboard_log_dir: str = "./runs", **_ignored):
        """Minibatch Adam on this network's device and dtype (see the module
        docstring for the semantics). The loop keeps everything on the
        device: the best parameters are selected per epoch by
        ``torch.where``, and the history comes back once at the end."""
        if not self._setup_done:
            self.setup()
        if test_split is not None:
            validation_split = test_split
        if data_set is not None:
            self._data_set = data_set
        if X is None and self._data_set is not None:
            X, y = self._data_from_attached()
        X = np.asarray(X, dtype=float)
        y = np.asarray(y, dtype=float)
        if X.ndim == 1:
            X = X[:, None]
        if X.shape[1] != self.n_inputs and X.shape[0] == self.n_inputs:
            X = X.T
        if y.ndim == 1:
            y = y[:, None]
        if y.shape[1] != self.n_outputs and y.shape[0] == self.n_outputs:
            y = y.T
        if loss not in _LOSSES:
            raise ValueError(f"unknown loss {loss!r}; available {sorted(_LOSSES)}")
        loss_fn = _LOSSES[loss]

        if self._normalize:
            self._scaler_mean = X.mean(axis=0)
            self._scaler_scale = X.std(axis=0) + 1e-8
            self._label_mean = y.mean(axis=0)
            self._label_scale = y.std(axis=0) + 1e-8

        n = X.shape[0]
        rng = np.random.default_rng(self._seed)
        idx = rng.permutation(n) if shuffle else np.arange(n)
        n_val = int(n * validation_split)
        val_idx, tr_idx = idx[:n_val], idx[n_val:]
        kw = dict(dtype=self._dtype, device=self._device)
        X_tr, y_tr = torch.as_tensor(X[tr_idx], **kw), torch.as_tensor(y[tr_idx], **kw)
        X_val, y_val = torch.as_tensor(X[val_idx], **kw), torch.as_tensor(y[val_idx], **kw)

        writer = None
        if tensorboard:
            from ..utils.tb_events import EventFileWriter

            writer = EventFileWriter(log_dir=tensorboard_log_dir)

        params = list(self.parameters())
        opt = torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
        gen = torch.Generator(device=self._device).manual_seed(self._seed + 1)
        n_tr = X_tr.shape[0]
        steps = max(1, n_tr // batch_size)
        best_val = torch.tensor(float("inf"), **kw)
        best = [p.detach().clone() for p in params]
        tr_hist, vl_hist = [], []
        for _ in range(epochs):
            order = torch.randperm(n_tr, generator=gen, device=self._device)
            acc = torch.zeros((), **kw)
            for s in range(steps):
                sel = order[s * batch_size:(s + 1) * batch_size]
                batch_loss = loss_fn(self._apply(self._params, X_tr[sel], train=True,
                                                 generator=gen), y_tr[sel])
                opt.zero_grad(set_to_none=True)
                batch_loss.backward()
                opt.step()
                acc = acc + batch_loss.detach()
            tr_l = acc / steps
            with torch.no_grad():
                vl = loss_fn(self._apply(self._params, X_val), y_val) if n_val else tr_l
                better = vl < best_val - 1e-9
                best_val = torch.where(better, vl, best_val)
                best = [torch.where(better, p, b) for p, b in zip(params, best)]
            tr_hist.append(tr_l)
            vl_hist.append(vl)
        tr_hist = torch.stack(tr_hist).cpu().numpy() if epochs else np.zeros(0)
        vl_hist = torch.stack(vl_hist).cpu().numpy() if epochs else np.zeros(0)
        # patience truncates the history at the epoch the sequential rule
        # would stop at (the best parameters are already tracked)
        stop = len(vl_hist)
        best_seen, bad = np.inf, 0
        for e, v in enumerate(vl_hist):
            if v < best_seen - 1e-9:
                best_seen, bad = v, 0
            else:
                bad += 1
                if bad >= patience:
                    stop = e + 1
                    break
        hist = {"loss": list(tr_hist[:stop]), "val_loss": list(vl_hist[:stop])}
        if writer is not None:
            for e in range(stop):
                writer.add_scalar("loss/train", float(tr_hist[e]), e)
                writer.add_scalar("loss/val", float(vl_hist[e]), e)
            writer.close()
        if verbose:
            for e in range(0, stop, max(1, epochs // 10)):
                print(f"epoch {e}: loss={tr_hist[e]:.5f} val={vl_hist[e]:.5f}")
        with torch.no_grad():
            for p, b in zip(params, best):
                p.copy_(b)
        self.history = hist
        return self

    # -- inference ---------------------------------------------------------------
    def predict_fn(self) -> Callable:
        """y = f(x) for one sample (n_inputs,), or batch-first (..., n_inputs):
        a plain function of the parameters as they are now (detached; one
        copy per dtype and device of the argument), traceable into Model
        and NMPC functions."""
        if self._params is None:
            raise RuntimeError("setup()/train() first")
        params = [{k: _cached(v.detach().clone()) for k, v in p.items()}
                  for p in self._params]

        def fn(x):
            x = torch.atleast_1d(x)
            return self._apply([{k: get(x) for k, get in p.items()} for p in params], x)

        return fn

    def predict(self, X):
        """The network on the rows of X (numpy in, numpy out), on this
        network's device in its dtype."""
        X = np.asarray(X, dtype=float)
        if X.ndim == 1 and self.n_inputs == 1:
            X = X[:, None]
        elif X.ndim == 1:
            X = X[None, :]
        if X.shape[1] != self.n_inputs and X.shape[0] == self.n_inputs:
            X = X.T
        with torch.no_grad():
            out = self.predict_fn()(torch.as_tensor(X, dtype=self._dtype,
                                                    device=self._device))
        return out.cpu().numpy()

    build_graph = predict_fn
