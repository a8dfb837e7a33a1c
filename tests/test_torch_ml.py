"""PyTorch port: neural networks, priors, hyperparameters and the TensorBoard
event writer against the JAX package (CPU, float64 unless stated; weights
carried across with ``utils/interop.py:ann_from``)."""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hilo_mpc_tpu.ml import nn as jnn
from hilo_mpc_tpu.ml import hyperparameters as jhyp
from hilo_mpc_tpu.ml import priors as jpriors
from hilo_mpc_tpu.utils import tb_events as jtb
from hilo_mpc_tpu_torch import ANN, Dense, Dropout, Layer
from hilo_mpc_tpu_torch.ml import hyperparameters as thyp
from hilo_mpc_tpu_torch.ml import nn as tnn
from hilo_mpc_tpu_torch.ml import priors as tpriors
from hilo_mpc_tpu_torch.utils import tb_events as ttb
from hilo_mpc_tpu_torch.utils.data import DataSet
from hilo_mpc_tpu_torch.utils.interop import ann_from

torch.set_num_threads(1)
CPU = "cpu"
F64 = torch.float64


def jax_ann(layers, n_in=2, n_out=1, seed=0, normalize=True):
    ann = jnn.ArtificialNeuralNetwork([f"x{i}" for i in range(n_in)],
                                      [f"y{i}" for i in range(n_out)], seed=seed)
    ann.add_layers(layers)
    return ann.setup(normalize=normalize)


@pytest.mark.parametrize("act", sorted(tnn._ACTIVATIONS))
def test_activation_matches_jax(act):
    """A 3-5-4-2 network with ``act`` in both hidden layers, the JAX weights
    and label scalers carried across: predictions to 1e-12."""
    j = jax_ann([jnn.Dense(5, act), jnn.Dense(4, act)], n_in=3, n_out=2, seed=3)
    rng = np.random.default_rng(1)
    j._scaler_mean, j._scaler_scale = rng.normal(size=3), 1.0 + rng.uniform(size=3)
    j._label_mean, j._label_scale = rng.normal(size=2), 1.0 + rng.uniform(size=2)
    t = ann_from(j, device=CPU, dtype=F64)
    X = 3.0 * rng.normal(size=(16, 3))
    pj = np.asarray(jax.vmap(j.predict_fn())(jnp.asarray(X)))
    np.testing.assert_allclose(t.predict(X), pj, rtol=0, atol=1e-12)


@pytest.mark.parametrize("loss", sorted(tnn._LOSSES))
def test_loss_matches_jax(loss):
    rng = np.random.default_rng(2)
    pred, y = rng.normal(size=(32, 2)), rng.normal(size=(32, 2))
    lj = float(jnn._LOSSES[loss](jnp.asarray(pred), jnp.asarray(y)))
    lt = float(tnn._LOSSES[loss](torch.as_tensor(pred), torch.as_tensor(y)))
    assert abs(lt - lj) <= 1e-12 * max(1.0, abs(lj))


def test_full_batch_training_matches_jax():
    """No dropout, the batch the whole training set (so JAX's permutation
    leaves the mean loss as it is), the same starting weights: after 20
    epochs the history and the weights kept agree to 1e-6."""
    rng = np.random.default_rng(0)
    X = rng.uniform(-1, 1, size=(50, 2))
    y = np.sin(2 * X[:, 0]) + X[:, 1] ** 2
    j = jax_ann([jnn.Dense(8, "tanh"), jnn.Dense(8, "tanh")])
    t = ann_from(j, device=CPU, dtype=F64)
    j.train(batch_size=40, epochs=20, X=X, y=y, learning_rate=1e-2)
    jW = [{k: np.asarray(v) for k, v in p.items()} for p in j._params]
    t.train(batch_size=40, epochs=20, X=X, y=y, learning_rate=1e-2)
    for key in ("loss", "val_loss"):
        assert len(t.history[key]) == len(j.history[key]) == 20
        np.testing.assert_allclose(t.history[key], j.history[key], rtol=0, atol=1e-6)
    for pt, pj in zip(t._params, jW):
        for k in ("W", "b"):
            np.testing.assert_allclose(pt[k].detach().numpy(), pj[k], rtol=0, atol=1e-6)
    np.testing.assert_allclose(t._label_scale, j._label_scale, rtol=0, atol=0)


def test_layer_validation():
    with pytest.raises(ValueError):
        Layer.dense(3, activation="nope")
    with pytest.raises(ValueError):
        Layer.dropout(1.5)
    with pytest.raises(RuntimeError, match="dense layer"):
        ANN(["a"], ["b"]).setup(device=CPU)
    with pytest.raises(RuntimeError, match="PyTorch sees no CUDA"):
        if torch.cuda.is_available():
            raise RuntimeError("PyTorch sees no CUDA device (skipped on a card)")
        ANN(["a"], ["b"]).add_layers(Dense(2)).setup()


def test_fits_quadratic():
    """tests/test_ml.py's quadratic fit, float32, with a dropout layer (only
    active in training, from the network's generator)."""
    rng = np.random.default_rng(0)
    X = rng.uniform(-1, 1, size=(400, 1))
    ann = ANN(["x"], ["y"])
    ann.add_layers([Dense(32, activation="tanh"), Dropout(0.05),
                    Dense(32, activation="tanh")])
    ann.setup(device=CPU)
    ann.train(batch_size=64, epochs=300, X=X, y=X[:, 0] ** 2, patience=100)
    pred = ann.predict(np.array([[0.5], [-0.5], [0.0]]))
    np.testing.assert_allclose(pred.ravel(), [0.25, 0.25, 0.0], atol=0.05)
    assert ann.predict(np.array([[0.5]])).dtype == np.float32


@pytest.mark.parametrize("kind", ["dict", "dataframe", "dataset"])
def test_dataframe_like_data(kind):
    cols = {"a": np.linspace(0, 1, 50), "b": np.linspace(1, 2, 50),
            "out": np.linspace(0, 1, 50) * 2}
    if kind == "dataframe":
        pd = pytest.importorskip("pandas")
        data = pd.DataFrame(cols)
    elif kind == "dataset":
        data = DataSet(["a", "b"], ["out"]).add_data(
            np.stack([cols["a"], cols["b"]], 1), cols["out"][:, None])
    else:
        data = cols
    ann = ANN(["a", "b"], ["out"])
    ann.add_layers(Dense(8, activation="tanh"))
    ann.setup(device=CPU, dtype=F64)
    ann.add_data_set(data)
    ann.train(batch_size=16, epochs=200)
    assert ann.history["loss"][-1] < ann.history["loss"][0]


def test_module_surface():
    """The network is an nn.Module: its parameters are W and b per dense
    layer; ``.to()`` (torch's own ``_apply``) and ``eval()`` keep working
    beside the JAX-named ``_apply`` and ``train``."""
    ann = ANN(["a", "b"], ["y"]).add_layers(Dense(3, "tanh")).setup(device=CPU)
    names = [n for n, _ in ann.named_parameters()]
    assert names == ["W0", "b0", "W1", "b1"]
    assert tuple(ann.W0.shape) == (2, 3) and tuple(ann.W1.shape) == (3, 1)
    ann.eval()
    x = torch.ones(4, 2)
    assert torch.equal(ann(x), ann.predict_fn()(x))
    assert ann.to(F64).W0.dtype == F64


def test_event_file_bytes_equal_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1.7e9 + 0.25)
    paths = []
    for mod, d in ((jtb, "jax"), (ttb, "port")):
        w = mod.EventFileWriter(log_dir=str(tmp_path / d))
        for step, (tag, v) in enumerate([("loss/train", 0.5), ("loss/val", -3.25),
                                         ("loss/train", 1e-7)]):
            w.add_scalar(tag, v, step - 1, wall_time=1.7e9 + step)
        w.close()
        paths.append(w.path)
    a, b = (open(p, "rb").read() for p in paths)
    assert a == b and len(a) > 100
    assert ttb.masked_crc(b"abc") == jtb.masked_crc(b"abc")


def _records(path):
    data, out, i = open(path, "rb").read(), [], 0
    while i < len(data):
        n = int.from_bytes(data[i:i + 8], "little")
        out.append(data[i + 12:i + 12 + n])
        i += 16 + n
    return out


def test_training_writes_the_same_records_as_jax(tmp_path, monkeypatch):
    """train(tensorboard=True) on both packages, the same weights and data:
    as many records, in the same order, each scalar the same to 1e-6."""
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    rng = np.random.default_rng(0)
    X = rng.uniform(-1, 1, size=(20, 1))
    j = jax_ann([jnn.Dense(4, "tanh")], n_in=1)
    t = ann_from(j, device=CPU, dtype=F64)
    j.train(batch_size=16, epochs=4, X=X, y=X[:, 0] ** 2, tensorboard=True,
            tensorboard_log_dir=str(tmp_path / "jax"))
    t.train(batch_size=16, epochs=4, X=X, y=X[:, 0] ** 2, tensorboard=True,
            tensorboard_log_dir=str(tmp_path / "port"))
    rj, rt = (_records(next((tmp_path / d).glob("events.out.tfevents.*")))
              for d in ("jax", "port"))
    assert len(rt) == len(rj) == 1 + 2 * 4
    assert rt[0] == rj[0]
    for a, b in zip(rt[1:], rj[1:]):
        assert a[:-4] == b[:-4]           # wall time, step, tag
        va, vb = (np.frombuffer(r[-4:], "<f4")[0] for r in (a, b))
        assert abs(float(va) - float(vb)) <= 1e-6


@pytest.mark.parametrize("prior", [
    ("GaussianPrior", dict(mean=0.3, variance=2.0)),
    ("LaplacePrior", dict(mean=-0.1, scale=0.7)),
    ("StudentsTPrior", dict(mean=0.2, scale=1.5, nu=4.0)),
    ("DeltaPrior", dict(value=1.0)),
], ids=lambda p: p[0])
def test_prior_log_pdf_matches_jax(prior):
    name, kw = prior
    v = np.random.default_rng(4).normal(size=5)
    lj = float(getattr(jpriors, name)(**kw).log_pdf(jnp.asarray(v)))
    value = torch.tensor(v, requires_grad=True)
    lt = getattr(tpriors, name)(**kw).log_pdf(value)
    assert abs(float(lt) - lj) <= 1e-12 * max(1.0, abs(lj))
    if name != "DeltaPrior":
        lt.backward()
        assert torch.isfinite(value.grad).all()


def test_prior_validation():
    for cls, kw in ((tpriors.GaussianPrior, dict(variance=0.0)),
                    (tpriors.LaplacePrior, dict(scale=-1.0)),
                    (tpriors.StudentsTPrior, dict(nu=0.0))):
        with pytest.raises(ValueError):
            cls(**kw)


def test_hyperparameter_matches_jax():
    v = np.array([0.3, 2.5])
    pj = jhyp.Hyperparameter("SE.length_scales", v, bounds=(1e-3, 10.0),
                             prior=jpriors.GaussianPrior(0.0, 1.0))
    pt = thyp.Hyperparameter("SE.length_scales", v, bounds=(1e-3, 10.0),
                             prior=tpriors.GaussianPrior(0.0, 1.0))
    np.testing.assert_allclose(pt.to_unconstrained(), pj.to_unconstrained(),
                               rtol=0, atol=1e-12)
    w = pt.to_unconstrained()
    np.testing.assert_allclose(pt.from_unconstrained(w), pj.from_unconstrained(w),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(pt.from_unconstrained(torch.as_tensor(w)).numpy(), v,
                               rtol=0, atol=1e-12)
    lj = float(pj.log_prior(jnp.asarray(v)))
    assert abs(float(pt.log_prior(torch.as_tensor(v))) - lj) <= 1e-12
    assert pt.bounds == (1e-3, 10.0) and not pt.fixed and pt.size == 2
    assert pt.key != thyp.Hyperparameter("SE.length_scales").key
    free = thyp.Hyperparameter("offset", -1.5, positive=False)
    assert free.to_unconstrained()[0] == -1.5 and free.log_prior(0.0) == 0.0
    assert thyp.Hyperparameter("sv", 1.0, bounds="fixed").fixed
    with pytest.raises(ValueError):
        thyp.Hyperparameter("sv", -1.0)
    with pytest.raises(ValueError):
        pt.value = [0.0, 1.0]
    with pytest.raises(TypeError):
        thyp.Hyperparameter("sv", 1.0, prior=3.0)
