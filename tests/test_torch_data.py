"""PyTorch port: data sets and excitation-signal generators against the JAX
package (CPU, float64): the same numpy draws give the same signals, and the
port's Model.simulate the same features and labels."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hilo_mpc_tpu import Model as JaxModel
from hilo_mpc_tpu.utils import data as jdata
from hilo_mpc_tpu_torch import DataGenerator, DataSet, Model

torch.set_num_threads(1)
CPU = "cpu"
F64 = torch.float64


def first_order(jx, x0=(0.0,)):
    """tests/test_programs_data.py's model, dx/dt = -x + u, RK4, dt 0.1."""
    m = (JaxModel if jx else Model)()
    m.set_dynamical_states("x")
    m.set_inputs("u")
    if jx:
        m.set_dynamical_equations(lambda x, u: -x + u)
        m.setup(dt=0.1, integration_method="rk4")
        m._dtype = jnp.float64
    else:
        m.set_dynamical_equations(lambda x, u: -x + u)
        m.setup(dt=0.1, integration_method="rk4", device=CPU, dtype=F64)
    return m.set_initial_conditions(list(x0))


def two_states(jx):
    m = (JaxModel if jx else Model)()
    m.set_dynamical_states(["p", "v"])
    m.set_inputs(["f", "g"])
    if jx:
        m.set_dynamical_equations(lambda x, u: jnp.array([x[1], -0.5 * x[0] + u[0] - u[1]]))
        m.setup(dt=0.2, integration_method="rk4")
        m._dtype = jnp.float64
    else:
        m.set_dynamical_equations(lambda x, u: torch.stack(
            [x[..., 1], -0.5 * x[..., 0] + u[..., 0] - u[..., 1]], -1))
        m.setup(dt=0.2, integration_method="rk4", device=CPU, dtype=F64)
    return m


@pytest.mark.parametrize("signal, kw", [
    ("random_uniform", dict(lb=[-1.0, 0.0], ub=[1.0, 0.5], hold=3, seed=4)),
    ("random_normal", dict(mean=0.1, std=[0.5, 0.2], hold=2)),
    ("chirp", dict(amplitude=0.5, f0=0.05, f1=0.2, kind="linear")),
    ("chirp", dict(amplitude=0.3, offset=0.1, f0=0.05, f1=0.4, kind="exponential")),
    ("chirp", dict(amplitude=0.3, f0=0.05, f1=0.4, kind="hyperbolic")),
], ids=["random_uniform", "random_normal", "chirp_linear", "chirp_exponential",
        "chirp_hyperbolic"])
@pytest.mark.parametrize("output", ["absolute", "delta", "difference_quotient"])
def test_generator_matches_jax(signal, kw, output):
    """Each signal design and output mode: the input signal equal to JAX's,
    features and labels to 1e-12."""
    gens = [cls(two_states(jx), steps=17, x0=[0.3, -0.1], seed=2)
            for cls, jx in ((jdata.DataGenerator, True), (DataGenerator, False))]
    for g in gens:
        getattr(g, signal)(**kw)
    assert np.array_equal(gens[0]._U, gens[1]._U)
    dj, dt = (g.run(output=output) for g in gens)
    assert dt.features == dj.features == ["p", "v", "f", "g"]
    assert dt.labels == dj.labels == ["p", "v"]
    np.testing.assert_allclose(dt.features_values, dj.features_values, rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(dt.labels_values, dj.labels_values, rtol=0, atol=1e-12)
    np.testing.assert_allclose(dt["t"], dj["t"], rtol=0, atol=0)


def test_closed_loop_and_named_columns_match_jax():
    gens = [cls(first_order(jx), steps=15, x0=[1.0])
            for cls, jx in ((jdata.DataGenerator, True), (DataGenerator, False))]
    for g in gens:
        g.closed_loop(lambda x: -0.5 * x)
    dj, dt = (g.run(output="delta", features=["u", "x"], labels=["x"]) for g in gens)
    assert dt.n_samples == 15 and dt.features == ["u", "x"]
    np.testing.assert_allclose(dt.features_values, dj.features_values, rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(dt.labels_values, dj.labels_values, rtol=0, atol=1e-12)


def test_generator_checks():
    with pytest.raises(RuntimeError, match="input signal"):
        DataGenerator(first_order(False), steps=10).run()
    with pytest.raises(ValueError, match="chirp kind"):
        DataGenerator(first_order(False), steps=10).chirp(kind="square")
    m = Model()
    m.set_dynamical_states("x")
    m.set_inputs("u")
    m.set_dynamical_equations(lambda x, u: -x + u)
    with pytest.raises(RuntimeError, match="set up"):
        DataGenerator(m)


def test_model_generate_data_matches_jax():
    dj = first_order(True).generate_data(kind="random_uniform", steps=30, lb=-1.0,
                                         ub=1.0, seed=0)
    dt = first_order(False).generate_data(kind="random_uniform", steps=30, lb=-1.0,
                                          ub=1.0, seed=0)
    assert dt.n_samples == 30 and dt.features == ["x", "u"]
    np.testing.assert_allclose(dt.features_values, dj.features_values, rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(dt.labels_values, dj.labels_values, rtol=0, atol=1e-12)


def test_dataset_matches_jax():
    """add_data (transposed input), access by name, the split, noise, sort,
    append and copy: the same arrays as JAX's DataSet."""
    rng = np.random.default_rng(0)
    X, y, t = rng.normal(size=(2, 12)), rng.normal(size=(12, 1)), np.arange(12.0)
    sets = [cls(["a", "b"], "y").add_data(X, y, t) for cls in (jdata.DataSet, DataSet)]
    for s in sets:
        s.add_noise(std=0.1, seed=3, what="both")
        s.sort("b")
        s.append(s.copy())
    sj, st = sets
    assert st.n_samples == len(st) == 24
    for k in ("a", "b", "y", "t"):
        np.testing.assert_array_equal(st[k], sj[k])
    (a, b), (c, d) = st.train_test_split(0.25, seed=1), sj.train_test_split(0.25, seed=1)
    for p, q in zip(a + b, c + d):
        np.testing.assert_array_equal(p, q)
    with pytest.raises(ValueError, match="rows"):
        DataSet(["a"], ["y"]).add_data(np.ones((5, 1)), np.zeros((4, 1)))
    with pytest.raises(KeyError):
        st["nope"]
