"""PyTorch port: GPArray (hilo_mpc_tpu_torch/ml/gp/gp.py) against the JAX
package (CPU, float64): fit_model_batched as ONE batched optimization
(L-BFGS with optax.lbfgs's zoom line search and memory, the iterate
clipped to the bounds; Adam), each output's final NLL to 1e-6 relative and
its hyperparameters to 1e-6; the array's predict; the checks that refuse a
heterogeneous array."""
import numpy as np
import pytest
import torch

from hilo_mpc_tpu.ml.gp import kernels as jk
from hilo_mpc_tpu.ml.gp.gp import GaussianProcess as JaxGP
from hilo_mpc_tpu.ml.gp.gp import GPArray as JaxGPArray
from hilo_mpc_tpu_torch import GP, GPArray
from hilo_mpc_tpu_torch.utils.interop import gp_from

torch.set_num_threads(1)
CPU = "cpu"


def jax_array(n_gps=3, n=12, inference="exact", likelihood="gaussian", opts=None,
              seed=0, bounds=None):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2.0, 2.0, (n, 2))
    arr = JaxGPArray(n_gps)
    for g in range(n_gps):
        y = np.sin((g + 1) * X[:, 0]) + 0.2 * X[:, 1] + 0.1 * rng.standard_normal(n)
        if likelihood != "gaussian":
            y = (y > 0).astype(float)
        k = jk.SquaredExponentialKernel(length_scales=[1.0, 1.0])
        if bounds is not None:
            k.length_scales.bounds = bounds
        gp = JaxGP(["a", "b"], "y", kernel=k, noise_variance=0.3 + 0.1 * g,
                   inference=inference, likelihood=likelihood, inference_options=opts)
        gp.set_training_data(X, y)
        arr[g] = gp
    return arr


@pytest.mark.parametrize("solver, iters", [("lbfgs", 20), ("adam", 25)])
def test_fit_model_batched_matches_jax(solver, iters):
    src = jax_array()
    dst = gp_from(src, device=CPU)
    assert isinstance(dst, GPArray) and len(dst) == 3
    src.fit_model_batched(max_iter=iters, solver=solver)
    dst.fit_model_batched(max_iter=iters, solver=solver)
    np.testing.assert_allclose(dst.last_fit_nll, np.asarray(src.last_fit_nll),
                               rtol=1e-6, atol=0)
    for a, b in zip(dst, src):
        for ha, hb in zip(a.hyperparameters, b.hyperparameters):
            np.testing.assert_allclose(ha.value, hb.value, rtol=0, atol=1e-6)
    Xq = np.random.default_rng(3).uniform(-2, 2, (5, 2))
    for a, b in zip(dst.predict(Xq), src.predict(Xq)):
        assert a.shape == (5, 3)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_lbfgs_clips_to_bounds_like_jax():
    """Tight length-scale bounds: the iterate is clipped after each step
    (and the line search's value at the unclipped point is reused, as
    optax.value_and_grad_from_state does)."""
    src = jax_array(bounds=(0.9, 1.1), seed=2)
    dst = gp_from(src, device=CPU)
    src.fit_model_batched(max_iter=15)
    dst.fit_model_batched(max_iter=15)
    np.testing.assert_allclose(dst.last_fit_nll, np.asarray(src.last_fit_nll),
                               rtol=1e-6, atol=0)
    for a in dst:
        assert np.all((a.kernel.length_scales.value >= 0.9 - 1e-12)
                      & (a.kernel.length_scales.value <= 1.1 + 1e-12))


def test_batched_laplace_fit_matches_jax():
    """The batched objective vmaps through the Laplace mode search too."""
    src = jax_array(n_gps=2, n=10, inference="laplace", likelihood="logistic",
                    opts={"laplace_iters": 6}, seed=4)
    dst = gp_from(src, device=CPU)
    src.fit_model_batched(max_iter=6)
    dst.fit_model_batched(max_iter=6)
    np.testing.assert_allclose(dst.last_fit_nll, np.asarray(src.last_fit_nll),
                               rtol=1e-6, atol=0)


def test_array_checks():
    arr = GPArray(2)
    with pytest.raises(TypeError, match="GaussianProcess"):
        arr[0] = object()
    with pytest.raises(RuntimeError, match="assign every"):
        arr.fit_model_batched()
    X = np.zeros((4, 1))
    arr[0] = GP(["a"], "y", device=CPU).set_training_data(X, np.ones(4))
    arr[1] = GP(["a"], "y", inference="fitc", device=CPU).set_training_data(X, np.ones(4))
    with pytest.raises(ValueError, match="same inference"):
        arr.fit_model_batched()
    arr[1] = GP(["a"], "y", device=CPU).set_training_data(np.zeros((5, 1)), np.ones(5))
    with pytest.raises(ValueError, match="training-set"):
        arr.fit_model_batched()
    arr[1] = GP(["a"], "y", device=CPU).set_training_data(X, np.ones(4))
    with pytest.raises(ValueError, match="unknown solver"):
        arr.fit_model_batched(solver="sgd")
    with pytest.raises(ValueError, match="n_gps"):
        GPArray(0)
