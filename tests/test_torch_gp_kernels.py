"""PyTorch port: the GP kernels, Warp, the kernel algebra and the means
(hilo_mpc_tpu_torch/ml/gp/kernels.py, means.py) against the JAX package on
the same inputs (CPU, float64): each kernel and composite carried across
with utils/interop.py:gp_from (random hyperparameter values from a seed),
its gram, cross gram and diagonal to 1e-12; each mean to 1e-12."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hilo_mpc_tpu.ml.gp import kernels as jk
from hilo_mpc_tpu.ml.gp import means as jm
from hilo_mpc_tpu.ml.gp.gp import GaussianProcess as JaxGP
from hilo_mpc_tpu_torch.ml.gp import kernels as tk
from hilo_mpc_tpu_torch.ml.gp import means as tm
from hilo_mpc_tpu_torch.utils.interop import gp_from

torch.set_num_threads(1)


def _randomize(obj, seed):
    """Random values for every hyperparameter that is not fixed (positive
    ones in [0.5, 1.5])."""
    rng = np.random.default_rng(seed)
    for hp in obj.hyperparameters:
        if hp.fixed:
            continue
        shape = np.shape(hp.value)
        hp.value = (rng.uniform(0.5, 1.5, shape) if hp.positive
                    else rng.uniform(-0.8, 0.8, shape))
    return obj


def _carry(kernel=None, mean=None, d=2):
    """A JAX GP holding ``kernel`` / ``mean``, and the port's twin of it."""
    src = JaxGP([f"f{i}" for i in range(d)], "y", kernel=kernel, mean=mean)
    return src, gp_from(src, device="cpu")


KERNELS = {
    "constant": lambda: jk.ConstantKernel(bias=1.3),
    "se_ard": lambda: jk.SquaredExponentialKernel(length_scales=[0.7, 1.4]),
    "se_active_dims": lambda: jk.SquaredExponentialKernel(active_dims=[1]),
    "matern_7/2": lambda: jk.MaternKernel(nu=3.5, length_scales=[0.8, 1.1]),
    "matern32": lambda: jk.Matern32Kernel(length_scales=[0.8, 1.1]),
    "matern52": lambda: jk.Matern52Kernel(),
    "exponential": lambda: jk.ExponentialKernel(length_scales=[0.6, 0.9]),
    "gamma_exponential": lambda: jk.GammaExponentialKernel(gamma=1.5),
    "rational_quadratic": lambda: jk.RationalQuadraticKernel(alpha=0.7),
    "piecewise_q0": lambda: jk.PiecewisePolynomialKernel(q=0, length_scales=3.0),
    "piecewise_q1": lambda: jk.PiecewisePolynomialKernel(q=1, length_scales=3.0),
    "piecewise_q2": lambda: jk.PiecewisePolynomialKernel(q=2, length_scales=3.0),
    "piecewise_q3": lambda: jk.PiecewisePolynomialKernel(degree=3, length_scales=3.0),
    "dot_product": lambda: jk.DotProductKernel(offset=0.3),
    "polynomial": lambda: jk.PolynomialKernel(3, length_scales=[1.1, 0.9]),
    "linear": lambda: jk.LinearKernel(),
    "neural_network": lambda: jk.NeuralNetworkKernel(weight_variance=0.8),
    "periodic": lambda: jk.PeriodicKernel(period=1.3),
    "sum": lambda: jk.SquaredExponentialKernel() + jk.PeriodicKernel(),
    "product": lambda: jk.Matern32Kernel() * jk.LinearKernel(),
    "power": lambda: jk.RationalQuadraticKernel() ** 2,
    "scale": lambda: 0.5 * jk.SquaredExponentialKernel(),
    "plus_constant": lambda: jk.Matern52Kernel() + 1.5,
    "constant_plus": lambda: 2.0 + jk.ExponentialKernel(),
    "same_family_twice": lambda: (jk.SquaredExponentialKernel()
                                  + jk.SquaredExponentialKernel(length_scales=[2.0, 3.0])),
    "nested": lambda: (jk.SquaredExponentialKernel() * jk.PeriodicKernel() + 0.3
                       * jk.LinearKernel()) ** 1.5,
    "warp_log1p": lambda: jk.Warp(jk.SquaredExponentialKernel(), jnp.log1p),
    "warp_tanh_in_sum": lambda: jk.Warp(jk.Matern32Kernel(), jnp.tanh) + jk.LinearKernel(),
}


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_kernel_matches_jax(name):
    src, dst = _carry(_randomize(KERNELS[name](), seed=len(name)))
    k_j, k_t = src.kernel, dst.kernel
    assert [h.name for h in k_t.hyperparameters] == [h.name for h in k_j.hyperparameters]
    rng = np.random.default_rng(0)
    X, Xb = rng.uniform(0.0, 1.5, (7, 2)), rng.uniform(0.0, 1.5, (5, 2))
    for a, b in ((k_t(X), k_j(X)), (k_t(X, Xb), k_j(X, Xb)), (k_t.diag(X), k_j.diag(X))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-12)
    # the pointwise eval is batch-first: a (4, 3, d) batch of pairs at once
    params = k_t.param_values()
    x = torch.as_tensor(rng.uniform(0.0, 1.5, (4, 3, 2)))
    y = torch.as_tensor(rng.uniform(0.0, 1.5, (4, 3, 2)))
    jp = k_j.param_values()
    ref = np.array([[float(k_j.eval(jp, jnp.asarray(x[i, j].numpy()),
                                    jnp.asarray(y[i, j].numpy())))
                     for j in range(3)] for i in range(4)])
    np.testing.assert_allclose(k_t.eval(params, x, y).numpy(), ref, rtol=0, atol=1e-12)


ERRORS = {
    "gamma_range": (lambda m: m.GammaExponentialKernel(gamma=2.5), ValueError),
    "matern_nu": (lambda m: m.MaternKernel(nu=1.0), ValueError),
    "piecewise_q": (lambda m: m.PiecewisePolynomialKernel(q=4), ValueError),
    "polynomial_degree": (lambda m: m.PolynomialKernel(0), ValueError),
    "negative_constant": (lambda m: m.ConstantKernel() + (-1.0), ValueError),
    "warp_not_callable": (lambda m: m.Warp(m.ConstantKernel(), 3.0), TypeError),
    "ard_count": (lambda m: m.SquaredExponentialKernel(length_scales=[1.0, 1.0, 1.0])(
        np.zeros((3, 2))), ValueError),
    "active_dims": (lambda m: m.SquaredExponentialKernel(active_dims=[2])(
        np.zeros((3, 2))), ValueError),
    "cross_dims": (lambda m: m.SquaredExponentialKernel()(np.zeros((3, 2)),
                                                          np.zeros((2, 3))), ValueError),
}


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_kernel_errors_match_jax(name):
    """The JAX package's construction and input checks, with its messages."""
    make, err = ERRORS[name]
    msgs = []
    for mod in (jk, tk):
        with pytest.raises(err) as info:
            make(mod)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


def test_a_warp_that_cannot_be_carried_needs_warps():
    src = JaxGP(["a", "b"], "y", kernel=jk.Warp(jk.SquaredExponentialKernel(),
                                                lambda x: x ** 3))
    with pytest.raises(ValueError, match="warps="):
        gp_from(src, device="cpu")
    dst = gp_from(src, device="cpu", warps=[lambda x: x ** 3])
    X = np.random.default_rng(1).uniform(-1, 1, (4, 2))
    np.testing.assert_allclose(dst.kernel(X).numpy(), np.asarray(src.kernel(X)),
                               rtol=0, atol=1e-12)


MEANS = {
    "zero": lambda: jm.ZeroMean(),
    "one": lambda: jm.OneMean(),
    "constant": lambda: jm.ConstantMean(0.4),
    "linear": lambda: jm.LinearMean([0.3, -0.7]),
    "linear_active": lambda: jm.LinearMean(0.5, active_dims=[0]),
    "polynomial": lambda: jm.PolynomialMean(degree=3, coefficient=[0.2, 0.5], offset=0.1),
    "sum": lambda: jm.LinearMean([0.3, 0.1]) + jm.ConstantMean(0.2),
    "product": lambda: jm.LinearMean([0.3, 0.1]) * jm.PolynomialMean(2),
    "scale": lambda: 2.5 * jm.LinearMean([1.0, -1.0]),
    "power": lambda: jm.ConstantMean(1.2) ** 3,
    "plus_number": lambda: jm.LinearMean([0.1, 0.2]) + 1.0,
}


@pytest.mark.parametrize("name", sorted(MEANS))
def test_mean_matches_jax(name):
    src, dst = _carry(mean=_randomize(MEANS[name](), seed=len(name)))
    X = np.random.default_rng(2).uniform(-1.5, 1.5, (9, 2))
    np.testing.assert_allclose(dst.mean(X).numpy(), np.asarray(src.mean(X)), rtol=0,
                               atol=1e-12)


def test_mean_coefficient_count_is_checked():
    for mod in (jm, tm):
        with pytest.raises(ValueError, match="ARD coefficients"):
            mod.LinearMean([1.0, 2.0, 3.0])(np.zeros((2, 2)))


LIKELIHOODS = ["Gaussian", "Logistic", "Probit", "StudentsT", "Laplacian"]


@pytest.mark.parametrize("name", LIKELIHOODS)
def test_likelihood_matches_jax(name):
    """Each likelihood's elementwise log p(y | f) and its predictive noise
    (the port's ml/gp/likelihood.py against JAX's) to 1e-12, with sn2 a
    number and a tensor."""
    from hilo_mpc_tpu.ml.gp import likelihood as jl
    from hilo_mpc_tpu_torch.ml.gp import likelihood as tl
    lj, lt = getattr(jl, name)(), getattr(tl, name)()
    rng = np.random.default_rng(3)
    f = rng.uniform(-3, 3, 11)
    y = np.sign(rng.uniform(-1, 1, 11)) if name in ("Logistic", "Probit") else (
        rng.uniform(-3, 3, 11))
    ref = np.asarray(lj.log_pdf(jnp.asarray(f), jnp.asarray(y), 0.3))
    for sn2 in (0.3, torch.tensor(0.3, dtype=torch.float64)):
        out = lt.log_pdf(torch.as_tensor(f), torch.as_tensor(y), sn2)
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-12)
    assert float(lt.noise_pred_variance(0.3)) == float(lj.noise_pred_variance(0.3))
    assert (lt.name, lt.uses_noise, lt.log_concave) == (lj.name, lj.uses_noise,
                                                        lj.log_concave)
