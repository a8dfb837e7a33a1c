"""PyTorch port: GaussianProcess (hilo_mpc_tpu_torch/ml/gp/gp.py) with exact
inference against the JAX package (CPU, float64): the posterior state, the
log marginal likelihood and predictions to 1e-10; the fits (SciPy's
L-BFGS-B and Adam) to 1e-6 in the hyperparameters and 1e-8 relative in the
NLL; predict_proba and predict_quantiles; the constructor's checks with
JAX's messages; the batch-first predict_fn; the device default."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hilo_mpc_tpu.ml.gp.gp import GaussianProcess as JaxGP
from hilo_mpc_tpu.ml.gp.inference import ExactInference as JaxExact
from hilo_mpc_tpu.ml.priors import GaussianPrior as JaxGaussianPrior
from hilo_mpc_tpu_torch import GP
from hilo_mpc_tpu_torch.ml.gp.inference import ExactInference
from hilo_mpc_tpu_torch.utils.interop import gp_from

torch.set_num_threads(1)
CPU, F64 = "cpu", torch.float64


def data(n=14, d=2, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2.0, 2.0, (n, d))
    y = np.sin(1.5 * X[:, 0]) + 0.3 * X[:, -1] + 0.1 * rng.standard_normal(n)
    return X, y


def jax_gp(noise=0.3, **kw):
    X, y = data()
    gp = JaxGP(["a", "b"], "y", noise_variance=noise, **kw)
    gp.set_training_data(X, y)
    return gp


def test_posterior_state_and_lml_match_jax():
    """ExactInference.posterior_state and log_marginal_likelihood on the same
    kernel, mean, hyperparameters and data: (L, alpha, resid) and the LML to
    1e-10."""
    src = jax_gp()
    src.kernel.length_scales.value = np.array([0.8, 1.3])
    dst = gp_from(src, device=CPU)
    X, y = data()
    jp, tp = src._params(), dst._params()
    out_j = JaxExact.posterior_state(src.kernel, src.mean, jp, jnp.asarray(X),
                                     jnp.asarray(y), 0.09)
    out_t = ExactInference.posterior_state(dst.kernel, dst.mean, tp, torch.as_tensor(X),
                                           torch.as_tensor(y), 0.09)
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-10)
    lj = JaxExact.log_marginal_likelihood(src.kernel, src.mean, jp, jnp.asarray(X),
                                          jnp.asarray(y), 0.09)
    lt = ExactInference.log_marginal_likelihood(dst.kernel, dst.mean, tp,
                                                torch.as_tensor(X), torch.as_tensor(y),
                                                0.09)
    assert abs(float(lt) - float(lj)) <= 1e-10


@pytest.mark.parametrize("include_noise", [False, True])
def test_predict_matches_jax(include_noise):
    """The set-up GP's host-factorized state (L, alpha), its LML and
    predictions at 9 queries to 1e-10."""
    src = jax_gp()
    src.setup()
    dst = gp_from(src, device=CPU)
    for a, b in zip(dst._state, src._state):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10)
    assert abs(dst.log_marginal_likelihood - src.log_marginal_likelihood) <= 1e-10
    Xq = np.random.default_rng(5).uniform(-2.5, 2.5, (9, 2))
    for a, b in zip(dst.predict(Xq, include_noise=include_noise),
                    src.predict(Xq, include_noise=include_noise)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10)


def test_predict_fn_is_batch_first():
    src = jax_gp()
    src.setup()
    fn = gp_from(src, device=CPU).predict_fn()
    x = torch.as_tensor(np.random.default_rng(1).uniform(-1, 1, (4, 3, 2)))
    mu, var = fn(x)
    assert mu.shape == var.shape == (4, 3)
    mu0, var0 = fn(x[1, 2])
    assert mu0.shape == var0.shape == ()
    assert float(abs(mu0 - mu[1, 2])) <= 1e-14 and float(abs(var0 - var[1, 2])) <= 1e-14
    jmu, jvar = src.predict_fn()(jnp.asarray(x[1, 2].numpy()))
    assert abs(float(mu0) - float(jmu)) <= 1e-10 and abs(float(var0) - float(jvar)) <= 1e-10


@pytest.mark.parametrize("solver", ["scipy", "adam"])
def test_fit_model_matches_jax(solver):
    """fit_model (30 iterations; a Gaussian prior on the signal variance)
    from the same start: hyperparameters to 1e-6, NLL to 1e-8 relative."""
    src = jax_gp()
    src.kernel.signal_variance.prior = JaxGaussianPrior(mean=1.0, variance=0.5)
    dst = gp_from(src, device=CPU)
    src.fit_model(solver=solver, max_iter=30)
    dst.fit_model(solver=solver, max_iter=30)
    for a, b in zip(dst.hyperparameters, src.hyperparameters):
        np.testing.assert_allclose(a.value, b.value, rtol=0, atol=1e-6)
    nll_j, nll_t = -src.log_marginal_likelihood, -dst.log_marginal_likelihood
    assert abs(nll_t - nll_j) <= 1e-8 * abs(nll_j)


def classifier(inference, likelihood):
    X, y = data(n=16, seed=3)
    src = JaxGP(["a", "b"], "y", inference=inference, likelihood=likelihood,
                inference_options={"laplace_iters": 10, "ep_sweeps": 12})
    src.set_training_data(X, (y > 0.1).astype(float))
    src.setup()
    return src, gp_from(src, device=CPU)


@pytest.mark.parametrize("inference, likelihood", [("ep", "probit"),
                                                   ("laplace", "logistic")])
def test_predict_proba_matches_jax(inference, likelihood):
    src, dst = classifier(inference, likelihood)
    Xq = np.random.default_rng(4).uniform(-2, 2, (6, 2))
    np.testing.assert_allclose(dst.predict_proba(Xq), src.predict_proba(Xq), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("likelihood", ["gaussian", "students_t"])
def test_predict_quantiles_match_jax(likelihood):
    X, y = data()
    src = JaxGP(["a", "b"], "y", noise_variance=0.3, likelihood=likelihood,
                inference="exact" if likelihood == "gaussian" else "laplace",
                inference_options=None if likelihood == "gaussian" else {"laplace_iters": 8})
    src.set_training_data(X, y)
    src.setup()
    dst = gp_from(src, device=CPU)
    Xq = np.random.default_rng(6).uniform(-2, 2, (5, 2))
    for a, b in zip(dst.predict_quantiles(Xq, (0.1, 0.5, 0.95)),
                    src.predict_quantiles(Xq, (0.1, 0.5, 0.95))):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10)
    with pytest.raises(RuntimeError, match="classification likelihood"):
        dst.predict_proba(Xq)


CONSTRUCTOR_ERRORS = {
    "two_labels": dict(labels=["y", "z"]),
    "inference": dict(inference="magic"),
    "likelihood": dict(likelihood="cauchy"),
    "exact_non_gaussian": dict(likelihood="logistic"),
    "exact_laplacian": dict(likelihood="laplacian"),
    "laplace_laplacian": dict(inference="laplace", likelihood="laplacian"),
    "ep_logistic": dict(inference="ep", likelihood="logistic"),
    "vb_probit": dict(inference="vb", likelihood="probit"),
    "fitc_probit": dict(inference="fitc", likelihood="probit"),
    "unknown_option": dict(inference_options={"sweeps": 3}),
    "laplace_iters": dict(inference="laplace", likelihood="logistic",
                          inference_options={"laplace_iters": 0}),
    "ep_damping": dict(inference="ep", likelihood="probit",
                       inference_options={"ep_damping": 1.5}),
    "inducing_shape": dict(inference="fitc", inference_options={
        "inducing_points": np.zeros((3, 3))}),
    "optimize_inducing_exact": dict(inference_options={"optimize_inducing": True}),
    "batch_size_exact": dict(inference_options={"batch_size": 4}),
    "batch_size_zero": dict(inference="svgp", inference_options={"batch_size": 0}),
}


@pytest.mark.parametrize("name", sorted(CONSTRUCTOR_ERRORS))
def test_constructor_errors_match_jax(name):
    kw = dict(CONSTRUCTOR_ERRORS[name])
    labels = kw.pop("labels", "y")
    msgs = []
    for cls, extra in ((JaxGP, {}), (GP, {"device": CPU})):
        with pytest.raises(ValueError) as info:
            cls(["a", "b"], labels, **kw, **extra)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


def test_custom_likelihood_checks():
    from hilo_mpc_tpu_torch.ml.gp.likelihood import Likelihood

    class NoPdf(Likelihood):
        name = "nopdf"

    class NoName(Likelihood):
        def log_pdf(self, f, y, sn2):
            return -(y - f) ** 2

    with pytest.raises(ValueError, match="does not override"):
        GP(["a"], "y", likelihood=NoPdf(), device=CPU)
    with pytest.raises(ValueError, match="distinct"):
        GP(["a"], "y", likelihood=NoName(), device=CPU)


def test_training_data_checks_and_labels():
    gp = GP(["a", "b"], "y", likelihood="probit", inference="ep", device=CPU)
    X, y = data()
    with pytest.raises(ValueError, match="binary labels"):
        gp.set_training_data(X, y)
    gp.set_training_data(X.T, (y > 0).astype(float))   # (d, n) layout, {0, 1}
    assert gp.X_train.shape == (14, 2) and set(np.unique(gp.y_train)) == {-1.0, 1.0}
    with pytest.raises(ValueError, match="features"):
        GP(["a", "b"], "y", device=CPU).set_training_data(np.zeros((5, 3)), np.zeros(5))
    with pytest.raises(RuntimeError, match="set_training_data"):
        GP(["a"], "y", device=CPU).setup()


def test_entry_points_default_to_the_card():
    """No device given: the GP computes on "cuda", and a missing card is an
    error (nothing falls back to the CPU)."""
    gp = GP(["a", "b"], "y")
    gp.set_training_data(*data())
    if torch.cuda.is_available():
        assert gp.setup().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            gp.setup()


def test_full_precision_restores_the_callers_flags():
    src = jax_gp()
    src.setup()
    dst = gp_from(src, device=CPU)
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        dst.predict(np.zeros((2, 2)))
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
