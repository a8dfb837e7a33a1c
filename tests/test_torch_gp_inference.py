"""PyTorch port: the approximate GP inferences (hilo_mpc_tpu_torch/ml/gp/
inference.py) against the JAX package (CPU, float64), each carried across
with utils/interop.py:gp_from from the same hyperparameters and data: the
predictive state and the objective (the LML or its bound) to 1e-8, the
predictions to 1e-8, short fits to 1e-6. This file: Laplace, KL, VB and EP
on the Laplacian; tests/test_torch_gp_sparse.py: EP on the probit, FITC,
VFE and SVGP (its minibatch fit on JAX's own index sequence)."""
import numpy as np
import pytest
import torch

from hilo_mpc_tpu.ml.gp.gp import GaussianProcess as JaxGP
from hilo_mpc_tpu_torch.ml.gp.inference import _log_erfc, _log_ncdf
from hilo_mpc_tpu_torch.utils.interop import gp_from

torch.set_num_threads(1)
CPU = "cpu"

CASES = {
    "laplace_logistic": ("laplace", "logistic", {"laplace_iters": 10}),
    "laplace_probit": ("laplace", "probit", {"laplace_iters": 10}),
    "laplace_students_t": ("laplace", "students_t", {"laplace_iters": 12}),
    "laplace_gaussian": ("laplace", "gaussian", {"laplace_iters": 3}),
    "ep_probit": ("ep", "probit", {"ep_sweeps": 12}),
    "ep_laplacian": ("ep", "laplacian", {"ep_sweeps": 10, "ep_damping": 0.5}),
    "kl_gaussian": ("kl", "gaussian", {"kl_sweeps": 12}),
    "kl_logistic": ("kl", "logistic", {"kl_sweeps": 12}),
    "kl_laplacian": ("kl", "laplacian", {"kl_sweeps": 12, "kl_damping": 0.7}),
    "vb_logistic": ("vb", "logistic", {"vb_iters": 15}),
    "fitc": ("fitc", "gaussian", {"n_inducing": 6}),
    "vfe": ("vfe", "gaussian", {"n_inducing": 6}),
    "vfe_given_points": ("vfe", "gaussian",
                         {"inducing_points": np.linspace([-2, -2], [2, 2], 5)}),
    "fitc_optimize_inducing": ("fitc", "gaussian", {"n_inducing": 5,
                                                    "optimize_inducing": True}),
    "svgp_gaussian": ("svgp", "gaussian", {"n_inducing": 6}),
    "svgp_probit": ("svgp", "probit", {"n_inducing": 5, "n_quadrature": 12}),
}


def carried(name, seed=0, n=14):
    """A JAX GP of case ``name`` (or an (inference, likelihood, options)
    tuple), set up, and its twin."""
    inference, likelihood, opts = CASES[name] if isinstance(name, str) else name
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2.0, 2.0, (n, 2))
    y = np.sin(1.5 * X[:, 0]) + 0.3 * X[:, 1] + 0.1 * rng.standard_normal(n)
    if likelihood in ("logistic", "probit"):
        y = (y > 0.1).astype(float)
    if likelihood == "laplacian":
        y[3] += 2.0   # an outlier
    src = JaxGP(["a", "b"], "y", noise_variance=0.4, inference=inference,
                likelihood=likelihood, inference_options=opts)
    src.set_training_data(X, y)
    src.kernel.length_scales.value = np.array([0.9, 1.2])
    if src._svgp_mv is not None:
        # a q(v) away from the prior, so the KL and the predictive use it
        m = src._svgp_mv.size
        src._svgp_mv.value = 0.3 * rng.standard_normal(m)
        src._svgp_lraw.value = 0.2 * rng.standard_normal((m, m))
    src.setup()
    return src, gp_from(src, device=CPU)


# the dense approximations, and EP on the Laplacian (its JAX side compiles
# nested derivatives for ~12 s, so it sits here, not in the sparse file)
DENSE = sorted(k for k in CASES if k.split("_")[0] in ("laplace", "kl", "vb")
               or k == "ep_laplacian")


def check_state(name):
    src, dst = carried(name)
    assert dst.inference == src.inference
    tag_j = src._state[0] if isinstance(src._state[0], str) else "exact"
    assert dst._state[0] == tag_j
    for a, b in zip(dst._state[1:], src._state[1:]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-8)
    assert abs(dst.log_marginal_likelihood - src.log_marginal_likelihood) <= 1e-8
    Xq = np.random.default_rng(9).uniform(-2.5, 2.5, (7, 2))
    for noise in (False, True):
        for a, b in zip(dst.predict(Xq, include_noise=noise),
                        src.predict(Xq, include_noise=noise)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-8)


def check_short_fit(name):
    """Eight L-BFGS-B iterations through the method's objective
    (differentiated through the mode search, the EP sweeps, the sparse
    algebra, or into the inducing points): hyperparameters to 1e-6."""
    src, dst = carried(name, seed=1, n=12)
    src.fit_model(max_iter=8)
    dst.fit_model(max_iter=8)
    for a, b in zip(dst.hyperparameters, src.hyperparameters):
        np.testing.assert_allclose(a.value, b.value, rtol=0, atol=1e-6)
    assert abs(dst.log_marginal_likelihood - src.log_marginal_likelihood) <= 1e-6 * abs(
        src.log_marginal_likelihood)


@pytest.mark.parametrize("name", DENSE)
def test_state_objective_and_predictions_match_jax(name):
    check_state(name)


@pytest.mark.parametrize("name", ["laplace_logistic"])
def test_short_fit_matches_jax(name):
    check_short_fit(name)


def test_log_erfc_and_log_ncdf_match_jax():
    from hilo_mpc_tpu.ml.gp.inference import _log_erfc as j_erfc
    from hilo_mpc_tpu.ml.gp.inference import _log_ncdf as j_ncdf
    z = np.concatenate([np.linspace(-40.0, 40.0, 81), [4.999, 5.0, 5.001]])
    np.testing.assert_allclose(_log_erfc(torch.as_tensor(z)).numpy(),
                               np.asarray(j_erfc(z)), rtol=1e-14, atol=1e-300)
    np.testing.assert_allclose(_log_ncdf(torch.as_tensor(z)).numpy(),
                               np.asarray(j_ncdf(z)), rtol=1e-14, atol=1e-300)
