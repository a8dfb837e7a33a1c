"""PyTorch port: expectation propagation on the probit, the sparse FITC and VFE
approximations and SVGP (hilo_mpc_tpu_torch/ml/gp/inference.py) against the
JAX package (CPU, float64), carried across with utils/interop.py:gp_from:
the predictive state and the objective to 1e-8, the predictions to 1e-8,
short fits to 1e-6 (tests/test_torch_gp_inference.py's checks), and the
SVGP minibatch fit on JAX's own index sequence."""
import jax
import numpy as np
import pytest
import torch

from test_torch_gp_inference import CASES, carried, check_short_fit, check_state

torch.set_num_threads(1)
SPARSE = sorted(k for k in CASES if k.split("_")[0] in ("ep", "fitc", "vfe", "svgp")
                and k != "ep_laplacian")


@pytest.mark.parametrize("name", SPARSE)
def test_state_objective_and_predictions_match_jax(name):
    check_state(name)


@pytest.mark.parametrize("name", ["ep_probit", "vfe", "fitc_optimize_inducing",
                                  "kl_logistic"])
def test_short_fit_matches_jax(name):
    check_short_fit(name)


def test_svgp_minibatch_step_on_jax_indices():
    """The SVGP minibatch Adam fit (10 steps of 5 of 14 points): the port is
    given JAX's index sequence (jax.random.choice from fit_seed), so both
    take the same steps; all hyperparameters to 1e-10. Its own generator's
    draws run too (other bits by design)."""
    src, dst = carried(("svgp", "gaussian", {"n_inducing": 6, "batch_size": 5,
                                             "fit_seed": 4}))
    keys = jax.random.split(jax.random.PRNGKey(4), 10)
    idx = np.stack([np.asarray(jax.random.choice(k, 14, (5,), replace=False))
                    for k in keys])
    src.fit_model(max_iter=10, learning_rate=0.05)
    dst.fit_model(max_iter=10, learning_rate=0.05, _indices=idx)
    for a, b in zip(dst.hyperparameters, src.hyperparameters):
        np.testing.assert_allclose(a.value, b.value, rtol=0, atol=1e-10)
    before = [np.array(h.value) for h in dst.hyperparameters]
    dst.fit_model(max_iter=3)
    assert any(not np.array_equal(a, h.value) for a, h in zip(before, dst.hyperparameters))


