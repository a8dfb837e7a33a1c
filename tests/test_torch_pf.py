"""PyTorch port: the particle filter against the JAX package (CPU, float64).

The JAX filter draws from ``jax.random`` keys, the port from a
``torch.Generator``; the two give other numbers from one seed. So the port's
draw-explicit step (``ParticleFilter.step_draws``) is fed the draws JAX's
step makes from its key (the split into k1, k2, k3 of
hilo_mpc_tpu/estimation/pf.py), and particles and estimates agree within
1e-10 step by step. ``lhsnorm`` is numpy and SciPy in both packages; the
generator path is held by the tracking test of tests/test_estimators.py:104.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_configs import rk4_np
from hilo_mpc_tpu import PF as JaxPF
from hilo_mpc_tpu.estimation.pf import lhsnorm as jax_lhsnorm
from hilo_mpc_tpu_torch import PF
from hilo_mpc_tpu_torch.estimation.pf import lhsnorm
from hilo_mpc_tpu_torch.utils.interop import estimator_from

from test_torch_kf import trajectory
from test_torch_mhe import jax_pendulum, pendulum_np, port_pendulum

torch.set_num_threads(1)
F64 = torch.float64
TOL = dict(rtol=0, atol=1e-10)


def jax_draws(key, M, nx):
    """The draws JAX's step makes from ``key``: standard normal process noise,
    the offset's uniform draw, standard normal roughening noise."""
    k1, k2, k3 = jax.random.split(key, 3)
    return (np.array(jax.random.normal(k1, (M, nx), jnp.float64)),
            float(jax.random.uniform(k2, (), jnp.float64)),
            np.array(jax.random.normal(k3, (M, nx), jnp.float64)))


@pytest.mark.parametrize("rough", [False, True])
def test_step_with_jax_draws_matches_jax(rough):
    jf = JaxPF(jax_pendulum(), n_particles=300, roughening=rough, seed=2)
    jf.Q, jf.R = 1e-4, 4e-4
    jf.setup(dt=0.05)
    jf.set_initial_guess([0.4, 0.1], P0=np.eye(2) * 0.1)
    tf = estimator_from(jf, device="cpu", dtype=F64, model=port_pendulum())
    np.testing.assert_array_equal(tf.particles, jf.particles)
    U, Y = trajectory(pendulum_np, [0.5, 0.0], 12, meas_std=0.02)
    jstep, key = jf.step_fn(), jax.random.PRNGKey(7)
    parts_j = jnp.asarray(jf.particles)
    parts_t = torch.as_tensor(tf.particles)
    p = np.zeros(0)
    for k in range(U.shape[0]):
        t = 0.05 * k
        noise, offset, rgh = jax_draws(key, 300, 2)
        key, parts_j, xj, yj = jstep(key, parts_j, jnp.asarray(U[k]), jnp.asarray(p),
                                     jnp.asarray(Y[k]), t)
        parts_t, xt, yt = tf.step_draws(
            parts_t, torch.as_tensor(U[k]), torch.as_tensor(p), torch.as_tensor(Y[k]),
            t, torch.as_tensor(noise), torch.as_tensor(offset),
            torch.as_tensor(rgh) if rough else None)
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), **TOL)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
        np.testing.assert_allclose(parts_t.numpy(), np.asarray(parts_j), **TOL)


def test_lhsnorm_is_the_same():
    a = lhsnorm([1.0, -2.0], np.diag([0.04, 0.09]), 500, seed=3)
    np.testing.assert_array_equal(a, jax_lhsnorm([1.0, -2.0], np.diag([0.04, 0.09]),
                                                 500, seed=3))
    np.testing.assert_allclose(a.mean(axis=0), [1.0, -2.0], atol=0.02)


def test_pendulum_tracking():
    """tests/test_estimators.py:104 through the port, draws from its
    generator."""
    U, Y = trajectory(pendulum_np, [0.5, 0.0], 60, meas_std=0.02)
    x_true = np.asarray([0.5, 0.0])
    for k in range(60):
        x_true = rk4_np(pendulum_np, x_true, U[k], 0.05)
    pf = PF(port_pendulum(), n_particles=400, seed=1)
    pf.Q, pf.R = 1e-4, 4e-4
    pf.setup(dt=0.05, device="cpu", dtype=F64)
    pf.set_initial_guess([0.4, 0.1], P0=np.eye(2) * 0.1)
    x_hat = pf.estimate(Y, u=U)
    assert abs(x_hat[0] - x_true[0]) < 0.05
    assert pf.solution["P"].shape == (4, 60)


def test_generator_is_seeded():
    """Two filters with one seed draw the same numbers; the step is the
    draw-explicit step fed from the generator."""
    runs = []
    for _ in range(2):
        pf = PF(port_pendulum(), n_particles=50, roughening=True, seed=4)
        pf.setup(dt=0.05, device="cpu", dtype=F64)
        pf.set_initial_guess([0.4, 0.1])
        runs.append(pf.estimate(np.array([[0.41]]), u=np.zeros((1, 1))))
    np.testing.assert_array_equal(runs[0], runs[1])


@pytest.mark.cuda
def test_step_draws_on_card_match_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    M = 4096
    out = []
    for device in ("cpu", "cuda"):
        pf = PF(port_pendulum(), n_particles=M, roughening=True)
        pf.Q, pf.R = 1e-4, 4e-4
        pf.setup(dt=0.05, device=device, dtype=F64)
        kw = dict(dtype=F64, device=device)
        parts = torch.as_tensor(lhsnorm([0.4, 0.1], 0.1 * np.eye(2), M), **kw)
        draws = np.random.default_rng(6)
        for k in range(5):
            noise = torch.as_tensor(draws.standard_normal((M, 2)), **kw)
            off = torch.as_tensor(draws.random(), **kw)
            rgh = torch.as_tensor(draws.standard_normal((M, 2)), **kw)
            parts, x, _ = pf.step_draws(parts, torch.zeros(1, **kw),
                                        torch.zeros(0, **kw),
                                        torch.as_tensor([0.41 + 0.01 * k], **kw),
                                        0.05 * k, noise, off, rgh)
        out.append((parts.cpu().numpy(), x.cpu().numpy()))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=0, atol=1e-9)
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=0, atol=1e-9)
