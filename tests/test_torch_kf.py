"""PyTorch port: the Kalman filters (KF, EKF, UKF) against the JAX package
(CPU, float64): x and P after every step, on the pendulum and linear
configurations of tests/test_estimators.py:67-100, and the predict/update
split (tests/test_estimators.py:355-410). Each JAX filter is rebuilt in the
port by ``utils/interop.py:estimator_from``; measurements come from numpy RK4
plants.

Tolerances: 1e-10 for KF and EKF. The UKF's default alpha = 1e-3 gives its
weighted means weights of magnitude 1/alpha² ≈ 1e6 that cancel to one, so a
different summation order (torch's against XLA's) moves the predicted mean
by ~1e6 × 2.2e-16 per step: measured up to 5.7e-10 on the pendulum, fed
JAX's state each step. The UKF is held to 1e-8."""
import numpy as np
import pytest
import torch

from golden_configs import rk4_np
from hilo_mpc_tpu import EKF as JaxEKF
from hilo_mpc_tpu import KF as JaxKF
from hilo_mpc_tpu import UKF as JaxUKF
from hilo_mpc_tpu import Model as JaxModel
from hilo_mpc_tpu_torch import EKF, KF, UKF, Model
from hilo_mpc_tpu_torch.utils.interop import estimator_from

from test_torch_mhe import jax_pendulum, pendulum_np, port_pendulum

torch.set_num_threads(1)
CPU = "cpu"
F64 = torch.float64
TOL = dict(rtol=0, atol=1e-10)
UKF_TOL = dict(rtol=0, atol=1e-8)
LIN_A = [[0.0, 1.0], [-2.0, -0.8]]


def jax_linear():
    m = JaxModel()
    m.set_state_space(A=LIN_A, B=[[0.0], [1.0]], C=[[1.0, 0.0]])
    return m


def trajectory(f, x0, steps, dt=0.05, meas_std=0.01, seed=0):
    """(U, Y) of a numpy RK4 plant, y = x_1 + noise, as
    tests/test_estimators.py:simulate_noisy makes them."""
    rng = np.random.default_rng(seed)
    U = 0.2 * np.sin(np.linspace(0, 4, steps))[:, None]
    x, Y = np.asarray(x0, float), []
    for k in range(steps):
        x = rk4_np(f, x, U[k], dt)
        Y.append(x[:1] + meas_std * rng.standard_normal(1))
    return U, np.array(Y)


def linear_np(x, u):
    return np.asarray(LIN_A) @ x + np.array([0.0, 1.0]) * u[0]


def pair(jax_cls, jax_model, port_model=None, Q=1e-5, R=1e-4, x0=(0.3, 0.2),
         P0=0.3):
    jf = jax_cls(jax_model)
    jf.Q, jf.R = Q, R
    jf.setup(dt=0.05)
    jf.set_initial_guess(list(x0), P0=np.eye(2) * P0)
    return jf, estimator_from(jf, device=CPU, dtype=F64, model=port_model)


def tol_of(f):
    return UKF_TOL if isinstance(f, UKF) else TOL


def assert_same_run(jf, tf):
    for kind in ("x", "P", "y"):
        np.testing.assert_allclose(tf.solution[kind], jf.solution[kind],
                                   err_msg=kind, **tol_of(tf))


@pytest.mark.parametrize("cls", ["EKF", "UKF"])
def test_pendulum_filters_match_jax(cls):
    jax_cls = {"EKF": JaxEKF, "UKF": JaxUKF}[cls]
    jf, tf = pair(jax_cls, jax_pendulum(), port_pendulum())
    assert type(tf) is {"EKF": EKF, "UKF": UKF}[cls]
    U, Y = trajectory(pendulum_np, [0.5, 0.0], 40)
    xj, xt = jf.estimate(Y, u=U), tf.estimate(Y, u=U)
    np.testing.assert_allclose(xt, np.asarray(xj), **tol_of(tf))
    assert_same_run(jf, tf)


@pytest.mark.parametrize("cls", ["KF", "EKF", "UKF"])
def test_linear_filters_match_jax(cls):
    """The linear model of tests/test_estimators.py:9-13 (a state-space
    model, carried across by its matrices)."""
    jax_cls = {"KF": JaxKF, "EKF": JaxEKF, "UKF": JaxUKF}[cls]
    jf, tf = pair(jax_cls, jax_linear(), x0=(0.5, 0.5), P0=1.0)
    U, Y = trajectory(linear_np, [1.0, 0.0], 30)
    xj, xt = jf.estimate(Y, u=U), tf.estimate(Y, u=U)
    np.testing.assert_allclose(xt, np.asarray(xj), **tol_of(tf))
    assert_same_run(jf, tf)


def test_kf_requires_a_linear_model():
    with pytest.raises(ValueError, match="linear"):
        KF(port_pendulum())


@pytest.mark.parametrize("cls", ["EKF", "UKF"])
def test_predict_update_split_matches_jax(cls):
    """predict and update alone (pure) against JAX's, and predict + update
    equal to one estimate step."""
    jax_cls = {"EKF": JaxEKF, "UKF": JaxUKF}[cls]
    jm, tm = jax_pendulum(), port_pendulum()
    jf, tf = pair(jax_cls, jm, tm, Q=0.01, R=0.1, x0=(0.2, 0.0), P0=1.0)
    u, y = np.array([0.3]), np.array([0.25])
    P_before = np.array(tf._P)
    xj, Pj = jf.predict(u=u)
    xt, Pt = tf.predict(u=u)
    np.testing.assert_allclose(xt, np.asarray(xj), **tol_of(tf))
    np.testing.assert_allclose(Pt, np.asarray(Pj), **tol_of(tf))
    np.testing.assert_array_equal(tf._P, P_before)
    uj = jf.update(xj, Pj, y, u=u, t=0.05)
    ut = tf.update(xt, Pt, y, u=u, t=0.05)
    for a, b in zip(ut, uj):
        np.testing.assert_allclose(a, np.asarray(b), **tol_of(tf))
    np.testing.assert_allclose(tf.estimate(y=y, u=u), ut[0], atol=1e-12)
    assert ut[1][0, 0] < Pt[0, 0]


def test_ukf_weights_sum_to_one():
    for alpha, kappa in ((1e-3, 0.0), (0.5, 2.0)):
        _, wm, _ = UKF(port_pendulum(), alpha=alpha, kappa=kappa)._weights(2, F64)
        np.testing.assert_allclose(float(wm.sum()), 1.0, atol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("cls", [EKF, UKF])
def test_filters_on_card_match_cpu(cls):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    U, Y = trajectory(pendulum_np, [0.5, 0.0], 20)
    runs = []
    for device in ("cpu", "cuda"):
        f = cls(port_pendulum())
        f.Q, f.R = 1e-5, 1e-4
        f.setup(dt=0.05, device=device, dtype=F64)
        f.set_initial_guess([0.3, 0.2], P0=np.eye(2) * 0.3)
        f.estimate(Y, u=U)
        runs.append(f)
    # the UKF's 1e6-weighted means (module docstring) take 1e-8
    atol = 1e-8 if cls is UKF else 1e-9
    for kind in ("x", "P"):
        np.testing.assert_allclose(runs[1].solution[kind], runs[0].solution[kind],
                                   rtol=0, atol=atol)
