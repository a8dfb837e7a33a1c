"""PyTorch port: the embedded EKF and MHE C exports
(embedded/ekf_codegen.py, embedded/mhe_codegen.py) on the CPU.

The twins of tests/test_embedded_ekf.py and tests/test_embedded_mhe.py on
the port's estimators (float64 on the CPU): the compiled EKF against the
port's filter step over a filtering run (x and P to 2e-5), its covariance
staying SPD, the compiled MHE against ``MHE.estimate`` over a moving
window run (5e-4), and the gates. Emission parity: the same estimator
built in both packages gives byte-identical C.
"""
import numpy as np
import pytest
import torch

from hilo_mpc_tpu_torch import Model
from hilo_mpc_tpu_torch.embedded import compile_shared, find_c_compiler
from hilo_mpc_tpu_torch.embedded.ekf_codegen import generate_ekf_c, generate_meas_c, load_ekf
from hilo_mpc_tpu_torch.embedded.mhe_codegen import generate_mhe_c, load_mhe
from hilo_mpc_tpu_torch.estimation import ExtendedKalmanFilter, MovingHorizonEstimator

KW = dict(device="cpu", dtype=torch.float64)
F64 = torch.float64

CSTR_DSL = """
dx_1/dt = -a_1*x_1(t) + b_1*r
dx_2/dt = -a_2*x_2(t) + b_2*r + g*u(k)
y(k) = x_2(t)
r = (1 - x_1(t))*exp(-E/(1 + x_2(t)))
"""


@pytest.fixture
def cc():
    try:
        find_c_compiler()
    except RuntimeError:
        pytest.skip("no C compiler")


def _model(cls=Model):
    m = cls(name="cstr")
    m.set_equations(CSTR_DSL)
    return m


def _ekf(cls=ExtendedKalmanFilter, model_cls=Model, setup_kw=KW):
    ekf = cls(_model(model_cls))
    ekf.Q = np.diag([1e-4, 2e-4])
    ekf.R = np.array([[1e-4]])
    ekf.set_initial_parameter_values([1.0] * 6)
    ekf.setup(dt=0.1, **setup_kw)
    return ekf


def _mhe(N=6, cls=MovingHorizonEstimator, model_cls=Model, setup_kw=KW):
    mhe = cls(_model(model_cls))
    mhe.horizon = N
    mhe.Q = 1e-3 * np.eye(2)
    mhe.R = np.array([[1e-3]])
    mhe.P0 = 0.05 * np.eye(2)
    mhe.set_initial_parameter_values([1.0] * 6)
    mhe.setup(dt=0.1, options={"tol": 1e-9, "max_iter": 60}, **setup_kw)
    mhe.set_initial_guess([0.25, 0.08])
    return mhe


def _rk4(x, u):
    def ode(x):
        r = (1.0 - x[0]) * np.exp(-1.0 / (1.0 + x[1]))
        return np.array([-x[0] + r, -x[1] + r + u[0]])
    k1 = ode(x)
    k2 = ode(x + 0.05 * k1)
    k3 = ode(x + 0.05 * k2)
    k4 = ode(x + 0.1 * k3)
    return x + (0.1 / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


class TestEmbeddedEKF:
    def test_matches_host_filter_over_run(self, tmp_path, cc):
        ekf = _ekf()
        src = generate_ekf_c(ekf, str(tmp_path / "cstr_ekf.c"))
        step_c = load_ekf(compile_shared(src), nx=2, ny=1, nu=1)
        host_step = ekf.step_fn()
        t = lambda a: torch.as_tensor(np.asarray(a, float), dtype=F64)  # noqa: E731
        p = t(np.ones(6))
        rng = np.random.default_rng(0)
        x_h, P_h = np.array([0.25, 0.08]), 0.05 * np.eye(2)
        x_c, P_c = x_h.copy(), P_h.copy()
        x_true = np.array([0.2, 0.1])
        for k in range(30):
            u = np.array([0.3 * np.sin(0.2 * k)])
            x_true = _rk4(x_true, u)
            y = np.array([x_true[1] + 0.002 * rng.standard_normal()])
            xh, Ph, _ = host_step(t(x_h), t(P_h), t(u), p, t(y), k * 0.1)
            x_h, P_h = xh.numpy(), Ph.numpy()
            x_c, P_c = step_c(x_c, P_c, u, y, t=k * 0.1)
            np.testing.assert_allclose(x_c, x_h, atol=2e-5)
            np.testing.assert_allclose(P_c, P_h, atol=2e-5)
        assert np.abs(x_h - x_true).max() < 2e-2

    def test_meas_body_transpile(self):
        body = generate_meas_c(_model())
        assert "y[0]" in body and "x[1]" in body

    def test_requires_dsl_measurements(self, tmp_path):
        m = Model(name="nomeas")
        m.set_dynamical_states("x")
        m.set_dynamical_equations(lambda x: -x)
        ekf = ExtendedKalmanFilter(m)
        ekf.setup(dt=0.1, **KW)
        with pytest.raises(ValueError, match="DSL|equation-string"):
            generate_ekf_c(ekf, str(tmp_path / "bad.c"))

    def test_covariance_stays_spd(self, tmp_path, cc):
        ekf = _ekf()
        src = generate_ekf_c(ekf, str(tmp_path / "cstr_ekf2.c"))
        step_c = load_ekf(compile_shared(src), nx=2, ny=1, nu=1)
        x, P = np.array([0.2, 0.1]), 0.1 * np.eye(2)
        for k in range(50):
            x, P = step_c(x, P, np.array([0.0]), np.array([0.1 + 0.01 * np.sin(k)]),
                          t=0.1 * k)
        assert np.linalg.eigvalsh(P).min() > 0
        np.testing.assert_allclose(P, P.T, atol=1e-14)


def _plant_run(steps, seed=0):
    rng = np.random.default_rng(seed)
    x = np.array([0.2, 0.1])
    Us, Ys, Xs = [], [], [x.copy()]
    for k in range(steps):
        u = np.array([0.3 * np.sin(0.25 * k)])
        Ys.append([x[1] + 0.003 * rng.standard_normal()])
        x = _rk4(x, u)
        Us.append(u.copy())
        Xs.append(x.copy())
    return np.array(Xs), np.array(Us), np.array(Ys)


class TestEmbeddedMHE:
    def test_matches_host_mhe_over_run(self, tmp_path, cc):
        N = 6
        mhe = _mhe(N)
        src = generate_mhe_c(mhe, str(tmp_path / "cstr_mhe.c"))
        solve_c = load_mhe(compile_shared(src), nx=2, ny=1, nu=1, N=N)
        X_true, Us, Ys = _plant_run(16)
        x_host = []
        for k in range(len(Us)):
            est = mhe.estimate(y=Ys[k], u=Us[k])
            if est is not None:
                x_host.append(np.asarray(est, dtype=float))
        x_c = []
        x_arr = np.array([0.25, 0.08])
        for k in range(N, len(Us)):
            xe, x_arr = solve_c(Ys[k - N:k + 1], Us[k - N + 1:k + 1], x_arr,
                                t=(k - N) * 0.1)
            x_c.append(xe)
        assert len(x_c) == len(x_host)
        np.testing.assert_allclose(np.array(x_c), np.array(x_host), atol=5e-4)
        assert np.abs(x_c[-1] - X_true[len(Us)]).max() < 5e-2

    def test_rejects_estimated_params(self, tmp_path):
        m = _model()
        mhe = MovingHorizonEstimator(m)
        mhe.horizon = 4
        mhe.set_estimated_parameters(["E"])
        mhe.Q = 1e-3 * np.eye(2)
        mhe.R = np.array([[1e-3]])
        mhe.P0 = 0.05 * np.eye(2)
        mhe.set_initial_parameter_values([1.0] * 6)
        mhe.setup(dt=0.1, **KW)
        with pytest.raises(NotImplementedError, match="state estimation"):
            generate_mhe_c(mhe, str(tmp_path / "bad.c"))


class TestEmissionParity:
    def test_ekf_and_mhe_bytes_equal_jax(self, tmp_path):
        from hilo_mpc_tpu import Model as JaxModel
        from hilo_mpc_tpu.embedded.ekf_codegen import generate_ekf_c as jax_ekf_c
        from hilo_mpc_tpu.embedded.mhe_codegen import generate_mhe_c as jax_mhe_c
        from hilo_mpc_tpu.estimation import ExtendedKalmanFilter as JaxEKF
        from hilo_mpc_tpu.estimation.mhe import MovingHorizonEstimator as JaxMHE

        pairs = ((jax_ekf_c(_ekf(JaxEKF, JaxModel, {}), str(tmp_path / "je.c")),
                  generate_ekf_c(_ekf(), str(tmp_path / "te.c"))),
                 (jax_mhe_c(_mhe(6, JaxMHE, JaxModel, {}), str(tmp_path / "jm.c")),
                  generate_mhe_c(_mhe(6), str(tmp_path / "tm.c"))))
        for a, b in pairs:
            assert open(a).read() == open(b).read()
