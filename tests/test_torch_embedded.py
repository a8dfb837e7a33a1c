"""PyTorch port: the embedded C export of PID, LQR and LMPC
(embedded/codegen.py) on the CPU.

The twins of tests/test_embedded.py on the port's controllers (float64 on
the CPU): the condensed QP against the direct sum, and each compiled
controller against its Python counterpart at the JAX tests' bars (PID and
LQR 1e-12, LMPC 2e-4). Emission parity with the JAX package: the same PID
gives byte-identical C; for LQR and LMPC every emitted number is within
1e-12 relative of JAX's (K, H and G are computed in two packages).
"""
import re

import numpy as np
import pytest
import torch

from hilo_mpc_tpu_torch import LMPC, LQR, PID, Model
from hilo_mpc_tpu_torch.embedded import (condense_lmpc, find_c_compiler,
                                         generate_lmpc_c, generate_lqr_c,
                                         generate_pid_c, setup_solver)

KW = dict(device="cpu", dtype=torch.float64)


def _has_cc():
    try:
        find_c_compiler()
        return True
    except RuntimeError:
        return False


@pytest.fixture
def cc():
    if not _has_cc():
        pytest.skip("no C compiler")


def double_integrator(pkg_model=Model, dt=0.1):
    m = pkg_model(discrete=True)
    m.set_state_space(A=[[1.0, dt], [0.0, 1.0]], B=[[0.5 * dt ** 2], [dt]],
                      C=[[1.0, 0.0]])
    return m


class TestCondensing:
    def test_condensed_qp_matches_direct_sum(self):
        rng = np.random.default_rng(0)
        A = np.array([[1.0, 0.1], [0.0, 0.9]])
        B = np.array([[0.0], [0.1]])
        Q = np.diag([2.0, 1.0])
        R = np.array([[0.5]])
        N = 5
        x0 = rng.standard_normal(2)
        U = rng.standard_normal(N)
        x = x0.copy()
        J = 0.0
        for k in range(N):
            x = A @ x + B @ U[k:k + 1]
            J += 0.5 * (2 * x @ Q @ x)
        J += 0.5 * np.sum(U * (np.kron(np.eye(N), 2 * R) @ U))
        H2, G2 = condense_lmpc(A, B, 2 * Q, 2 * R, None, N)
        const = 0.0
        x = x0.copy()
        for _ in range(N):
            x = A @ x
            const += x @ (2 * Q) @ x
        J_qp = 0.5 * U @ H2 @ U + x0 @ G2.T @ U + 0.5 * const
        np.testing.assert_allclose(J_qp, J, rtol=1e-10)


def _pid(pkg):
    pid = pkg.PID(k_p=1.3, t_i=0.7, t_d=0.05)
    pid.set_output_limits(-2.0, 2.0)
    pid.setup(dt=0.1)
    pid.set_point = [1.0]
    return pid


def _lqr(pkg, **setup_kw):
    lqr = pkg.LQR(double_integrator(pkg.Model))
    lqr.horizon = 20
    lqr.Q = np.eye(2)
    lqr.R = np.eye(1) * 0.1
    lqr.setup(**setup_kw)
    return lqr


def _lmpc(pkg, **setup_kw):
    lmpc = pkg.LMPC(double_integrator(pkg.Model))
    lmpc.horizon = 10
    lmpc.Q = np.diag([5.0, 1.0])
    lmpc.R = np.array([[0.5]])
    lmpc.set_box_constraints(u_lb=-1.0, u_ub=1.0)
    lmpc.setup(options={"dt": 0.1, "tol": 1e-10}, **setup_kw)
    return lmpc


class TestGeneratedControllers:
    def test_pid_c_matches_python(self, cc):
        import hilo_mpc_tpu_torch as T

        pid = _pid(T)
        c_step = setup_solver(pid)
        rng = np.random.default_rng(0)
        for _ in range(20):
            pv = rng.normal()
            u_py = pid.call([pv])
            u_c = c_step([pv])
            np.testing.assert_allclose(u_c, u_py, atol=1e-12)

    def test_lqr_c_matches_python(self, cc):
        import hilo_mpc_tpu_torch as T

        lqr = _lqr(T, **KW)
        c_step = setup_solver(lqr)
        for x in ([1.0, 0.0], [-0.5, 0.3], [0.2, -0.7]):
            np.testing.assert_allclose(c_step(x), lqr.call(x), atol=1e-12)

    def test_lmpc_c_matches_python_solver(self, cc):
        import hilo_mpc_tpu_torch as T

        lmpc = _lmpc(T, **KW)
        c_step = setup_solver(lmpc, fgm_iters=300)
        for x in ([1.0, 0.0], [2.0, -1.0], [-1.5, 0.5]):
            u_c = c_step(np.asarray(x))
            u_py = lmpc.optimize(np.asarray(x))
            lmpc._warm = None  # independent solves
            lmpc._u_old[:] = 0
            np.testing.assert_allclose(u_c, u_py, atol=2e-4)


_NUM = re.compile(r"-?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?")


def _numbers(text):
    return np.array([float(v) for v in _NUM.findall(text)])


class TestEmissionParity:
    def test_pid_bytes_equal_jax(self, tmp_path):
        import hilo_mpc_tpu as J
        from hilo_mpc_tpu.embedded import generate_pid_c as jax_pid_c

        import hilo_mpc_tpu_torch as T

        a = jax_pid_c(_pid(J), str(tmp_path / "j.c"))
        b = generate_pid_c(_pid(T), str(tmp_path / "t.c"))
        assert open(a).read() == open(b).read()

    @pytest.mark.parametrize("what", ["lqr", "lmpc"])
    def test_linear_numbers_within_1e12_of_jax(self, what, tmp_path):
        import hilo_mpc_tpu as J
        from hilo_mpc_tpu.embedded import generate_lmpc_c as jax_lmpc_c
        from hilo_mpc_tpu.embedded import generate_lqr_c as jax_lqr_c

        import hilo_mpc_tpu_torch as T

        build, jgen, tgen = {"lqr": (_lqr, jax_lqr_c, generate_lqr_c),
                             "lmpc": (_lmpc, jax_lmpc_c, generate_lmpc_c)}[what]
        a = open(jgen(build(J), str(tmp_path / "j.c"))).read()
        b = open(tgen(build(T, **KW), str(tmp_path / "t.c"))).read()
        # the same text around the numbers, and the numbers within 1e-12
        assert _NUM.sub("#", a) == _NUM.sub("#", b)
        na, nb = _numbers(a), _numbers(b)
        np.testing.assert_allclose(nb, na, rtol=1e-12, atol=0)

    def test_lmpc_reads_a_model_given_by_callables(self, tmp_path):
        """No A/B matrices: the Jacobians come from the model on its device
        and are read on the host in float64."""
        m = Model(discrete=True)
        m.set_dynamical_states(["p", "v"])
        m.set_inputs("u")
        m.set_dynamical_equations(lambda x, u: torch.stack(
            [x[..., 0] + 0.1 * x[..., 1], x[..., 1] + 0.1 * u[..., 0]], -1))
        m.setup(dt=0.1, **KW)
        lmpc = LMPC(m)
        lmpc.horizon = 5
        lmpc.Q, lmpc.R = np.eye(2), np.array([[0.1]])
        lmpc.set_box_constraints(u_lb=-1.0, u_ub=1.0)
        lmpc.setup(options={"dt": 0.1}, **KW)
        text = open(generate_lmpc_c(lmpc, str(tmp_path / "c.c"))).read()
        assert "#define NUVEC 5" in text and "H_MAT[25]" in text
