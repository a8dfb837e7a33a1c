"""PyTorch port: dense NLP/QP/LP programs (ops/programs.py) against the JAX
package (CPU, float64).

Every case of tests/test_programs_data.py::TestNLP/TestQPLP through the
port, each also held against the JAX program on the same data (x to
1e-10, equal iterations); then JAX's ``vmap(solve_dense_nlp)`` against the
port's batched call on 64 parameter values of one program (x, f, g and the
KKT error to 1e-10, equal iterations), and the same on programs without
general constraints, with infinite bounds, with a nonconvex objective that
reaches the eigenvalue clip, and with a step whose every trial point is
non-finite.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hilo_mpc_tpu as J
import hilo_mpc_tpu_torch as T
from hilo_mpc_tpu.ops import programs as JP
from hilo_mpc_tpu_torch import LP, NLP, QP
from hilo_mpc_tpu_torch.ops import programs as TP

TOL = 1e-10


def _setup(prog):
    return prog.setup(device="cpu")


def _twins(build):
    """The same program built in both packages (``build(package)``)."""
    return build(J), _setup(build(T))


def _hold(jprog, tprog, **kw):
    sj, st = jprog.solve(**kw), tprog.solve(**kw)
    np.testing.assert_allclose(st["x"], sj["x"], atol=TOL, rtol=0)
    assert tprog.stats["iterations"] == jprog.stats["iterations"]
    assert st["success"] == sj["success"]
    np.testing.assert_allclose(st["f"], sj["f"], atol=TOL, rtol=0)
    return st


class TestNLP:
    def test_unconstrained_quadratic(self):
        def build(pkg):
            nlp = pkg.NLP()
            nlp.set_decision_variables(2)
            nlp.set_objective(lambda x: (x[0] - 1.0) ** 2 + (x[1] + 2.0) ** 2)
            return nlp

        sol = _hold(*_twins(build), x0=[0.0, 0.0])
        assert sol["success"]
        np.testing.assert_allclose(sol["x"], [1.0, -2.0], atol=1e-6)

    def test_rosenbrock_bounded(self):
        def build(pkg):
            nlp = pkg.NLP()
            nlp.set_decision_variables(2)
            nlp.set_objective(lambda x: (1 - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2)
            return nlp

        sol = _hold(*_twins(build), x0=[-1.0, 1.0], lbx=[-5, -5], ubx=[5, 5])
        assert sol["success"]
        np.testing.assert_allclose(sol["x"], [1.0, 1.0], atol=1e-4)

    def test_constrained_matches_scipy(self):
        from scipy.optimize import minimize

        def build(pkg):
            nlp = pkg.NLP()
            nlp.set_decision_variables(2)
            nlp.set_objective(lambda x: x[0] ** 2 + x[1] ** 2)
            nlp.set_constraints(lambda x: x[0] + x[1], lb=1.0, n=1)
            return nlp

        sol = _hold(*_twins(build), x0=[1.0, 0.0])
        res = minimize(lambda x: x @ x, [1.0, 0.0],
                       constraints=[{"type": "ineq", "fun": lambda x: x[0] + x[1] - 1}])
        assert sol["success"]
        np.testing.assert_allclose(sol["x"], res.x, atol=1e-5)

    def test_missing_objective_raises(self):
        nlp = NLP()
        nlp.set_decision_variables(2)
        with pytest.raises(RuntimeError, match="set_objective"):
            nlp.setup(device="cpu")

    def test_constraint_rows_probed_in_the_program_dtype(self):
        """n=None: the row count comes from one call on zeros at setup, in
        the program's dtype and device."""
        seen = []

        def g(x, p):
            seen.append(x.dtype)
            return torch.stack([x[0] + p[0], x[1] - p[1], x[0] * x[1]])

        nlp = NLP()
        nlp.set_decision_variables(2).set_parameters(2)
        nlp.set_objective(lambda x, p: (x[0] - p[0]) ** 2 + x[1] ** 2)
        nlp.set_constraints(g, ub=1.0)
        nlp.setup(device="cpu", dtype=torch.float32)
        assert nlp._m == 3 and seen[0] == torch.float32
        np.testing.assert_equal(nlp._ubg, np.ones(3))

    def test_missing_card_is_an_error(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        nlp = NLP()
        nlp.set_decision_variables(1)
        nlp.set_objective(lambda x: x[0] ** 2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            nlp.setup()


class TestQPLP:
    def test_qp(self):
        def build(pkg):
            qp = pkg.QP()
            qp.set_quadratic_objective(H=[[2.0, 0.0], [0.0, 2.0]], c=[-2.0, -4.0])
            return qp

        sol = _hold(*_twins(build), lbx=[0, 0], ubx=[10, 10])
        np.testing.assert_allclose(sol["x"], [1.0, 2.0], atol=1e-6)

    def test_qp_with_linear_constraints(self):
        def build(pkg):
            qp = pkg.QP()
            qp.set_quadratic_objective(H=np.eye(2), c=[0.0, 0.0])
            qp.set_linear_constraints(A=[[1.0, 1.0]], lb=2.0)
            return qp

        sol = _hold(*_twins(build), x0=[1.0, 1.0])
        np.testing.assert_allclose(sol["x"], [1.0, 1.0], atol=1e-5)

    def test_lp(self):
        def build(pkg):
            lp = pkg.LP()
            lp.set_linear_objective([-1.0, -2.0])
            lp.set_linear_constraints(A=[[1.0, 1.0]], ub=4.0)
            return lp

        sol = _hold(*_twins(build), lbx=[0, 0], ubx=[3, 3])
        assert sol["success"]
        np.testing.assert_allclose(sol["x"], [1.0, 3.0], atol=1e-5)

    def test_flat_names(self):
        assert T.NLP is T.NonlinearProgram and T.QP is T.QuadraticProgram
        assert T.LP is T.LinearProgram and LP is TP.LinearProgram
        assert issubclass(QP, NLP)


# -- batched parity ----------------------------------------------------------


def _sweep(jf, jg, tf, tg, n, m, x0, p, lbx, ubx, lbg, ubg, **opts):
    """JAX's vmap(solve_dense_nlp) and the port's batched call on the same
    arrays; asserts the fields agree and returns the port's solution."""
    jo, to = JP.DenseIPOptions(**opts), TP.DenseIPOptions(**opts)
    js = jax.vmap(partial(JP.solve_dense_nlp, jf, jg, n, m, options=jo))(
        *(jnp.asarray(a) for a in (x0, p, lbx, ubx, lbg, ubg)))
    ts = TP.solve_dense_nlp(tf, tg, n, m, *(torch.as_tensor(a) for a in
                                            (x0, p, lbx, ubx, lbg, ubg)), options=to)
    np.testing.assert_array_equal(ts.iterations.numpy(), np.asarray(js.iterations))
    np.testing.assert_array_equal(ts.converged.numpy(), np.asarray(js.converged))
    for name in ("x", "f", "g", "kkt_error"):
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                   atol=TOL, rtol=0, err_msg=name)
    return ts


def _params(B=64, seed=18):
    return np.random.default_rng(seed).uniform(-2.0, 2.0, (B, 2))


def test_parameter_sweep_matches_jax_vmap():
    """min |x - p|^2 s.t. x0 + x1 >= 1, |x| <= 5 at 64 values of p."""
    P = _params()
    B = P.shape[0]
    ts = _sweep(lambda x, p: jnp.sum((x - p) ** 2), lambda x, p: jnp.atleast_1d(x[0] + x[1]),
                lambda x, p: torch.sum((x - p) ** 2), lambda x, p: torch.atleast_1d(x[0] + x[1]),
                2, 1, np.zeros((B, 2)), P, np.full((B, 2), -5.0), np.full((B, 2), 5.0),
                np.ones((B, 1)), np.full((B, 1), np.inf))
    assert bool(ts.converged.all())
    # the active rows project p onto x0 + x1 = 1
    act = P.sum(1) < 1
    proj = P + (1 - P.sum(1, keepdims=True)) / 2
    np.testing.assert_allclose(ts.x.numpy()[act], proj[act], atol=1e-6)


def test_batched_program_entry_point():
    """NonlinearProgram.solve_batch equals B single solves (the B = 1 path)."""
    nlp = NLP()
    nlp.set_decision_variables(2).set_parameters(2)
    nlp.set_objective(lambda x, p: torch.sum((x - p) ** 2))
    nlp.set_constraints(lambda x: x[0] + x[1], lb=1.0)
    nlp.setup(device="cpu")
    P = _params(8)
    sol = nlp.solve_batch(x0=np.zeros((8, 2)), p=P, lbx=[-5, -5], ubx=[5, 5])
    for i in range(8):
        one = nlp.solve(x0=[0.0, 0.0], p=P[i], lbx=[-5, -5], ubx=[5, 5])
        np.testing.assert_allclose(sol.x[i].numpy(), one["x"], atol=1e-12, rtol=0)
        assert int(sol.iterations[i]) == nlp.stats["iterations"]


def test_no_general_constraints():
    """m = 0: the bounds alone."""
    P = _params(16)
    B = P.shape[0]
    _sweep(lambda x, p: jnp.sum((x - p) ** 2) + 0.1 * x[0] ** 4, None,
           lambda x, p: torch.sum((x - p) ** 2) + 0.1 * x[0] ** 4, None,
           2, 0, np.full((B, 2), 0.5), P, np.full((B, 2), -1.0), np.full((B, 2), 1.0),
           np.zeros((B, 0)), np.zeros((B, 0)))


def test_infinite_bounds_mixed():
    """Infinite and finite bounds side by side (the 1e20 clip and the
    row mask), on x and on g."""
    P = _params(16, seed=5)
    B = P.shape[0]
    lbx = np.tile([-np.inf, -1.5], (B, 1))
    ubx = np.tile([np.inf, 1.5], (B, 1))
    lbg = np.tile([-np.inf, 0.5], (B, 1))
    ubg = np.tile([2.0, np.inf], (B, 1))

    def jg(x, p):
        return jnp.stack([x[0] * x[1], x[0] + x[1]])

    def tg(x, p):
        return torch.stack([x[0] * x[1], x[0] + x[1]])

    _sweep(lambda x, p: jnp.sum((x - p) ** 2), jg, lambda x, p: torch.sum((x - p) ** 2), tg,
           2, 2, np.zeros((B, 2)), P, lbx, ubx, lbg, ubg)


def test_nonconvex_objective_reaches_the_eigenvalue_clip():
    """f = x0^4/4 - x0^2 + x1^2 from x0 near 0: the Hessian is indefinite
    there, the clip makes the step, the bounds stop it."""
    rng = np.random.default_rng(7)
    B = 16
    x0 = np.column_stack([0.1 * rng.standard_normal(B), rng.standard_normal(B)])
    P = np.zeros((B, 0))
    Hs = np.array([3 * x0[:, 0] ** 2 - 2])
    assert (Hs < 0).all()

    def jf(x, p):
        return 0.25 * x[0] ** 4 - x[0] ** 2 + x[1] ** 2

    def tf(x, p):
        return 0.25 * x[0] ** 4 - x[0] ** 2 + x[1] ** 2

    ts = _sweep(jf, None, tf, None, 2, 0, x0, P, np.full((B, 2), -5.0),
                np.full((B, 2), 5.0), np.zeros((B, 0)), np.zeros((B, 0)))
    assert bool(ts.converged.all())
    np.testing.assert_allclose(np.abs(ts.x.numpy()[:, 0]), np.sqrt(2.0), atol=1e-5)


def test_step_with_every_trial_non_finite():
    """f = log(x0) + x0^2 at x0 = 0.1: the clipped Newton step leaves the
    domain at every trial step length, so every merit is NaN and the first
    trial (argmin over all-infinite values) is taken, in both packages."""
    B = 4
    x0 = np.column_stack([np.linspace(0.1, 0.2, B), np.zeros(B)])
    P = np.zeros((B, 0))

    def jf(x, p):
        return jnp.log(x[0]) + x[0] ** 2 + x[1] ** 2

    def tf(x, p):
        return torch.log(x[0]) + x[0] ** 2 + x[1] ** 2

    for max_iter in (1, 3):
        ts = _sweep(jf, None, tf, None, 2, 0, x0, P, np.full((B, 2), -np.inf),
                    np.full((B, 2), np.inf), np.zeros((B, 0)), np.zeros((B, 0)),
                    max_iter=max_iter)
        assert not bool(ts.converged.any())
        assert (ts.iterations.numpy() == max_iter).all()
        if max_iter == 1:
            # the first trial (the full step, far outside the domain) was taken
            assert (ts.x.numpy()[:, 0] < -1e6).all()
