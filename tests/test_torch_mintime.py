"""PyTorch port: minimum-time NMPC (``minimize_final_time``) against the
JAX package (CPU, float64).

- Golden ``mintime`` (tests/golden_configs.py:244-273: a rest-to-rest
  double-integrator transfer, terminal equality x_N = 0 through the
  augmented Lagrangian, dt in [0.02, 0.6]): its first steps against JAX's
  optimize (1e-10, equal iterations, the optimal dt read back), then the
  fixture replayed (max|u − u_gold| < 1e-4). Float64 only: in float32 the
  first step stops at max_iter in JAX too.
- The twins of tests/test_nmpc_advanced.py:18-49 ``TestMinimumTime``.
- The cold guess with a non-zero ``u_guess``: JAX's cold U has no column
  for the dt-adjust control, so its rollout reads u_guess there (the index
  clamps) and its solver broadcasts the one column over both; the port's
  full-width guess holds those values (ROADMAP.md §C, reference
  behaviour): the same X and U guess, iterations and moves as JAX.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_configs import build_mintime
from hilo_mpc_tpu import Model as JaxModel
from hilo_mpc_tpu import NMPC as JaxNMPC
from hilo_mpc_tpu_torch import NMPC, Model
from hilo_mpc_tpu_torch.utils.interop import to_numpy, to_torch

torch.set_num_threads(1)
CPU = "cpu"
F64 = torch.float64
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "mintime.npz")
MT_OPTS = {"dt": 0.2, "integration_method": "rk4", "tol": 1e-9, "max_iter": 120}


def _double_integrator(jx):
    m = (JaxModel if jx else Model)(name="di")
    m.set_dynamical_states(["p", "v"])
    m.set_inputs("a")
    if jx:
        m.set_dynamical_equations(lambda x, u: jnp.stack([x[1], u[0]]))
    else:
        m.set_dynamical_equations(lambda x, u: torch.stack([x[..., 1], u[..., 0]], dim=-1))
    return m


def port_mintime(u_guess=None, device=CPU, dtype=F64):
    """The port's twin of golden_configs.build_mintime."""
    nmpc = NMPC(_double_integrator(False))
    nmpc.horizon = 16
    nmpc.set_box_constraints(u_lb=-1.0, u_ub=1.0)
    nmpc.add_terminal_constraint(lambda x: x, lb=[0.0, 0.0], ub=[0.0, 0.0], n=2)
    nmpc.minimize_final_time(weight=1.0, dt_min=0.02, dt_max=0.6)
    if u_guess is not None:
        nmpc.set_initial_guess(u_guess=u_guess)
    nmpc.setup(options=MT_OPTS, device=device, dtype=dtype)
    return nmpc


def test_golden_controller_matches_jax():
    jn, _ = build_mintime()
    tn = port_mintime()
    assert (tn._dims.nx, tn._dims.nu, tn._dims.n_eN) == (3, 2, 2) and "min-time" in str(tn)
    assert not tn._ip_opts.const_cost_hessian
    for a, b in zip(tn._bounds, jn._bounds):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # dt adjusts at stage 0 only: the control is pinned to 0 elsewhere
    assert tn._bounds.lbu[0, 1].item() == pytest.approx(0.02 - 0.2)
    assert (tn._bounds.lbu[1:, 1] == 0).all() and (tn._bounds.ubu[1:, 1] == 0).all()
    X_meas = np.load(GOLDEN)["X_meas"]
    for k in range(2):
        uj, ut = jn.optimize(X_meas[k]), tn.optimize(X_meas[k])
        assert tn.stats["iterations"] == jn.stats["iterations"]
        np.testing.assert_allclose(ut, uj, rtol=0, atol=1e-10)
        np.testing.assert_allclose(tn.optimal_dt, jn.optimal_dt, rtol=0, atol=1e-10)
        assert tn.optimal_final_time == pytest.approx(16 * tn.optimal_dt)


def test_golden_mintime_replay():
    """tests/golden/mintime.npz through the port's optimize (float64): every
    step converged and max|u − u_gold| < 1e-4 (tests/test_golden_parity.py)."""
    data = np.load(GOLDEN)
    tn = port_mintime()
    devs = []
    for k in range(data["U_gold"].shape[0]):
        u = tn.optimize(data["X_meas"][k])
        assert tn.stats["converged"], (k, tn.stats)
        devs.append(np.abs(u - data["U_gold"][k]).max())
    assert max(devs) < 1e-4, devs


@pytest.mark.parametrize("u_guess", [0.3, -0.05])
def test_cold_guess_with_u_guess_matches_jax(u_guess):
    jn, _ = build_mintime()
    jn.set_initial_guess(u_guess=u_guess)
    jn.setup(options=MT_OPTS)
    tn = port_mintime(u_guess=u_guess)
    x0 = np.array([-1.0, 0.0])
    Xj, Uj = jn._initial_trajectory(jn._solver_x0(x0), jn._assemble_theta(None, None, None))
    Xt, Ut = tn._initial_trajectory(tn._solver_x0(x0), tn._assemble_theta(None, None))
    # JAX's guess has one column; the port's two hold what JAX arrives at
    assert Uj.shape == (16, 1) and Ut.shape == (16, 2)
    np.testing.assert_array_equal(Ut, np.tile(Uj, (1, 2)))
    np.testing.assert_allclose(Xt, Xj, rtol=0, atol=1e-15)
    # the rollouts themselves (before the guess choice) took the dt-adjust
    # control as u_guess: tau_k = dt + k·u_guess
    th = tn._assemble_theta(None, None)
    Xr = tn._rollout_guess(torch.as_tensor(tn._solver_x0(x0))[None],
                           torch.as_tensor(th), torch.as_tensor(Ut))[0].numpy()
    Xrj = np.asarray(jn._rollout_guess_jit(jn._solver_x0(x0), th, Uj))
    np.testing.assert_allclose(Xr, Xrj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(Xr[:, 2], 0.2 + u_guess * np.arange(17), atol=1e-12)
    uj, ut = jn.optimize(x0), tn.optimize(x0)
    assert tn.stats["iterations"] == jn.stats["iterations"] and tn.stats["converged"]
    np.testing.assert_allclose(ut, uj, rtol=0, atol=1e-10)
    np.testing.assert_allclose(tn.optimal_dt, jn.optimal_dt, rtol=0, atol=1e-10)
    # the batch: JAX's U_B is one column wide, widened the same way
    x0s = np.array([x0, [-0.8, 0.1]])
    jargs = [np.asarray(a) for a in jn.prepare_batch(x0s)]
    targs = to_numpy(tn.prepare_batch(x0s))
    for a, b in zip(targs[:3], jargs[:3]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-15)
    np.testing.assert_array_equal(targs[3], np.tile(jargs[3], (1, 1, 2)))
    jsol = jn.solve_batch_fn()(*jargs)
    sol = to_numpy(tn.solve_batch_fn()(*to_torch(targs, device=CPU)))
    np.testing.assert_array_equal(sol.iterations, np.asarray(jsol.iterations))
    np.testing.assert_allclose(sol.U, np.asarray(jsol.U), rtol=0, atol=1e-10)


def test_bang_bang_final_time():
    """tests/test_nmpc_advanced.py:19-39 on the port: rest-to-rest over a
    distance of 1 with |u| <= 1 takes T* = 2, the input bang-bang."""
    nmpc = NMPC(_double_integrator(False))
    nmpc.horizon = 20
    nmpc.set_box_constraints(u_lb=-1.0, u_ub=1.0)
    nmpc.add_terminal_constraint(lambda x: x, lb=[0.0, 0.0], ub=[0.0, 0.0], n=2)
    nmpc.minimize_final_time(weight=1.0, dt_min=0.01, dt_max=1.0)
    nmpc.setup(options={"dt": 0.2, "integration_method": "rk4", "max_iter": 80},
               device=CPU, dtype=F64)
    nmpc.optimize([-1.0, 0.0])
    assert nmpc.stats["converged"], nmpc.stats
    assert abs(nmpc.optimal_final_time - 2.0) < 0.01
    U = nmpc.return_prediction()["u"].ravel()
    np.testing.assert_allclose(U[:9], 1.0, atol=1e-4)
    np.testing.assert_allclose(U[-9:], -1.0, atol=1e-4)
    np.testing.assert_allclose(nmpc.return_prediction()["x"][-1], [0.0, 0.0], atol=1e-6)


def test_dt_bounds_respected():
    """tests/test_nmpc_advanced.py:41-49 on the port, against JAX's dt."""
    pair = []
    for jx in (True, False):
        nmpc = (JaxNMPC if jx else NMPC)(_double_integrator(jx))
        nmpc.horizon = 10
        nmpc.set_box_constraints(u_lb=-1.0, u_ub=1.0)
        nmpc.add_terminal_constraint((lambda x: x[0]) if jx else (lambda x: x[..., 0]),
                                     lb=-1e-6, ub=1e-6, n=1)
        nmpc.minimize_final_time(weight=1.0, dt_min=0.15, dt_max=0.5)
        nmpc.setup(options={"dt": 0.3, "max_iter": 60},
                   **({} if jx else dict(device=CPU, dtype=F64)))
        nmpc.optimize([-0.1, 0.0])
        pair.append(nmpc)
    jn, tn = pair
    assert 0.15 - 1e-6 <= tn.optimal_dt <= 0.5 + 1e-6
    assert tn.stats["iterations"] == jn.stats["iterations"]
    np.testing.assert_allclose(tn.optimal_dt, jn.optimal_dt, rtol=0, atol=1e-10)


def test_whole_solve_gate_declines_min_time():
    """The dt-adjust control is pinned past stage 0, so JAX's gate declines
    min time too; the port's warning names the reason."""
    tn = NMPC(_double_integrator(False))
    tn.horizon = 8
    tn.set_box_constraints(u_lb=-1.0, u_ub=1.0)
    tn.quad_stage_cost.add_states(weights=[1.0, 0.1])
    tn.minimize_final_time(weight=1.0, dt_min=0.05, dt_max=0.5)
    tn.setup(options={"dt": 0.2, "convexify": False, "mehrotra": False,
                      "n_linesearch": 1, "pallas_full": True}, device=CPU, dtype=F64)
    args = tn.prepare_batch(np.array([[-0.5, 0.0], [0.3, 0.1]]))
    with pytest.warns(UserWarning, match="free final time"):
        fn = tn.solve_batch_fn()
    for a, b in zip(fn(*args), tn._solve(*args, tn._mu_cold)):
        assert torch.equal(a, b)
