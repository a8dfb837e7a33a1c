"""PyTorch port: the Δu-augmented NMPC (input-change costs, Δu bounds, a
control horizon shorter than the horizon, ``prepare_batch(u_prev=)``)
against the JAX package (CPU, float64).

- Golden ``du_tracking``'s controller (tests/golden_configs.py:360-380) in
  both packages: ``prepare_batch(u_prev=)`` gives the same solver inputs,
  ``solve_batch_fn`` the same U and X to 1e-10 with equal iterations, and a
  few closed-loop ``optimize`` steps the same moves; then the golden
  fixture replayed through the port (max|u − u_gold| < 1e-4).
- The control horizon (twin of tests/test_nmpc.py:126): controls frozen
  after Nc, against JAX's optimize to 1e-10.
- The twins of tests/test_nmpc_reference_matrix.py:114
  ``TestChangeInputWeightMatrix`` (input-change costs with path following
  on a point mass) and of tests/test_trajectory_tracking.py's
  ``test_trajectory_with_du_damping``: the port's first move against JAX's.
- ``prepare_batch(u_prev=)`` raises on a controller without the
  augmentation, and on a u_prev of the wrong shape.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_configs import CSTR_P, CSTR_REF, build_du_tracking
from hilo_mpc_tpu import Model as JaxModel
from hilo_mpc_tpu import NMPC as JaxNMPC
from hilo_mpc_tpu.library import cstr_schaffner_and_zeitz as jax_cstr
from hilo_mpc_tpu_torch import NMPC, Model
from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz
from hilo_mpc_tpu_torch.utils.interop import to_numpy, to_torch

torch.set_num_threads(1)
CPU = "cpu"
F64 = torch.float64
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "du_tracking.npz")
DU_OPTS = {"dt": 0.1, "integration_method": "rk4", "tol": 1e-9, "max_iter": 80}


def port_du_tracking(device=CPU, dtype=F64, options=None):
    """The port's twin of golden_configs.build_du_tracking."""
    nmpc = NMPC(cstr_schaffner_and_zeitz())
    nmpc.horizon = 15
    nmpc.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=CSTR_REF)
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    nmpc.quad_stage_cost.add_inputs_change(weights=0.5)
    nmpc.set_box_constraints(u_lb=[-5.0], u_ub=[5.0], du_lb=[-0.5], du_ub=[0.5])
    nmpc.set_parameters(CSTR_P)
    nmpc.setup(options=options or DU_OPTS, device=device, dtype=dtype)
    return nmpc


def _close(port_sol, jax_sol, atol=1e-10):
    np.testing.assert_array_equal(port_sol.iterations, np.asarray(jax_sol.iterations))
    np.testing.assert_allclose(port_sol.U, np.asarray(jax_sol.U), rtol=0, atol=atol)
    np.testing.assert_allclose(port_sol.X, np.asarray(jax_sol.X), rtol=0, atol=atol)


@pytest.fixture(scope="module")
def du_pair():
    jn, _ = build_du_tracking()
    return jn, port_du_tracking()


def test_augmented_dimensions_and_bounds(du_pair):
    jn, tn = du_pair
    assert tn._augment_du and (tn._dims.nx, tn._dims.nu) == (3, 1)
    assert dataclasses.astuple(tn._dims) == dataclasses.astuple(jn._dims)
    for a, b in zip(tn._bounds, jn._bounds):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert "du-augmented" in str(tn)
    # u bounds on the u_prev component from stage 1, Δu bounds on the control
    assert np.isinf(tn._bounds.lbx[0, 2].item()) and tn._bounds.lbx[1, 2].item() == -5.0
    assert tn._bounds.ubu[0, 0].item() == 0.5


def test_batch_with_u_prev_matches_jax(du_pair):
    jn, tn = du_pair
    rng = np.random.default_rng(1)
    x0s = np.array([0.2, 0.1]) + 0.02 * rng.standard_normal((4, 2))
    u_prev = np.clip(0.5 * np.random.default_rng(2).standard_normal((4, 1)), -5, 5)
    jargs = jn.prepare_batch(x0s, u_prev=u_prev)
    targs = tn.prepare_batch(x0s, u_prev=u_prev)
    for a, b in zip(to_numpy(targs), jargs):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-15)
    np.testing.assert_array_equal(to_numpy(targs[1])[:, 2:], u_prev)
    jsol = jn.solve_batch_fn()(*jargs)
    sol = to_numpy(tn.solve_batch_fn()(*to_torch(jargs, device=CPU)))
    assert sol.converged.all()
    _close(sol, jsol)
    u0, _ = tn.optimize_batch(x0s, u_prev=u_prev)
    np.testing.assert_allclose(u0, sol.X[:, 1, 2:3], rtol=0, atol=1e-12)


def test_closed_loop_optimize_matches_jax():
    jn, _ = build_du_tracking()
    tn = port_du_tracking()
    x = np.array([0.2, 0.1])
    for _ in range(3):
        uj, ut = jn.optimize(x), tn.optimize(x)
        assert tn.stats["iterations"] == jn.stats["iterations"]
        np.testing.assert_allclose(ut, uj, rtol=0, atol=1e-10)
        np.testing.assert_allclose(tn._u_old, jn._u_old, rtol=0, atol=1e-10)
        np.testing.assert_allclose(tn.last_prediction["u"],
                                   jn.last_prediction["u"], rtol=0, atol=1e-10)
        # the Δu bound holds between consecutive moves of the prediction
        assert np.all(np.abs(np.diff(tn.last_prediction["u"][:, 0])) <= 0.5 + 1e-7)
        x = x + 0.1 * np.array([-x[0], 0.2 * ut[0]])


def test_golden_du_tracking_replay():
    """tests/golden/du_tracking.npz through the port's optimize: every step
    converged and max|u − u_gold| < 1e-4 (tests/test_golden_parity.py)."""
    data = np.load(GOLDEN)
    tn = port_du_tracking()
    devs = []
    for k in range(data["U_gold"].shape[0]):
        u = tn.optimize(data["X_meas"][k])
        assert tn.stats["converged"], (k, tn.stats)
        devs.append(np.abs(u - data["U_gold"][k]).max())
    assert max(devs) < 1e-4, devs


def _cstr_nmpc(cls, model, N, **box):
    nmpc = cls(model)
    nmpc.horizon = N
    nmpc.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=CSTR_REF)
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    nmpc.set_box_constraints(u_lb=[-5.0], u_ub=[5.0], **box)
    nmpc.set_parameters(CSTR_P)
    return nmpc


def test_control_horizon_matches_jax():
    """tests/test_nmpc.py:126-134: N = 12, Nc = 4; Δu is pinned to 0 past
    Nc, so the controls are frozen after u_4."""
    pair = []
    for jx in (True, False):
        nmpc = _cstr_nmpc(JaxNMPC if jx else NMPC,
                          jax_cstr() if jx else cstr_schaffner_and_zeitz(), 12)
        nmpc.control_horizon = 4
        nmpc.setup(options={"dt": 0.1}, **({} if jx else dict(device=CPU, dtype=F64)))
        nmpc.optimize([0.2, 0.1])
        pair.append(nmpc)
    jn, tn = pair
    assert "Nc=4" in str(tn)
    pred_u = tn.return_prediction()["u"]
    np.testing.assert_allclose(pred_u[4:], np.tile(pred_u[4], (8, 1)), atol=1e-7)
    assert tn.stats["iterations"] == jn.stats["iterations"]
    np.testing.assert_allclose(pred_u, jn.return_prediction()["u"], rtol=0, atol=1e-10)


def test_du_bounds_and_penalty_in_closed_loop():
    """tests/test_nmpc.py:101-124 on the port: |u_k − u_{k-1}| <= 0.02 in
    closed loop, and a heavy Δu weight keeps the first move near u_old = 0."""
    tn = _cstr_nmpc(NMPC, cstr_schaffner_and_zeitz(), 20, du_lb=-0.02, du_ub=0.02)
    tn.setup(options={"dt": 0.1}, device=CPU, dtype=F64)
    plant = cstr_schaffner_and_zeitz()
    plant.setup(dt=0.1, integration_method="rk4", device=CPU, dtype=F64)
    plant.set_initial_conditions([0.2, 0.1])
    plant.set_initial_parameter_values(CSTR_P)
    x, prev = np.array([0.2, 0.1]), 0.0
    for _ in range(6):
        u = tn.optimize(x)
        assert abs(u[0] - prev) <= 0.02 + 1e-6
        prev = u[0]
        x = plant.simulate(u=u, steps=1)["x"][-1]
    fast = _cstr_nmpc(NMPC, cstr_schaffner_and_zeitz(), 20)
    smooth = _cstr_nmpc(NMPC, cstr_schaffner_and_zeitz(), 20)
    smooth.quad_stage_cost.add_inputs_change(weights=50.0)
    for n in (fast, smooth):
        n.setup(options={"dt": 0.1}, device=CPU, dtype=F64)
    assert smooth._augment_du and not fast._augment_du
    assert abs(smooth.optimize([0.2, 0.1])[0]) < abs(fast.optimize([0.2, 0.1])[0])


# -- twins of tests/test_nmpc_reference_matrix.py:114 (point mass, M = 5) ------

M = 5.0
PM_X0 = np.array([0.0, 0.0, 0.0, 0.0])


def _point_mass(jx):
    m = (JaxModel if jx else Model)(name="pm")
    m.set_dynamical_states(["x", "vx", "y", "vy"])
    m.set_inputs(["Fx", "Fy"])
    if jx:
        m.set_dynamical_equations(lambda x, u: jnp.array([x[1], u[0] / M, x[3], u[1] / M]))
    else:
        m.set_dynamical_equations(lambda x, u: torch.stack(
            [x[..., 1], u[..., 0] / M, x[..., 3], u[..., 1] / M], dim=-1))
    return m


def _sine_path(jx):
    if jx:
        return lambda th: jnp.stack([jnp.sin(th), jnp.sin(2.0 * th)])
    return lambda th: torch.stack([torch.sin(th), torch.sin(2.0 * th)], dim=-1)


def _ciw_v1(n, jx):
    n.quad_stage_cost.add_inputs_change(names=["Fx"], weights=[10])


def _ciw_v2(n, jx):
    n.quad_stage_cost.add_inputs_change(names=["Fx"], weights=[10])
    n.quad_stage_cost.add_inputs_change(names=["Fy"], weights=[5])


def _ciw_v3(n, jx):
    n.quad_stage_cost.add_inputs_change(names=["Fx", "Fy"], weights=[10, 5])


def _ciw_v4(n, jx):
    n.quad_stage_cost.add_inputs(names=["Fx", "Fy"], weights=[0.01, 0.01])
    n.quad_stage_cost.add_inputs_change(names=["Fx"], weights=[10])


CIW = {"ciw_v1_one_input_change": _ciw_v1, "ciw_v2_two_input_changes_separately": _ciw_v2,
       "ciw_v3_all_inputs_at_once": _ciw_v3, "ciw_v4_mixed_with_quad_input_cost": _ciw_v4}


def _ciw_nmpc(case, jx):
    nmpc = (JaxNMPC if jx else NMPC)(_point_mass(jx))
    nmpc.horizon = 10
    for cost in (nmpc.quad_stage_cost, nmpc.quad_terminal_cost):
        cost.add_states(names=["x", "y"], weights=[10, 10], path_following=True,
                        path_fn=_sine_path(jx))
    nmpc.set_box_constraints(u_lb=[-20.0, -20.0], u_ub=[20.0, 20.0])
    CIW[case](nmpc, jx)
    nmpc.create_path_variable(u_pf_ub=2.0, speed_ref=1.0, speed_weight=0.5)
    nmpc.setup(options={"dt": 0.1}, **({} if jx else dict(device=CPU, dtype=F64)))
    return nmpc


@pytest.mark.parametrize("case", sorted(CIW))
def test_change_input_weight_matrix_matches_jax(case):
    jn, tn = _ciw_nmpc(case, True), _ciw_nmpc(case, False)
    assert tn._augment_du and tn._path_following
    assert (tn._dims.nx, tn._dims.nu) == (4 + 2 + 1, 2 + 1)
    uj, ut = jn.optimize(PM_X0), tn.optimize(PM_X0)
    assert tn.stats["converged"], tn.stats
    assert np.all(np.isfinite(tn.return_prediction()["x"]))
    assert tn.stats["iterations"] == jn.stats["iterations"]
    np.testing.assert_allclose(ut, uj, rtol=0, atol=1e-10)
    np.testing.assert_allclose(tn._theta_path0, jn._theta_path0, rtol=0, atol=1e-10)


def test_input_change_damps_moves():
    """tests/test_nmpc_reference_matrix.py:165-181 on the port: a heavier Δu
    weight gives a smaller first input change (the port against JAX too)."""
    moves = []
    for w in (0.0, 50.0):
        for jx in (True, False):
            nmpc = (JaxNMPC if jx else NMPC)(_point_mass(jx))
            nmpc.horizon = 10
            nmpc.quad_stage_cost.add_states(names=["x"], weights=[10], ref=[1.0])
            if w:
                nmpc.quad_stage_cost.add_inputs_change(names=["Fx"], weights=[w])
            nmpc.set_box_constraints(u_lb=[-20.0, -20.0], u_ub=[20.0, 20.0])
            nmpc.setup(options={"dt": 0.1}, **({} if jx else dict(device=CPU, dtype=F64)))
            moves.append(abs(float(np.asarray(nmpc.optimize(PM_X0)).ravel()[0])))
    np.testing.assert_allclose(moves[1::2], moves[0::2], rtol=0, atol=1e-10)
    assert moves[3] < 0.5 * moves[1]


def _di(jx):
    m = (JaxModel if jx else Model)(name="di")
    m.set_inputs("u")
    m.set_equations("""
    dpos/dt = vel(t)
    dvel/dt = u(k)
    y(k) = pos(t)
    """)
    return m


def test_trajectory_with_du_damping():
    """tests/test_trajectory_tracking.py:123-133 on the port: the Δu penalty
    shrinks the first move away from u_old = 0 on a ramp reference; each
    controller's move against JAX's."""
    T = 40
    pos = np.linspace(0.0, 0.5, T)
    traj = np.stack([pos, np.gradient(pos, 0.1)], axis=1)
    first = {}
    for du in (None, 5.0):
        for jx in (True, False):
            nmpc = (JaxNMPC if jx else NMPC)(_di(jx))
            nmpc.horizon = 8
            nmpc.quad_stage_cost.add_states(weights=10.0, ref=traj)
            nmpc.quad_stage_cost.add_inputs(weights=0.05)
            if du is not None:
                nmpc.quad_stage_cost.add_inputs_change(weights=du)
            nmpc.setup(options={"dt": 0.1}, **({} if jx else dict(device=CPU, dtype=F64)))
            first[(du, jx)] = float(np.asarray(nmpc.optimize(np.zeros(2))).ravel()[0])
    for du in (None, 5.0):
        assert abs(first[(du, False)] - first[(du, True)]) <= 1e-10
    assert abs(first[(5.0, False)]) < abs(first[(None, False)])


def test_u_prev_needs_the_augmentation():
    """prepare_batch(u_prev=) raises on a plain controller, as JAX's does,
    and on a u_prev of the wrong shape."""
    plain = _cstr_nmpc(NMPC, cstr_schaffner_and_zeitz(), 5)
    plain.setup(options={"dt": 0.1}, device=CPU, dtype=F64)
    assert not plain._augment_du
    with pytest.raises(ValueError, match="Δu-augmented"):
        plain.prepare_batch([[0.2, 0.1]], u_prev=[[0.0]])
    with pytest.raises(ValueError, match="Δu-augmented"):
        plain.optimize_batch([[0.2, 0.1]], u_prev=[[0.0]])
    tn = port_du_tracking()
    with pytest.raises(ValueError, match="u_prev has shape"):
        tn.prepare_batch([[0.2, 0.1], [0.25, 0.1]], u_prev=[[0.0]])
