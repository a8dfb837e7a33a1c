"""PyTorch port: path-following NMPC (``create_path_variable``, path-
parameterised references ``path_following=True`` / ``path_fn`` / a callable
``ref``) against the JAX package (CPU, float64).

Path functions are batch-first on the port: th (...) -> (..., n), where JAX
calls them on a scalar.

- Golden ``pathfollow_soft`` (tests/golden_configs.py:118-150: a kinematic
  point on a sine path with a soft band on py): its first steps against
  JAX's optimize (1e-10, equal iterations, the path parameter read back),
  then the fixture replayed (max|u − u_gold| < 1e-4).
- The twins of tests/test_nmpc_advanced.py ``TestPathFollowing`` and of
  tests/test_nmpc_reference_matrix.py ``TestPathFollowingMatrix``
  (pf_v2..v5 on the point mass), each one step against JAX's.
- The whole-solve gate takes path following under pure Newton steps (the
  traced route of ops/codegen_fx.py): no warning, the kernel's path, and
  its host build against the plain version.
"""
import os
import shutil
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_configs import build_pathfollow_soft
from hilo_mpc_tpu import Model as JaxModel
from hilo_mpc_tpu import NMPC as JaxNMPC
from hilo_mpc_tpu_torch import NMPC, Model
from hilo_mpc_tpu_torch.utils.interop import to_numpy, to_torch

torch.set_num_threads(1)
CPU = "cpu"
F64 = torch.float64
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "pathfollow_soft.npz")


def _kinematic_point(jx):
    m = (JaxModel if jx else Model)(name="pt")
    m.set_dynamical_states(["px", "py"])
    m.set_inputs(["vx", "vy"])
    m.set_dynamical_equations(lambda x, u: u)
    return m


def port_pathfollow_soft(options=None, device=CPU, dtype=F64):
    """The port's twin of golden_configs.build_pathfollow_soft."""
    nmpc = NMPC(_kinematic_point(False))
    nmpc.horizon = 12
    nmpc.quad_stage_cost.add_states(
        names=["px", "py"], weights=[20.0, 20.0], path_following=True,
        path_fn=lambda th: torch.stack([th, torch.sin(th)], dim=-1))
    nmpc.quad_stage_cost.add_inputs(weights=[0.05, 0.05])
    nmpc.set_box_constraints(u_lb=[-2.0, -2.0], u_ub=[2.0, 2.0])
    nmpc.add_stage_constraint(lambda x, u: x[..., 1] - 0.7, ub=0.0, n=1,
                              is_soft=True, weight=50.0)
    nmpc.create_path_variable(u_pf_lb=0.0, u_pf_ub=2.0, speed_ref=1.0,
                              speed_weight=1.0)
    nmpc.setup(options=options or {"dt": 0.1, "tol": 1e-9, "max_iter": 80},
               device=device, dtype=dtype)
    return nmpc


def test_golden_controller_matches_jax():
    jn, _ = build_pathfollow_soft()
    tn = port_pathfollow_soft()
    assert (tn._dims.nx, tn._dims.nu) == (3, 3) and "path-following" in str(tn)
    assert not tn._ip_opts.const_cost_hessian
    for a, b in zip(tn._bounds, jn._bounds):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    X_meas = np.load(GOLDEN)["X_meas"]
    for k in range(3):
        uj, ut = jn.optimize(X_meas[k]), tn.optimize(X_meas[k])
        assert tn.stats["iterations"] == jn.stats["iterations"]
        np.testing.assert_allclose(ut, uj, rtol=0, atol=1e-10)
        np.testing.assert_allclose(tn._theta_path0, jn._theta_path0, rtol=0, atol=1e-10)
    # a batch through both controllers' solve_batch_fn
    x0s = 0.1 * np.random.default_rng(3).standard_normal((4, 2))
    jargs = jn.prepare_batch(x0s)
    targs = tn.prepare_batch(x0s)
    for a, b in zip(to_numpy(targs), jargs):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-15)
    jsol = jn.solve_batch_fn()(*jargs)
    sol = to_numpy(tn.solve_batch_fn()(*to_torch(jargs, device=CPU)))
    assert sol.converged.all()
    np.testing.assert_array_equal(sol.iterations, np.asarray(jsol.iterations))
    np.testing.assert_allclose(sol.U, np.asarray(jsol.U), rtol=0, atol=1e-10)


def test_golden_pathfollow_soft_replay():
    """tests/golden/pathfollow_soft.npz through the port's optimize: every
    step converged and max|u − u_gold| < 1e-4 (tests/test_golden_parity.py)."""
    data = np.load(GOLDEN)
    tn = port_pathfollow_soft()
    devs = []
    for k in range(data["U_gold"].shape[0]):
        u = tn.optimize(data["X_meas"][k])
        assert tn.stats["converged"], (k, tn.stats)
        devs.append(np.abs(u - data["U_gold"][k]).max())
    assert max(devs) < 1e-4, devs


def test_follows_sine_path():
    """tests/test_nmpc_advanced.py:52-83 on the port: the path parameter
    advances and the closed loop hugs the sine curve; a callable ``ref``
    is a path reference too."""
    nmpc = NMPC(_kinematic_point(False))
    nmpc.horizon = 12
    nmpc.quad_stage_cost.add_states(
        names=["px", "py"], weights=[20.0, 20.0],
        ref=lambda th: torch.stack([th, torch.sin(th)], dim=-1))
    nmpc.quad_stage_cost.add_inputs(weights=[0.05, 0.05])
    nmpc.set_box_constraints(u_lb=[-2.0, -2.0], u_ub=[2.0, 2.0])
    nmpc.create_path_variable(u_pf_lb=0.0, u_pf_ub=2.0, speed_ref=1.0, speed_weight=1.0)
    nmpc.setup(options={"dt": 0.1}, device=CPU, dtype=F64)
    assert nmpc._path_following and nmpc.quad_stage_cost.terms[0].path_following
    x = np.array([0.0, 0.0])
    traj = [x]
    for _ in range(30):
        u = nmpc.optimize(x)
        x = x + 0.1 * u
        traj.append(x.copy())
    traj = np.asarray(traj)
    assert nmpc._theta_path0 > 0.5
    tail = traj[10:]
    assert np.max(np.abs(tail[:, 1] - np.sin(tail[:, 0]))) < 0.08
    assert nmpc.stats["converged"]


def test_path_variable_required_for_path_terms():
    """tests/test_nmpc_advanced.py:85-97: setup enables the path variable
    when a path term exists."""
    m = Model(name="pt")
    m.set_dynamical_states(["px"])
    m.set_inputs(["vx"])
    m.set_dynamical_equations(lambda x, u: u)
    nmpc = NMPC(m)
    nmpc.horizon = 5
    nmpc.quad_stage_cost.add_states(names=["px"], weights=1.0, path_following=True,
                                    path_fn=lambda th: th)
    nmpc.setup(options={"dt": 0.1}, device=CPU, dtype=F64)
    assert nmpc._path_following and (nmpc._dims.nx, nmpc._dims.nu) == (2, 2)
    u = nmpc.optimize([0.5])
    assert nmpc.stats["converged"] and np.isfinite(u).all()


# -- twins of tests/test_nmpc_reference_matrix.py:39-111 (point mass, M = 5) ---

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


def _sin(jx, a=1.0):
    """th -> sin(a·th) as a one-entry path reference."""
    if jx:
        return lambda th: jnp.atleast_1d(jnp.sin(a * th))
    return lambda th: torch.sin(a * th)


def _sine_path(jx):
    if jx:
        return lambda th: jnp.stack([jnp.sin(th), jnp.sin(2.0 * th)])
    return lambda th: torch.stack([torch.sin(th), torch.sin(2.0 * th)], dim=-1)


def _pf_v2(n, jx):
    n.quad_stage_cost.add_states(names=["x", "y"], weights=[10, 10],
                                 path_following=True, path_fn=_sine_path(jx))
    n.quad_terminal_cost.add_states(names=["x", "y"], weights=[10, 10],
                                    path_following=True, path_fn=_sine_path(jx))


def _pf_v3(n, jx):
    n.quad_stage_cost.add_states(names=["x"], weights=[10], path_following=True,
                                 path_fn=_sin(jx))
    n.quad_stage_cost.add_states(names=["y"], weights=[10], path_following=True,
                                 path_fn=_sin(jx, 2.0))
    n.quad_terminal_cost.add_states(names=["x", "y"], weights=[10, 10],
                                    path_following=True, path_fn=_sine_path(jx))


def _pf_v4(n, jx):
    n.quad_stage_cost.add_states(names=["x"], weights=[10], path_following=True,
                                 path_fn=_sin(jx))
    n.quad_stage_cost.add_states(names=["y"], weights=[10], ref=[1.0])
    n.quad_terminal_cost.add_states(names=["x"], weights=[10], path_following=True,
                                    path_fn=_sin(jx))


def _pf_v5(n, jx):
    n.quad_stage_cost.add_states(names=["x", "y"], weights=[10, 10],
                                 path_following=True, path_fn=_sine_path(jx))
    n.quad_stage_cost.add_states(names=["y"], weights=[1], ref=[1.0])
    n.quad_terminal_cost.add_states(names=["x"], weights=[10], path_following=True,
                                    path_fn=_sin(jx))
    n.quad_stage_cost.add_states(names=["y"], weights=[1], ref=[1.0])


PF_MATRIX = {"pf_v2_stage_and_terminal_path": _pf_v2,
             "pf_v3_path_added_multiple_times": _pf_v3,
             "pf_v4_path_plus_constant_reference": _pf_v4,
             "pf_v5_conflicting_path_and_reference": _pf_v5}


def _pf_nmpc(case, jx, options=None):
    nmpc = (JaxNMPC if jx else NMPC)(_point_mass(jx))
    nmpc.horizon = 10
    nmpc.quad_stage_cost.add_inputs(weights=[1e-3, 1e-3])
    nmpc.set_box_constraints(u_lb=[-20.0, -20.0], u_ub=[20.0, 20.0])
    PF_MATRIX[case](nmpc, jx)
    nmpc.create_path_variable(u_pf_ub=2.0, speed_ref=1.0, speed_weight=0.5)
    nmpc.setup(options=options or {"dt": 0.1},
               **({} if jx else dict(device=CPU, dtype=F64)))
    return nmpc


@pytest.mark.parametrize("case", sorted(PF_MATRIX))
def test_path_following_matrix_matches_jax(case):
    jn, tn = _pf_nmpc(case, True), _pf_nmpc(case, False)
    uj, ut = jn.optimize(PM_X0), tn.optimize(PM_X0)
    assert tn.stats["converged"], tn.stats
    pred = tn.return_prediction()
    assert np.all(np.isfinite(pred["x"])) and tn._theta_path0 >= 0.0
    assert tn.stats["iterations"] == jn.stats["iterations"]
    np.testing.assert_allclose(ut, uj, rtol=0, atol=1e-10)
    np.testing.assert_allclose(pred["x"], jn.return_prediction()["x"], rtol=0, atol=1e-10)
    if case == "pf_v4_path_plus_constant_reference":
        assert pred["x"][-1, 2] > 0.01        # the constant reference pulls y up


def test_whole_solve_gate_takes_path_following():
    """pallas_full on a path-following controller (JAX's gate takes it too):
    the path reference sends it to the traced route, no warning; on CPU the
    kernel's plain version, and the host build of the traced problem against
    it (float64, equal iterations, 1e-12)."""
    from hilo_mpc_tpu_torch.ops import whole_ip as W
    if shutil.which("c++") is None and shutil.which("g++") is None:
        pytest.skip("no host C++ compiler on PATH")
    opts = {"dt": 0.1, "convexify": False, "mehrotra": False, "n_linesearch": 1,
            "pallas_full": True}
    tn = _pf_nmpc("pf_v2_stage_and_terminal_path", False, options=opts)
    assert tn._funcs.source.cost_error is None
    assert "path-following reference" in tn._funcs.source.dsl_error
    args = tn.prepare_batch(np.zeros((2, 4)))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        fn = tn.solve_batch_fn()
    assert tn._wip["eligible"] and "codegen_fx.py" in tn._wip["problem"].text
    f = (tn._funcs, tn._dims, tn._bounds)
    ref = W.solve_ocp_full_reference(*f, *args, tn._ip_opts)
    for a, b in zip(fn(*args), ref):
        assert torch.equal(a, b)
    k = W.solve_ocp_full_host(*f, *args, tn._ip_opts)
    assert torch.equal(k.iterations, ref.iterations)
    torch.testing.assert_close(k.U, ref.U, rtol=0, atol=1e-12)
    torch.testing.assert_close(k.X, ref.X, rtol=0, atol=1e-12)
