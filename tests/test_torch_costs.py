"""PyTorch port: measurement cost terms, generic (callable) costs and soft
generic constraints against the JAX package, and the golden fixture
tests/golden/softcon_active.npz (CPU, float64).

- The measurement cost of tests/test_nmpc_breadth.py:90-109 (a model given
  as callables, y = x_1 + x_2 tracked to 1): one ``optimize`` from the same
  start in both packages, the predicted trajectories to 1e-10 and the same
  iteration count.
- A generic stage and terminal cost (quartic, with an x-u cross term),
  started once the same way.
- Soft generic constraints: a stage bound with ``max_violation`` (its hard
  row active) and a terminal bound with ``linear_weight``: the JAX batch
  through both controllers, U to 1e-10, the same iterations.
- The golden ``softcon_active`` (a soft state bound active along the whole
  steady state) replayed through ``optimize``: max|u - u_gold| < 1e-4; it
  reads 2.838e-08, the JAX package's own deviation at generation.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_configs import CSTR_P, CSTR_REF
from hilo_mpc_tpu import NMPC as JaxNMPC
from hilo_mpc_tpu import Model as JaxModel
from hilo_mpc_tpu.library import cstr_schaffner_and_zeitz as jax_cstr
from hilo_mpc_tpu_torch import NMPC, Model
from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz
from hilo_mpc_tpu_torch.utils.interop import to_numpy, to_torch

torch.set_num_threads(1)
CPU = "cpu"
F64 = torch.float64
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "softcon_active.npz")


def _setup(nmpc, jx, options):
    nmpc.setup(options=options, **({} if jx else dict(device=CPU, dtype=F64)))
    return nmpc


def _measurement_controller(jx):
    m = (JaxModel if jx else Model)()
    m.set_dynamical_states(["a", "b"])
    m.set_inputs("u")
    m.set_measurements(["y_sum"])
    if jx:
        m.set_dynamical_equations(
            lambda x, u: jnp.array([-x[0] + u[0], -2.0 * x[1] + u[0]]))
        m.set_measurement_equations(lambda x: jnp.array([x[0] + x[1]]))
    else:
        # batch-first; a one-row measurement may return the batch shape
        m.set_dynamical_equations(
            lambda x, u: [-x[..., 0] + u[..., 0], -2.0 * x[..., 1] + u[..., 0]])
        m.set_measurement_equations(lambda x: x[..., 0] + x[..., 1])
    nmpc = (JaxNMPC if jx else NMPC)(m)
    nmpc.horizon = 10
    nmpc.quad_stage_cost.add_measurements(weights=5.0, ref=[1.0])
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    return _setup(nmpc, jx, {"dt": 0.2})


def _cstr(jx, horizon, **box):
    nmpc = (JaxNMPC if jx else NMPC)(jax_cstr() if jx else cstr_schaffner_and_zeitz())
    nmpc.horizon = horizon
    nmpc.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=CSTR_REF)
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    nmpc.set_parameters(CSTR_P)
    nmpc.set_box_constraints(u_lb=[-5.0], u_ub=[5.0], **box)
    return nmpc


def _generic_cost_controller(jx):
    nmpc = _cstr(jx, 12)
    if jx:
        nmpc.stage_cost.cost = lambda x, u: 2.0 * (x[0] - 0.3) ** 4 + 0.5 * x[1] * u[0] ** 2
        nmpc.terminal_cost.cost = lambda x: 20.0 * jnp.sum((x - jnp.array(CSTR_REF)) ** 2)
    else:
        nmpc.stage_cost.cost = (lambda x, u: 2.0 * (x[..., 0] - 0.3) ** 4
                                + 0.5 * x[..., 1] * u[..., 0] ** 2)
        ref = torch.tensor(CSTR_REF, dtype=F64)
        nmpc.terminal_cost.cost = lambda x: 20.0 * ((x - ref) ** 2).sum(-1)
    return _setup(nmpc, jx, {"dt": 0.1})


def _soft_generic_controller(jx):
    nmpc = _cstr(jx, 15)
    first = (lambda x: x[0]) if jx else (lambda x: x[..., 0])
    # soft x_1 <= 0.27 with a hard row at 0.29 (active: the setpoint is 0.3)
    nmpc.add_stage_constraint(first, ub=0.27, n=1, is_soft=True, weight=300.0,
                              max_violation=0.02)
    nmpc.add_terminal_constraint(first, ub=0.28, n=1, is_soft=True, weight=1e3)
    nmpc._terminal_constraints[-1].linear_weight = 5.0
    return _setup(nmpc, jx, {"dt": 0.1})


ONCE = {"measurement": (_measurement_controller, [0.0, 0.0]),
        "generic_cost": (_generic_cost_controller, [0.2, 0.1])}


@pytest.mark.parametrize("case", sorted(ONCE))
def test_optimize_once_matches_jax(case):
    make, x0 = ONCE[case]
    jn, tn = make(True), make(False)
    assert not tn._ip_opts.const_cost_hessian
    ju, tu = jn.optimize(x0), tn.optimize(x0)
    assert jn.stats["converged"] and tn.stats["converged"]
    assert tn.stats["iterations"] == jn.stats["iterations"]
    np.testing.assert_allclose(tu, ju, rtol=0, atol=1e-10)
    jp = jn.return_prediction()
    np.testing.assert_allclose(tn.last_prediction["x"], jp["x"], rtol=0, atol=1e-10)
    np.testing.assert_allclose(tn.last_prediction["u"], jp["u"], rtol=0, atol=1e-10)
    if case == "measurement":
        # the measured sum heads toward 1 (tests/test_nmpc_breadth.py:108-109)
        assert tn.last_prediction["x"][-1].sum() > 0.5


def test_soft_generic_constraints_match_jax():
    jn, tn = _soft_generic_controller(True), _soft_generic_controller(False)
    assert (tn._dims.n_h, tn._dims.n_hN, tn._dims.n_e) == (1, 0, 0)
    x0s = np.array([0.2, 0.1]) + 0.02 * np.random.default_rng(1).standard_normal((3, 2))
    args = jn.prepare_batch(x0s)
    jsol = jn.solve_batch_fn()(*args)
    sol = to_numpy(tn.solve_batch_fn()(*to_torch(args, device=CPU)))
    assert sol.converged.all() and np.asarray(jsol.converged).all()
    np.testing.assert_array_equal(sol.iterations, np.asarray(jsol.iterations))
    np.testing.assert_allclose(sol.U, np.asarray(jsol.U), rtol=0, atol=1e-10)
    # x_1 rides the hard row at 0.27 + 0.02 (in scaled = unscaled units)
    assert sol.X[:, 1:, 0].max() <= 0.29 + 1e-6
    assert sol.X[:, 1:, 0].max() > 0.28


def test_golden_softcon_active_replay():
    """tests/golden/softcon_active.npz through the port's optimize: every
    closed-loop step converged and max|u - u_gold| < 1e-4 (the BASELINE
    acceptance of tests/test_golden_parity.py)."""
    data = np.load(GOLDEN)
    nmpc = _cstr(False, 15, x_ub=[0.27, np.inf], x_soft=True, soft_weight=500.0)
    _setup(nmpc, False, {"dt": 0.1, "integration_method": "rk4", "tol": 1e-9,
                         "max_iter": 80})
    devs = []
    for k in range(data["U_gold"].shape[0]):
        u = nmpc.optimize(data["X_meas"][k])
        assert nmpc.stats["converged"] and nmpc.stats["status"] == 0
        devs.append(np.abs(u - data["U_gold"][k]).max())
    assert max(devs) < 1e-4, devs
