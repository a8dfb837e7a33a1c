"""PyTorch port: stochastic MPC's solves (hilo_mpc_tpu_torch/control/smpc.py)
against the JAX package (CPU, float64), on golden smpc_chance's controller
(its GP carried across): optimize from the physical x0 (U to 1e-8, equal
iterations); the batch entry points on (B, nx + nx²) states against JAX's
and against single solves; pallas_full taking the SMPC without chance rows
(the GP variance's triangular solve emitted) and giving the whole-solve
path's plain version's bits, with no Riccati launch."""
import warnings

import numpy as np
import torch

from golden_configs import build_smpc_chance
from hilo_mpc_tpu import GP as JaxGP
from hilo_mpc_tpu_torch import SMPC
from hilo_mpc_tpu_torch.ops import whole_ip as W
from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda
from hilo_mpc_tpu_torch.utils.interop import gp_from, to_numpy, to_torch
from test_torch_smpc import gps, models

torch.set_num_threads(1)
CPU, F64 = "cpu", torch.float64
GOLDEN_OPTS = {"dt": 0.1, "tol": 1e-9, "max_iter": 80}


def golden_gp():
    """golden_configs.build_smpc_chance's JAX GP (25 points on x1)."""
    rng = np.random.default_rng(3)
    X = np.linspace(-1.5, 1.5, 25)[:, None]
    y = 0.05 * np.sin(2 * X[:, 0]) + 0.02 * rng.standard_normal(25)
    gp = JaxGP(["x1"], ["d"], noise_variance=0.02)
    gp.set_training_data(X, y)
    return gp.setup()


def jax_golden(horizon=10):
    js, _ = build_smpc_chance()
    if horizon != js.horizon:
        js.horizon = horizon
        js.setup(options=GOLDEN_OPTS)
    return js


def port_golden(horizon=10, gp=None):
    """The port's twin of golden_configs.build_smpc_chance's controller, its
    GP carried across."""
    _, tm = models()
    t = SMPC(tm, gps={"x2": gp_from(gp or golden_gp(), device=CPU)}, dt=0.1)
    t.horizon = horizon
    t.quad_stage_cost.add_states(names=["x1", "x2"], weights=[5.0, 1.0], ref=[0.85, 0.0])
    t.quad_stage_cost.add_inputs(weights=0.05)
    t.set_box_constraints(u_lb=[-2.0], u_ub=[2.0])
    t.set_box_chance_constraints(x_ub=[0.9, np.inf], level=0.95)
    return t.setup(options=GOLDEN_OPTS, device=CPU, dtype=F64)


def test_optimize_matches_jax():
    """Two closed-loop steps of golden smpc_chance's controller from the
    physical x0 (vec(P0) = 0 padded): the moves to 1e-8, equal iterations."""
    js, t = jax_golden(), port_golden()
    for x in ([0.3, 0.0], [0.32, 0.05]):
        uj, ut = js.optimize(x), t.optimize(x)
        np.testing.assert_allclose(ut, np.asarray(uj), rtol=0, atol=1e-8)
        assert t.stats["iterations"] == js.stats["iterations"]
    pred = t.return_prediction()["x"]
    assert pred.shape == (11, 6) and np.all(pred[:, 0] <= 0.9 + 1e-9)


def test_batch_entry_points_match_jax_and_single_solves():
    """prepare_batch / solve_batch_fn on (B, nx + nx²) states: JAX's prepared
    inputs and solution (1e-10, equal iterations); optimize_batch's first
    moves equal each scenario's own optimize from a fresh controller."""
    gp = golden_gp()
    js, t = jax_golden(horizon=6), port_golden(horizon=6, gp=gp)
    x0s = np.concatenate([[[0.3, 0.0], [0.1, 0.2], [-0.2, 0.1]],
                          np.tile([1e-4, 0, 0, 1e-4], (3, 1))], 1)
    ja = js.prepare_batch(x0s)
    ta = t.prepare_batch(x0s)
    for a, b in zip(to_numpy(ta), ja):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-12)
    jsol = js.solve_batch_fn()(*ja)
    tsol = t.solve_batch_fn()(*to_torch(ja, device=CPU))
    np.testing.assert_array_equal(tsol.iterations.numpy(), np.asarray(jsol.iterations))
    np.testing.assert_allclose(tsol.U.numpy(), np.asarray(jsol.U), rtol=0, atol=1e-10)
    u_b, _ = t.optimize_batch(x0s)
    for b in range(3):
        single = port_golden(horizon=6, gp=gp)
        single.set_initial_covariance(x0s[b, 2:].reshape(2, 2))
        np.testing.assert_allclose(u_b[b], single.optimize(x0s[b, :2]), rtol=0, atol=1e-10)


def test_pallas_full_declines_the_variance_solve():
    """Without chance rows the whole-solve gate traces the surrogate, the
    GP variance's triangular solve among its ops, and takes it: pallas_full
    gives no warning, the whole-solve path's plain version bit for bit and
    no Riccati launch (the name is kept from when the gate declined it)."""
    opts = {"convexify": False, "n_linesearch": 1, "mehrotra": False, "tol": 1e-8}
    _, tm = models()
    _, tg = gps()
    c = SMPC(tm, gps={"x2": tg}, dt=0.1)
    c.horizon = 4
    c.quad_stage_cost.add_states(names=["x1", "x2"], weights=[5.0, 1.0],
                                 ref=[0.85, 0.0])
    c.quad_stage_cost.add_inputs(weights=0.05)
    c.set_box_constraints(u_lb=[-2.0], u_ub=[2.0])
    c.setup(options={"dt": 0.1, "pallas_full": True, **opts}, device=CPU, dtype=F64)
    problem, why = W.whole_ip_gate(c._funcs, c._dims, c._bounds, c._ip_opts, True)
    assert problem is not None and why is None, why
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        fn = c.solve_batch_fn()
    assert c._wip["eligible"]
    x0s = np.concatenate([[[0.3, 0.0], [0.1, -0.1]], np.zeros((2, 4))], 1)
    args = c.prepare_batch(x0s)
    n_ric = riccati_lq_cuda.launches
    a = fn(*args)
    b = W.solve_ocp_full_reference(c._funcs, c._dims, c._bounds, *args, c._ip_opts)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert riccati_lq_cuda.launches == n_ric
