"""PyTorch port: moving-horizon estimation against the JAX package (CPU,
float64), and the interior point with a free initial state.

Each JAX estimator is rebuilt in the port by ``utils/interop.py:
estimator_from`` (models given as callables get a port twin written here), so
both start from the same numbers; windows come from numpy RK4 plants. x_est
agrees within 1e-8 and iteration counts within one (a last-digit difference
can move a barrier update by one iteration). JAX estimators are built once
per module: each JAX setup traces and compiles.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hilo_mpc_tpu.ops.ip_solver as jip
from golden_configs import CSTR_P, build_mhe_cstr, cstr_ode_np, rk4_np
from hilo_mpc_tpu import MHE as JaxMHE
from hilo_mpc_tpu import Model as JaxModel
from hilo_mpc_tpu.library import cstr_schaffner_and_zeitz as jax_cstr
from hilo_mpc_tpu_torch import MHE, Model
from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz
from hilo_mpc_tpu_torch.ops import ip_solver as tip
from hilo_mpc_tpu_torch.utils.interop import estimator_from, to_numpy, to_torch

torch.set_num_threads(1)
CPU = "cpu"
F64 = torch.float64
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "mhe_cstr.npz")
X_TOL = 1e-8


# -- models: the JAX side and the port's twin ----------------------------------

def jax_pendulum():
    m = JaxModel(name="pend")
    m.set_dynamical_states(["th", "om"])
    m.set_inputs("tau")
    m.set_measurements(["y_th"])
    m.set_dynamical_equations(
        lambda x, u: jnp.array([x[1], -jnp.sin(x[0]) - 0.3 * x[1] + u[0]]))
    m.set_measurement_equations(lambda x: x[:1])
    return m


def port_pendulum():
    m = Model(name="pend")
    m.set_dynamical_states(["th", "om"])
    m.set_inputs("tau")
    m.set_measurements(["y_th"])
    m.set_dynamical_equations(lambda x, u: torch.stack(
        [x[..., 1], -torch.sin(x[..., 0]) - 0.3 * x[..., 1] + u[..., 0]], dim=-1))
    m.set_measurement_equations(lambda x: x[..., :1])
    return m


def pendulum_np(x, u):
    return np.array([x[1], -np.sin(x[0]) - 0.3 * x[1] + u[0]])


def jax_range_model():
    """Range-only measurement y = x1² + x2² (tests/test_mhe_fastpath.py:19-28)."""
    m = JaxModel()
    m.set_dynamical_states(["x1", "x2"])
    m.set_inputs("u")
    m.set_measurements(["r"])
    m.set_dynamical_equations(
        lambda x, u: jnp.array([x[1], -x[0] - 0.4 * x[1] + u[0]]))
    m.set_measurement_equations(lambda x: jnp.array([x[0] ** 2 + x[1] ** 2]))
    return m


def port_range_model():
    m = Model()
    m.set_dynamical_states(["x1", "x2"])
    m.set_inputs("u")
    m.set_measurements(["r"])
    m.set_dynamical_equations(lambda x, u: torch.stack(
        [x[..., 1], -x[..., 0] - 0.4 * x[..., 1] + u[..., 0]], dim=-1))
    m.set_measurement_equations(lambda x: (x[..., 0] ** 2 + x[..., 1] ** 2)[..., None])
    return m


def range_np(x, u):
    return np.array([x[1], -x[0] - 0.4 * x[1] + u[0]])


def jax_decay():
    """x' = -a x, a estimated (tests/test_estimators.py:153)."""
    m = JaxModel()
    m.set_dynamical_states("x")
    m.set_parameters("a")
    m.set_dynamical_equations(lambda x, p: -p[0] * x)
    return m


def port_decay():
    m = Model()
    m.set_dynamical_states("x")
    m.set_parameters("a")
    m.set_dynamical_equations(lambda x, p: -p[..., :1] * x)
    return m


def windows(f, meas, x0s, N, dt, noise, seed, u_mag=0.2):
    """B windows of N+1 rows from a numpy RK4 plant: row k is (y_k, the input
    that produced x_k); returns (Ys, Us, x at the last row)."""
    rng = np.random.default_rng(seed)
    B = x0s.shape[0]
    Us = u_mag * np.sin(np.linspace(0, 3, N + 1))[None, :, None] \
        + 0.05 * rng.standard_normal((B, N + 1, 1))
    Ys, X = [], x0s.copy()
    for k in range(N + 1):
        if k:
            X = np.stack([rk4_np(f, x, u, dt) for x, u in zip(X, Us[:, k])])
        Ys.append(np.stack([meas(x) for x in X]) + noise * rng.standard_normal(
            (B, 1)))
    return np.stack(Ys, axis=1), Us, X


def setup_pair(jax_est, port_model=None, options=None, dt=0.1):
    """Set the JAX estimator up and build its port twin."""
    jax_est.setup(dt=dt, options=options)
    return jax_est, estimator_from(jax_est, device=CPU, dtype=F64, model=port_model)


def assert_batch_match(pair, Ys, Us, x_arr):
    jm, tm = pair
    xj, sj = jm.estimate_batch(Ys, Us, x_arrivals=x_arr)
    xt, st = tm.estimate_batch(Ys, Us, x_arrivals=x_arr)
    st = to_numpy(st)
    np.testing.assert_allclose(xt, np.asarray(xj), rtol=0, atol=X_TOL)
    np.testing.assert_array_equal(st.converged, np.asarray(sj.converged))
    assert np.abs(st.iterations - np.asarray(sj.iterations)).max() <= 1
    return xt, st


# -- the golden configuration ----------------------------------------------------

@pytest.fixture(scope="module")
def golden_pair():
    jm, _ = build_mhe_cstr()
    return jm, estimator_from(jm, device=CPU, dtype=F64)


def test_golden_config_step_by_step_matches_jax(golden_pair):
    """tests/golden_configs.py:build_mhe_cstr through both packages, one
    estimate per measurement of the golden fixture."""
    jm, tm = golden_pair
    assert tm.fast_path is jm.fast_path is True
    data = np.load(GOLDEN)
    n_est = 0
    for y, u in zip(data["Ys"], data["Us"]):
        a, b = jm.estimate(y=y, u=u), tm.estimate(y=y, u=u)
        if a is None:
            assert b is None
            continue
        n_est += 1
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=X_TOL)
        assert abs(tm.stats["iterations"] - jm.stats["iterations"]) <= 1
        assert tm.stats["converged"] == jm.stats["converged"]
    assert n_est == len(data["est_steps"])
    np.testing.assert_allclose(tm.solution["x"], jm.solution["x"], atol=X_TOL)
    np.testing.assert_allclose(tm.solution["y"], jm.solution["y"], atol=X_TOL)


def port_golden_mhe():
    """The port's own twin of golden_configs.build_mhe_cstr, built without
    the JAX package."""
    mhe = MHE(cstr_schaffner_and_zeitz())
    mhe.horizon = 8
    mhe.Q = 1e-3 * np.eye(2)
    mhe.R = np.array([[1e-4]])
    mhe.P0 = 0.05 * np.eye(2)
    mhe.set_initial_parameter_values(CSTR_P)
    mhe.setup(dt=0.1, options={"integration_method": "rk4", "tol": 1e-9,
                               "max_iter": 80}, device=CPU, dtype=F64)
    mhe.set_initial_guess([0.25, 0.08])
    return mhe


def test_golden_replay():
    """tests/golden/mhe_cstr.npz through the port's estimate: the BASELINE
    acceptance max|x_est - x_gold| < 1e-4 (tests/test_golden_parity.py:57-73)."""
    data = np.load(GOLDEN)
    gold = {int(k): data["Xest_gold"][i] for i, k in enumerate(data["est_steps"])}
    mhe = port_golden_mhe()
    devs = []
    for k, (y, u) in enumerate(zip(data["Ys"], data["Us"])):
        est = mhe.estimate(y=y, u=u)
        if est is None:
            assert k not in gold
            continue
        assert mhe.stats["converged"]
        devs.append(np.abs(est - gold[k]).max())
    assert len(devs) == len(gold) and max(devs) < 1e-4, devs


def test_multistart_matches_jax():
    """runs=4: the numpy perturbations are the same in both packages; the
    port solves the four runs as one batch."""
    jm, _ = build_mhe_cstr()
    tm = estimator_from(jm, device=CPU, dtype=F64)
    data = np.load(GOLDEN)
    for y, u in zip(data["Ys"][:11], data["Us"][:11]):
        a = jm.estimate(y=y, u=u, runs=4, seed=3)
        b = tm.estimate(y=y, u=u, runs=4, seed=3)
        if a is None:
            assert b is None
            continue
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=X_TOL)
        assert tm.stats["converged"] == jm.stats["converged"]


# -- estimate_batch, case by case -------------------------------------------------

def cstr_pair(**opts):
    jm = JaxMHE(jax_cstr())
    jm.horizon = 6
    jm.Q, jm.R, jm.P0 = 1e-4, 1e-3, 0.1 * np.eye(2)
    jm.set_initial_parameter_values(CSTR_P)
    jm.set_initial_guess([0.25, 0.15])
    return setup_pair(jm, options={"tol": 1e-8, **opts})


def cstr_windows(B=3, N=6, seed=0):
    x0s = np.array([0.2, 0.1]) + 0.03 * np.random.default_rng(seed).standard_normal((B, 2))
    Ys, Us, X = windows(cstr_ode_np, lambda x: x[1:2], x0s, N, 0.1, 0.005, seed)
    return Ys, Us, x0s, X


@pytest.mark.parametrize("fast", ["auto", False])
def test_batch_cstr_matches_jax(fast):
    """The fast path (detected: the CSTR measures x_2) and the conservative
    path (convexify, ten line-search candidates)."""
    pair = cstr_pair(fast_path=fast)
    assert pair[1].fast_path is pair[0].fast_path is (fast == "auto")
    assert pair[1]._ip_opts.n_linesearch == pair[0]._ip_opts.n_linesearch
    Ys, Us, x0s, X = cstr_windows()
    xt, st = assert_batch_match(pair, Ys, Us, x0s)
    assert st.converged.all() and np.abs(xt - X).max() < 0.02


def pendulum_pair(N=8, **kw):
    jm = JaxMHE(jax_pendulum())
    jm.horizon = N
    jm.Q, jm.R, jm.P0 = 1e-5, 1e-4, np.eye(2) * 0.2
    if kw:
        jm.set_box_constraints(**kw)
    jm.set_initial_guess([0.4, 0.1])
    return setup_pair(jm, port_pendulum(), dt=0.05)


def test_batch_nan_masked_windows_match_jax():
    """NaN marks a missing sample (tests/test_estimators.py:189-275): a
    dropped row and a dropped first row, per window."""
    pair = pendulum_pair()
    x0s = np.array([[0.5, 0.0], [0.4, 0.1], [0.3, -0.1]])
    Ys, Us, X = windows(pendulum_np, lambda x: x[:1], x0s, 8, 0.05, 0.005, 1)
    Ys[0, 4] = np.nan
    Ys[1, 0] = np.nan
    Ys[2, 2:5] = np.nan
    xt, st = assert_batch_match(pair, Ys, Us, x0s)
    assert np.isfinite(xt).all() and st.converged.all()


def test_batch_process_noise_bound_matches_jax():
    """w_bound=0 pins the process noise (tests/test_estimators.py:320)."""
    pair = pendulum_pair(N=6, w_bound=0.0)
    x0s = np.array([[0.5, 0.0], [0.45, 0.05]])
    Ys, Us, _ = windows(pendulum_np, lambda x: x[:1], x0s, 6, 0.05, 0.02, 2)
    _, st = assert_batch_match(pair, Ys, Us, x0s)
    assert np.abs(st.U).max() < 1e-3


def test_batch_parameter_estimation_matches_jax():
    """An estimated decay rate rides as an augmented state (tests/
    test_estimators.py:153): the window's last node carries a ≈ 0.7."""
    jm = JaxMHE(jax_decay())
    jm.horizon = 8
    jm.Q, jm.R, jm.P0 = 1e-6, 1e-6, np.eye(1) * 10.0
    jm.set_estimated_parameters(["a"], guess=[0.3], arrival_weight=[[1e-2]])
    jm.set_initial_guess([2.0])
    pair = setup_pair(jm, port_decay())
    x0s = np.array([[2.0], [1.5]])
    Ys, Us, _ = windows(lambda x, u: -0.7 * x, lambda x: x, x0s, 8, 0.1, 0.0, 3,
                        u_mag=0.0)
    _, st = assert_batch_match(pair, Ys, Us, x0s)
    np.testing.assert_allclose(st.X[:, -1, 1], 0.7, atol=0.02)


def test_batch_nonlinear_measurement_matches_jax():
    """A range measurement is not affine: detection says False in both
    packages, and the conservative path runs."""
    jm = JaxMHE(jax_range_model())
    jm.horizon = 5
    jm.Q, jm.R, jm.P0 = 1e-4, 1e-3, np.eye(2) * 0.1
    jm.set_initial_guess([1.0, 0.0])
    pair = setup_pair(jm, port_range_model())
    assert pair[1].fast_path is pair[0].fast_path is False
    assert pair[1]._ip_opts.convexify and pair[1]._ip_opts.n_linesearch == 10
    x0s = np.array([[1.0, 0.0], [0.9, 0.2]])
    Ys, Us, _ = windows(range_np, lambda x: np.array([x[0] ** 2 + x[1] ** 2]),
                        x0s, 5, 0.1, 0.001, 4)
    assert_batch_match(pair, Ys, Us, x0s)


def test_batch_state_space_model_matches_jax():
    """Two decoupled discrete double integrators measured in position, a
    model carried across by its matrices: the estimator differentiates the
    state-space measurement under torch.func, whose matrix the model keeps
    one copy of per device (core/model.py:_device_matrix) and must not make
    inside a transform."""
    A = np.kron(np.eye(2), [[1.0, 0.1], [0.0, 1.0]])
    Bm = np.kron(np.eye(2), [[0.005], [0.1]])
    C = np.kron(np.eye(2), [[1.0, 0.0]])
    jmod = JaxModel(name="di2", discrete=True)
    jmod.set_state_space(A=A, B=Bm, C=C)
    jm = JaxMHE(jmod)
    jm.horizon = 6
    jm.Q, jm.R, jm.P0 = 1e-4, 1e-3, np.eye(4) * 0.1
    pair = setup_pair(jm)
    assert pair[1].fast_path is pair[0].fast_path is True
    rng = np.random.default_rng(7)
    x0s = rng.standard_normal((3, 4))
    X, Us = x0s.copy(), 0.1 * rng.standard_normal((3, 7, 2))
    Ys = []
    for k in range(7):
        if k:
            X = X @ A.T + Us[:, k] @ Bm.T
        Ys.append(X @ C.T + 0.01 * rng.standard_normal((3, 2)))
    xt, st = assert_batch_match(pair, np.stack(Ys, axis=1), Us, x0s)
    assert st.converged.all() and np.abs(xt - X).max() < 0.05


def test_estimate_batch_mesh_is_not_ported():
    """estimate_batch(mesh=) is ported (parallel/sharding.py): the windows
    split over a 2-shard CPU mesh give the same estimates as no mesh, and a
    batch the mesh does not divide is refused."""
    from hilo_mpc_tpu_torch.parallel import make_mesh

    mhe = port_golden_mhe()
    Ys = 0.12 + 0.005 * np.random.default_rng(3).standard_normal((4, 9, 1))
    x_one, _ = mhe.estimate_batch(Ys)
    x_mesh, sol = mhe.estimate_batch(Ys, mesh=make_mesh(2, device=CPU))
    np.testing.assert_array_equal(x_mesh, x_one)
    assert len(sol.X.shards) == 2
    with pytest.raises(ValueError, match="divisible"):
        mhe.estimate_batch(Ys[:3], mesh=make_mesh(2, device=CPU))


def test_setup_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mhe = MHE(cstr_schaffner_and_zeitz())
    mhe.horizon = 4
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mhe.setup(dt=0.1)


# -- the interior point with a free initial state ---------------------------------

def _free_x0_problem():
    """A double integrator whose stage cost tracks a per-scenario reference
    (theta), x_0 free, with state bounds active at x_0 for some scenarios."""
    N, dt = 6, 0.2
    A = np.array([[1.0, dt], [0.0, 1.0]])
    Bm = np.array([[0.5 * dt ** 2], [dt]])
    Q, R = np.diag([1.0, 0.5]), np.array([[0.1]])
    jfuncs = jip.OCPFunctions(
        dyn=lambda x, u, th: jnp.asarray(A) @ x + jnp.asarray(Bm) @ u,
        stage_cost=lambda x, u, th: ((x - th) @ jnp.asarray(Q) @ (x - th)
                                     + u @ jnp.asarray(R) @ u),
        term_cost=lambda x, th: (x - th) @ jnp.asarray(Q) @ (x - th))
    At, Bt, Qt, Rt = (torch.as_tensor(a) for a in (A, Bm, Q, R))
    tfuncs = tip.OCPFunctions(
        dyn=lambda x, u, th: x @ At.T + u @ Bt.T,
        stage_cost=lambda x, u, th: (((x - th) @ Qt) * (x - th)).sum(-1)
        + ((u @ Rt) * u).sum(-1),
        term_cost=lambda x, th: (((x - th) @ Qt) * (x - th)).sum(-1))
    rng = np.random.default_rng(5)
    theta = 1.2 * rng.standard_normal((4, N + 1, 2))
    bnd = (np.full((N + 1, 2), -0.8), np.full((N + 1, 2), 0.8),
           np.full((N, 1), -1.0), np.full((N, 1), 1.0))
    x0s = np.zeros((4, 2))
    args = (theta, x0s, np.zeros((4, N + 1, 2)), np.zeros((4, N, 1)))
    return jfuncs, tfuncs, jip.OCPDims(nx=2, nu=1, N=N), tip.OCPDims(nx=2, nu=1, N=N), \
        bnd, args


def test_free_x0_solve_ocp_matches_jax():
    """solve_ocp(fix_x0=False) against JAX's: the bound rows of x_0 stay (and
    bind: x_0 sits on ±0.8 where the reference lies beyond), X_init[:, 0] is
    the start, r_x[0] joins the KKT test."""
    jfuncs, tfuncs, jdims, tdims, bnd, args = _free_x0_problem()
    opts = dict(max_iter=40, tol=1e-8)
    # jitted: one compile of the batched solve instead of an eager dispatch
    jsol = jax.jit(lambda b, *a: jip.solve_ocp_batched(
        jfuncs, jdims, b, *a, jip.IPOptions(**opts), fix_x0=False))(
        jip.OCPBounds(*map(jnp.asarray, bnd)), *map(jnp.asarray, args))
    tsol = tip.solve_ocp(tfuncs, tdims, tip.OCPBounds(*to_torch(bnd, device=CPU)),
                         *to_torch(args, device=CPU), tip.IPOptions(**opts),
                         fix_x0=False)
    t = to_numpy(tsol)
    assert t.converged.all()
    np.testing.assert_allclose(t.X, np.asarray(jsol.X), rtol=0, atol=1e-6)
    np.testing.assert_allclose(t.U, np.asarray(jsol.U), rtol=0, atol=1e-6)
    assert np.abs(t.iterations - np.asarray(jsol.iterations)).max() <= 1
    assert np.isclose(np.abs(t.X[:, 0]).max(), 0.8, atol=1e-4)


# -- on the card -------------------------------------------------------------------

@pytest.mark.cuda
def test_estimate_batch_on_card_matches_plain():
    """B=64 CSTR windows through the kernel's free-x0 mode: one LQ launch per
    iteration, no plain sweep, the same estimates as the plain LQ step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from hilo_mpc_tpu_torch.ops import riccati
    from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda

    mhe = MHE(cstr_schaffner_and_zeitz())
    mhe.horizon = 10
    mhe.Q, mhe.R, mhe.P0 = 1e-4, 1e-3, np.eye(2) * 0.1
    mhe.set_initial_parameter_values(CSTR_P)
    mhe.setup(dt=0.1, device="cuda", dtype=F64)
    Ys, Us, x0s, X = cstr_windows(B=64, N=10, seed=6)
    n0 = riccati_lq_cuda.launches
    x_est, sol = mhe.estimate_batch(Ys, Us, x_arrivals=x0s)
    assert riccati_lq_cuda.launches - n0 == int(sol.iterations.max())
    ref = tip.solve_ocp(mhe._funcs, mhe._dims, mhe._bounds,
                        *(mhe._tensor(a) for a in (
                            mhe._theta_batch(Ys, Us, x0s, np.asarray(CSTR_P)), x0s,
                            np.tile(x0s[:, None], (1, 11, 1)), np.zeros((64, 10, 2)))),
                        options=mhe._ip_opts, fix_x0=False,
                        lq_solver=riccati.make_plain_lq_solver)
    np.testing.assert_allclose(x_est, ref.X[:, -1].cpu().numpy(), atol=1e-10)
    assert bool(sol.converged.all())
