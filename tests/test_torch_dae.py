"""PyTorch port: DAE models, quadratures and implicit integration through
Model, NMPC and the estimators, against the JAX package (CPU, float64).

- ``Model.simulate`` of a DAE: z0 given, and z0 taken from the stored
  solution when none is given (a model whose algebraic equation z² = x has
  two branches, so the start picks the branch; from zeros the Newton
  Jacobian 2z is singular), unbatched and batched.
- Quadratures: continuous (integrated as augmented states, by RK4 and by
  collocation) and discrete (evaluated at the next state), the twins of
  tests/test_model.py:155-190, and a DSL model with ``0 = ...`` and
  ``int = ...`` lines carried across by ``utils/interop.py:model_from``.
- ``linearize``, ``jacobians`` and ``discretize`` with algebraic states.
- NMPC: the CSTR with collocation degree 2 at N=10 (tests/test_nmpc.py:88)
  and the DAE controllers of tests/test_nmpc_breadth.py:22-52, batch and
  closed loop, ≤ 1e-10 with equal iterations; golden ``dae_colloc``
  replayed (< 1e-4); ``pallas_full`` takes implicit integrators and DAE
  models (the whole-solve path, no warning) and declines, naming the
  reason, a step whose Newton exceeds ``NEWTON_MAX`` unknowns.
- MHE, EKF, UKF and PF on the DAE model, at the tolerances of
  tests/test_torch_{mhe,kf,pf}.py.
"""
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_configs import CSTR_P, CSTR_REF, DAE_ALPHA, build_dae_colloc
from hilo_mpc_tpu import EKF as JaxEKF
from hilo_mpc_tpu import MHE as JaxMHE
from hilo_mpc_tpu import NMPC as JaxNMPC
from hilo_mpc_tpu import PF as JaxPF
from hilo_mpc_tpu import UKF as JaxUKF
from hilo_mpc_tpu import Model as JaxModel
from hilo_mpc_tpu.library import cstr_schaffner_and_zeitz as jax_cstr
from hilo_mpc_tpu_torch import EKF, MHE, NMPC, PF, UKF, Model
from hilo_mpc_tpu_torch.core.integrators import IMPLICIT_METHODS, IntegratorSpec
from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz
from hilo_mpc_tpu_torch.ops import codegen_cuda
from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda
from hilo_mpc_tpu_torch.ops.whole_ip import solve_ocp_full_reference
from hilo_mpc_tpu_torch.utils.interop import (estimator_from, model_from, to_numpy,
                                              to_torch)

from test_torch_pf import jax_draws

torch.set_num_threads(1)
CPU = "cpu"
F64 = torch.float64
TOL = dict(rtol=0, atol=1e-12)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "dae_colloc.npz")
CSTR_X0 = [0.2, 0.1]


# -- models: the JAX side and the port's twin ---------------------------------

def dae_golden(lib):
    """golden_configs.build_dae_colloc's model: x' = -x + z + u,
    0 = z - 0.5 x - alpha z²."""
    m = (JaxModel(name="dae", dtype=jnp.float64) if lib is jnp else Model(name="dae"))
    m.set_dynamical_states("x")
    m.set_algebraic_states("z")
    m.set_inputs("u")
    m.set_dynamical_equations(lambda x, z, u: -x + z + u)
    m.set_algebraic_equations(lambda x, z: z - 0.5 * x - DAE_ALPHA * z ** 2)
    return m


def dae_linear(lib):
    """tests/test_nmpc_breadth.py:dae_model: x' = -x + z + u, 0 = z - 0.5 x."""
    m = (JaxModel(name="dae", dtype=jnp.float64) if lib is jnp else Model(name="dae"))
    m.set_dynamical_states("x")
    m.set_algebraic_states("z")
    m.set_inputs("u")
    m.set_dynamical_equations(lambda x, z, u: -x + z + u)
    m.set_algebraic_equations(lambda x, z: z - 0.5 * x)
    return m


def dae_nonlinear(lib):
    """x' = -x² + z + x·u, 0 = z - 0.5 x - alpha z²: nonlinear in (x, u), so
    linearize has work to do."""
    m = (JaxModel(name="dae_nl", dtype=jnp.float64) if lib is jnp
         else Model(name="dae_nl"))
    m.set_dynamical_states("x")
    m.set_algebraic_states("z")
    m.set_inputs("u")
    m.set_dynamical_equations(lambda x, z, u: -x ** 2 + z + x * u)
    m.set_algebraic_equations(lambda x, z: z - 0.5 * x - DAE_ALPHA * z ** 2)
    return m


def branch_model(lib):
    """x' = -0.5 x + 0.2 z, 0 = z² - x: z = ±√x, the start picks the sign."""
    m = (JaxModel(name="branch", dtype=jnp.float64) if lib is jnp
         else Model(name="branch"))
    m.set_dynamical_states("x")
    m.set_algebraic_states("z")
    m.set_dynamical_equations(lambda x, z: -0.5 * x + 0.2 * z)
    m.set_algebraic_equations(lambda x, z: z ** 2 - x)
    return m


def _setup(m, lib, **kw):
    if lib is jnp:
        return m.setup(**kw)
    return m.setup(**kw, device=CPU, dtype=F64)


def _pair(build, **kw):
    mj, mt = build(jnp), build(torch)
    return _setup(mj, jnp, **kw), _setup(mt, torch, **kw)


def _same(out_t, out_j, keys=("x", "z", "y", "q"), tol=TOL):
    for k in keys:
        np.testing.assert_allclose(out_t[k], np.asarray(out_j[k]), err_msg=k, **tol)


# -- simulate: z0 given, or from the stored solution -------------------------

@pytest.mark.parametrize("method", [None, "rk4", "discrete_map"])
def test_simulate_uses_z0_and_the_stored_z(method):
    """z0 = -1 puts z on the negative branch z = -√x; the next simulate
    without z0 continues from the stored solution's last z. With zeros as
    the start the Newton Jacobian 2z is singular and no branch is reached."""
    kw = dict(dt=0.1) if method in (None, "discrete_map") else dict(
        dt=0.1, integration_method=method)
    if method == "discrete_map":
        build = lambda lib: branch_model(lib).discretize("rk4", dt=0.1)  # noqa: E731
    else:
        build = branch_model
    mj, mt = _pair(build, **kw)
    if method is None:
        assert mt._int_spec.method == mj._int_spec.method == "collocation"
    for m in (mj, mt):
        m.set_initial_conditions([1.0], z0=[-1.0])
    _same(mt.simulate(steps=4), mj.simulate(steps=4), ("x", "z"))
    out_t, out_j = mt.simulate(steps=3), mj.simulate(steps=3)
    _same(out_t, out_j, ("x", "z"))
    assert np.all(out_t["z"] < 0)
    np.testing.assert_allclose(out_t["z"][:, 0], -np.sqrt(out_t["x"][:, 0]), atol=1e-9)
    np.testing.assert_allclose(mt.solution["z"], np.asarray(mj.solution["z"]), **TOL)
    # an explicit z0 overrides the stored one
    _same(mt.simulate(x0=[0.7], z0=[0.9], steps=2, store=False),
          mj.simulate(x0=[0.7], z0=[0.9], steps=2, store=False), ("x", "z"))


def test_batched_simulate_takes_per_scenario_and_shared_z0():
    mj, mt = _pair(branch_model, dt=0.1)
    x0s = np.array([[1.0], [0.6], [1.4]])
    z0s = np.array([[-1.0], [0.8], [-1.2]])
    out_t = mt.simulate(x0=x0s, z0=z0s, steps=3)
    out_j = mj.simulate(x0=x0s, z0=z0s, steps=3)
    _same(out_t, out_j, ("x", "z"))
    np.testing.assert_array_equal(np.sign(out_t["z"][:, -1, 0]), [-1.0, 1.0, -1.0])
    shared = mt.simulate(x0=x0s, z0=[-1.0], steps=3)
    np.testing.assert_array_equal(shared["x"], mt.simulate(
        x0=x0s, z0=np.full((3, 1), -1.0), steps=3)["x"])


def test_dae_simulation_matches_jax():
    """tests/test_model.py:178's DAE: x' = -x + z, 0 = z - 0.5 x under
    collocation, against JAX and the closed form."""
    def build(lib):
        m = JaxModel(dtype=jnp.float64) if lib is jnp else Model()
        m.set_dynamical_states("x")
        m.set_algebraic_states("zv")
        m.set_dynamical_equations(lambda x, z: -x + z)
        m.set_algebraic_equations(lambda x, z: z - 0.5 * x)
        return m
    mj, mt = _pair(build, dt=0.1, integration_method="collocation")
    for m in (mj, mt):
        m.set_initial_conditions([1.0], z0=[0.5])
    out_t, out_j = mt.simulate(steps=10), mj.simulate(steps=10)
    _same(out_t, out_j, ("x", "z"))
    np.testing.assert_allclose(out_t["x"][-1, 0], np.exp(-0.5), atol=1e-6)


# -- quadratures ---------------------------------------------------------------

def quad_const(lib):
    m = JaxModel(dtype=jnp.float64) if lib is jnp else Model()
    m.set_dynamical_states("x")
    m.set_dynamical_equations(lambda x: -0.0 * x)
    if lib is jnp:
        m.set_quadrature_functions(lambda x, t: jnp.atleast_1d(2.0 * jnp.ones(())))
    else:
        m.set_quadrature_functions(lambda x, t: 2.0 * torch.ones(()))
    return m


def quad_decay(lib):
    m = JaxModel(dtype=jnp.float64) if lib is jnp else Model()
    m.set_dynamical_states("x")
    m.set_inputs("u")
    m.set_dynamical_equations(lambda x, u: -x + u)
    m.set_quadrature_functions(lambda x, u: x ** 2 + 0.1 * u ** 2)
    return m


def quad_discrete(lib):
    m = (JaxModel(discrete=True, dtype=jnp.float64) if lib is jnp
         else Model(discrete=True))
    m.set_dynamical_states("x")
    m.set_dynamical_equations(lambda x: 0.5 * x)
    m.set_quadrature_functions(lambda x: 3.0 * x)
    return m


QUAD_CASES = {
    "constant_rk4": (quad_const, dict(dt=0.25, integration_method="rk4"), [0.0]),
    "decay_rk4": (quad_decay, dict(dt=0.1, integration_method="rk4"), [1.0]),
    "decay_collocation": (quad_decay, dict(dt=0.1, integration_method="collocation",
                                           degree=3), [1.0]),
    "discrete": (quad_discrete, dict(dt=1.0), [8.0]),
}


@pytest.mark.parametrize("case", sorted(QUAD_CASES))
def test_quadratures_match_jax(case):
    build, kw, x0 = QUAD_CASES[case]
    mj, mt = _pair(build, **kw)
    for m in (mj, mt):
        m.set_initial_conditions(x0)
    u = np.full((3, mt.n_u), 0.3)
    out_t, out_j = mt.simulate(u=u, steps=3), mj.simulate(u=u, steps=3)
    _same(out_t, out_j, ("x", "y", "q"))
    assert out_t["q"].shape == (3, 1)
    if case == "constant_rk4":
        np.testing.assert_allclose(out_t["q"][:, 0], 0.5, atol=1e-12)
    if case == "discrete":
        np.testing.assert_allclose(out_t["q"][:, 0], 3.0 * out_t["x"][:, 0], atol=1e-12)
    batched = mt.simulate(x0=np.array([x0, x0]), u=u, steps=3)
    np.testing.assert_allclose(batched["q"][1], out_t["q"], atol=1e-14)


DSL_DAE = """
dx/dt = -x(t) + z(t) + u(k)
0 = z(t) - 0.5*x(t)
int = x(t)**2
y(k) = x(t) + z(t)
"""


def test_dsl_dae_with_quadrature_through_model_from():
    """A DSL model with algebraic and quadrature lines crosses over by its
    text (utils/interop.py:model_from) and simulates as JAX does."""
    mj = JaxModel(name="dsl_dae", dtype=jnp.float64)
    mj.set_equations(DSL_DAE)
    mt = model_from(mj)
    assert (mt.algebraic_states, mt.n_q, mt.measurements) == (["z"], 1, ["y"])
    mj.setup(dt=0.1)
    mt.setup(dt=0.1, device=CPU, dtype=F64)
    for m in (mj, mt):
        m.set_initial_conditions([1.0], z0=[0.5])
    u = np.full((4, 1), 0.2)
    _same(mt.simulate(u=u, steps=4), mj.simulate(u=u, steps=4))


# -- linearize, jacobians, discretize with z ------------------------------------

def test_linearize_and_jacobians_take_z():
    mj, mt = dae_nonlinear(jnp), dae_nonlinear(torch)
    mt.setup(dt=0.1, device=CPU, dtype=F64)
    assert not mt.is_linear
    lt = mt.linearize(x_eq=[0.4], u_eq=[0.1], z_eq=[0.3])
    lj = mj.linearize(x_eq=[0.4], u_eq=[0.1], z_eq=[0.3])
    for k in "ABCD":
        np.testing.assert_allclose(getattr(lt, k), getattr(lj, k), **TOL)
    At, Bt = mt.jacobians([0.4], [0.1], z=[0.3])
    Aj, Bj = mj.jacobians(jnp.asarray([0.4]), jnp.asarray([0.1]), z=jnp.asarray([0.3]))
    np.testing.assert_allclose(At.numpy(), np.asarray(Aj), **TOL)
    np.testing.assert_allclose(Bt.numpy(), np.asarray(Bj), **TOL)
    np.testing.assert_allclose(At.numpy(), [[-0.8 + 0.1]], **TOL)


@pytest.mark.parametrize("method", ["rk4", "collocation"])
def test_discretize_passes_the_algebraic_function(method):
    """One step of the continuous DAE as a discrete model; its setup solves
    z at the next state by Newton, as JAX's does."""
    mj = dae_golden(jnp).discretize(method, degree=2, dt=0.1)
    mt = dae_golden(torch).discretize(method, degree=2, dt=0.1)
    assert mt.discrete and mt.alg_fn() is not None
    _setup(mj, jnp, dt=0.1)
    _setup(mt, torch, dt=0.1)
    for m in (mj, mt):
        m.set_initial_conditions([0.3], z0=[0.15])
    u = np.full((5, 1), 0.4)
    out_t = mt.simulate(u=u, steps=5)
    _same(out_t, mj.simulate(u=u, steps=5), ("x", "z"))
    z, x = out_t["z"][:, 0], out_t["x"][:, 0]
    np.testing.assert_allclose(z - 0.5 * x - DAE_ALPHA * z ** 2, 0.0, atol=1e-12)


# -- NMPC ------------------------------------------------------------------------

def cstr_nmpc(lib, options, N=10):
    """tests/test_nmpc.py:make_cstr_nmpc's controller with |u| <= 5."""
    nmpc = (JaxNMPC(jax_cstr()) if lib is jnp else NMPC(cstr_schaffner_and_zeitz()))
    nmpc.horizon = N
    nmpc.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=CSTR_REF)
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    nmpc.set_box_constraints(u_lb=[-5.0], u_ub=[5.0])
    nmpc.set_parameters(CSTR_P)
    if lib is jnp:
        nmpc.setup(options=options)
    else:
        nmpc.setup(options=options, device=CPU, dtype=F64)
    return nmpc


def port_cstr_nmpc(options, N=10):
    return cstr_nmpc(torch, options, N)


def _solve_pair(jn, tn, x0s):
    jargs = jn.prepare_batch(x0s)
    targs = tn.prepare_batch(x0s)
    for a, b in zip(to_numpy(targs), jargs):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-13)
    jsol = jn.solve_batch_fn()(*jargs)
    tsol = to_numpy(tn.solve_batch_fn()(*to_torch(jargs, device=CPU)))
    np.testing.assert_array_equal(tsol.iterations, np.asarray(jsol.iterations))
    np.testing.assert_allclose(tsol.U, np.asarray(jsol.U), rtol=0, atol=1e-10)
    np.testing.assert_allclose(tsol.X, np.asarray(jsol.X), rtol=0, atol=1e-10)
    return tsol


COLLOC = {"dt": 0.1, "integration_method": "collocation", "degree": 2}


def test_cstr_collocation_nmpc_matches_jax():
    """tests/test_nmpc.py:88's controller: batch and closed loop against
    JAX, and within 1e-4 of the RK4 controller's first move."""
    jn, tn = cstr_nmpc(jnp, COLLOC), cstr_nmpc(torch, COLLOC)
    x0s = np.array(CSTR_X0) + 0.03 * np.random.default_rng(0).standard_normal((4, 2))
    sol = _solve_pair(jn, tn, x0s)
    assert sol.converged.all()
    ut, uj = tn.optimize(CSTR_X0), jn.optimize(CSTR_X0)
    assert tn.stats["iterations"] == jn.stats["iterations"]
    np.testing.assert_allclose(ut, uj, rtol=0, atol=1e-10)
    u_rk4 = port_cstr_nmpc({"dt": 0.1, "integration_method": "rk4"}).optimize(CSTR_X0)
    np.testing.assert_allclose(ut, u_rk4, atol=1e-4)


def _dae_nmpc(lib, model, N, ref, method, **opts):
    nmpc = (JaxNMPC if lib is jnp else NMPC)(model(lib))
    nmpc.horizon = N
    nmpc.quad_stage_cost.add_states(weights=5.0, ref=[ref])
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    options = {"dt": 0.2, "integration_method": method, **opts}
    if lib is jnp:
        nmpc.setup(options=options)
    else:
        nmpc.setup(options=options, device=CPU, dtype=F64)
    return nmpc


@pytest.mark.parametrize("method,degree", [("collocation", 2), ("rk4", 3),
                                           ("idas", 2)])
def test_dae_nmpc_matches_jax(method, degree):
    """tests/test_nmpc_breadth.py:22's controller under collocation, under
    RK4 with Newton-solved algebraic states, and under 'idas' (Radau of
    degree 3)."""
    jn = _dae_nmpc(jnp, dae_linear, 10, 1.0, method, degree=degree)
    tn = _dae_nmpc(torch, dae_linear, 10, 1.0, method, degree=degree)
    ut, uj = tn.optimize([0.0]), jn.optimize([0.0])
    assert tn.stats["converged"] and tn.stats["iterations"] == jn.stats["iterations"]
    np.testing.assert_allclose(ut, uj, rtol=0, atol=1e-10)
    X = tn.return_prediction()["x"]
    np.testing.assert_allclose(X, np.asarray(jn.return_prediction()["x"]), atol=1e-10)
    assert 0.5 < X[-1, 0] < 1.1
    if method == "collocation":
        _solve_pair(jn, tn, np.array([[0.0], [0.3], [-0.2]]))


def test_dae_matches_equivalent_ode():
    """tests/test_nmpc_breadth.py:40: the DAE under Radau degree 3 against
    x' = -0.5 x + u under RK4, 1e-5."""
    def ode(lib):
        m = Model(name="ode_equiv")
        m.set_dynamical_states("x")
        m.set_inputs("u")
        m.set_dynamical_equations(lambda x, u: -0.5 * x + u)
        return m
    u_dae = _dae_nmpc(torch, dae_linear, 8, 1.0, "collocation", degree=3).optimize([0.0])
    u_ode = _dae_nmpc(torch, ode, 8, 1.0, "rk4").optimize([0.0])
    np.testing.assert_allclose(u_dae, u_ode, atol=1e-5)


def port_dae_colloc(device=CPU, dtype=F64, options=None):
    """The port's twin of golden_configs.build_dae_colloc."""
    nmpc = NMPC(dae_golden(torch))
    nmpc.horizon = 12
    nmpc.quad_stage_cost.add_states(weights=[10.0], ref=[0.5])
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    nmpc.set_box_constraints(u_lb=[-2.0], u_ub=[2.0])
    nmpc.setup(options=options or {"dt": 0.1, "integration_method": "collocation",
                                   "degree": 3, "tol": 1e-9, "max_iter": 80},
               device=device, dtype=dtype)
    return nmpc


def test_golden_dae_colloc_config_matches_jax():
    jn, _ = build_dae_colloc()
    tn = port_dae_colloc()
    x0s = 0.1 + 0.2 * np.random.default_rng(4).standard_normal((2, 1))
    assert _solve_pair(jn, tn, x0s).converged.all()


def test_golden_dae_colloc_replay():
    """tests/golden/dae_colloc.npz through the port's optimize: every step
    converged and max|u - u_gold| < 1e-4 (tests/test_golden_parity.py)."""
    data = np.load(GOLDEN)
    tn = port_dae_colloc()
    devs = []
    for k in range(data["U_gold"].shape[0]):
        u = tn.optimize(data["X_meas"][k])
        assert tn.stats["converged"], (k, tn.stats)
        devs.append(float(np.abs(u - data["U_gold"][k]).max()))
    assert max(devs) < 1e-4, devs


PURE_NEWTON = {"tol": 1e-8, "max_iter": 30, "convexify": False, "n_linesearch": 1,
               "mehrotra": False}

GATE_CASES = {
    # (controller, the options that push its step's Newton above NEWTON_MAX)
    "collocation": (lambda o: port_cstr_nmpc({**COLLOC, **o}), {"degree": 9}),
    "cvodes": (lambda o: port_cstr_nmpc({"dt": 0.1, "integration_method": "cvodes", **o}),
               {"degree": 9}),
    "dae_rk4": (lambda o: port_dae_colloc(options={"dt": 0.1, "integration_method": "rk4",
                                                   **o}),
                {"integration_method": "collocation", "degree": 9}),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_whole_solve_gate_declines_implicit_integration(case):
    """pallas_full on an implicit step or a DAE model: taken without a
    warning (on CPU tensors the kernel's plain version, bit for bit; no
    Riccati launch); declined, with a warning naming NEWTON_MAX, only where
    the step's Newton has more unknowns than the cap."""
    build, above_cap = GATE_CASES[case]
    whole = build({**PURE_NEWTON, "pallas_full": True})
    x0s = (np.array(CSTR_X0) if whole._model.n_x == 2 else np.array([0.1])) \
        + 0.02 * np.random.default_rng(1).standard_normal((3, whole._model.n_x))
    args = whole.prepare_batch(x0s)
    n_ric = riccati_lq_cuda.launches
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        fn = whole.solve_batch_fn()
    assert whole._wip["eligible"], whole._wip["why"]
    plain = solve_ocp_full_reference(whole._funcs, whole._dims, whole._bounds, *args,
                                     whole._ip_opts)
    for x, y in zip(fn(*args), plain):
        assert torch.equal(x, y)
    assert riccati_lq_cuda.launches == n_ric
    big = build({**PURE_NEWTON, **above_cap, "pallas_full": True})
    with pytest.warns(UserWarning, match=r"a Newton of 18 unknowns .*NEWTON_MAX"):
        big.solve_batch_fn()


def test_emitter_refuses_implicit_steps():
    """_emit_step writes every implicit method (the Newton of
    csrc/implicit.cuh, d·nx unknowns) and an ERK step's algebraic Newton;
    it refuses a Newton above NEWTON_MAX."""
    for method in IMPLICIT_METHODS:
        lines, _ = codegen_cuda._emit_step(IntegratorSpec(method=method), 2)
        assert any("hm::newton<T, 6, 8>(w, rj);" in line for line in lines), method
    lines, _ = codegen_cuda._emit_step(IntegratorSpec(method="rk4"), 1, nz=1)
    assert sum("hm::newton<T, 1, 8>(zg, rj);" in line for line in lines) == 4
    with pytest.raises(NotImplementedError, match="NEWTON_MAX"):
        codegen_cuda._emit_step(IntegratorSpec(method="collocation", degree=9), 2)


# -- estimators on the DAE model ----------------------------------------------

def dae_np(x, u):
    """The golden DAE's state equation with z solved on its branch."""
    z = (1.0 - np.sqrt(1.0 - 4.0 * DAE_ALPHA * 0.5 * x[0])) / (2.0 * DAE_ALPHA)
    return np.array([-x[0] + z + u[0]])


def dae_trajectory(steps, dt=0.1, seed=0, noise=0.01):
    from golden_configs import rk4_np
    rng = np.random.default_rng(seed)
    U = 0.3 * np.sin(np.linspace(0, 3, steps))[:, None]
    x, Y = np.array([0.4]), []
    for k in range(steps):
        x = rk4_np(dae_np, x, U[k], dt)
        Y.append(x + noise * rng.standard_normal(1))
    return U, np.array(Y)


FILTERS = {"EKF": (JaxEKF, EKF, dict(rtol=0, atol=1e-10)),
           "UKF": (JaxUKF, UKF, dict(rtol=0, atol=1e-8))}


@pytest.mark.parametrize("method", ["rk4", "collocation"])
@pytest.mark.parametrize("name", sorted(FILTERS))
def test_kalman_filters_on_the_dae_match_jax(name, method):
    jax_cls, cls, tol = FILTERS[name]
    jf = jax_cls(dae_golden(jnp))
    jf.Q, jf.R = 1e-4, 1e-3
    jf.setup(dt=0.1, integration_method=method, degree=2)
    jf.set_initial_guess([0.3], P0=np.eye(1) * 0.1)
    tf = estimator_from(jf, device=CPU, dtype=F64, model=dae_golden(torch),
                        options={"integration_method": method, "degree": 2})
    assert type(tf) is cls
    U, Y = dae_trajectory(15)
    np.testing.assert_allclose(tf.estimate(Y, u=U), np.asarray(jf.estimate(Y, u=U)), **tol)
    for kind in ("x", "P", "y"):
        np.testing.assert_allclose(tf.solution[kind], jf.solution[kind], err_msg=kind,
                                   **tol)


def test_particle_filter_on_the_dae_matches_jax():
    jf = JaxPF(dae_golden(jnp), n_particles=200, roughening=True, seed=3)
    jf.Q, jf.R = 1e-4, 1e-3
    jf.setup(dt=0.1)
    jf.set_initial_guess([0.3], P0=np.eye(1) * 0.05)
    tf = estimator_from(jf, device=CPU, dtype=F64, model=dae_golden(torch))
    U, Y = dae_trajectory(4)
    jstep, key = jf.step_fn(), jax.random.PRNGKey(5)
    parts_j, parts_t = jnp.asarray(jf.particles), torch.as_tensor(tf.particles)
    p = np.zeros(0)
    for k in range(U.shape[0]):
        noise, offset, rgh = jax_draws(key, 200, 1)
        key, parts_j, xj, yj = jstep(key, parts_j, jnp.asarray(U[k]), jnp.asarray(p),
                                     jnp.asarray(Y[k]), 0.1 * k)
        parts_t, xt, yt = tf.step_draws(parts_t, torch.as_tensor(U[k]), torch.as_tensor(p),
                                        torch.as_tensor(Y[k]), 0.1 * k,
                                        torch.as_tensor(noise), torch.as_tensor(offset),
                                        torch.as_tensor(rgh))
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=1e-10)
        np.testing.assert_allclose(parts_t.numpy(), np.asarray(parts_j), rtol=0, atol=1e-10)


@pytest.mark.parametrize("method", ["rk4", "collocation"])
def test_mhe_on_the_dae_matches_jax(method):
    """MHE over DAE windows (JAX's spec takes the method, degree and
    substeps): x_est within 1e-8 and iterations within one, as
    tests/test_torch_mhe.py holds them."""
    opts = {"integration_method": method, "degree": 2, "tol": 1e-8}
    jm = JaxMHE(dae_golden(jnp))
    jm.horizon = 5
    jm.Q, jm.R, jm.P0 = 1e-4, 1e-3, 0.1 * np.eye(1)
    jm.set_initial_guess([0.3])
    jm.setup(dt=0.1, options=opts)
    tm = estimator_from(jm, device=CPU, dtype=F64, model=dae_golden(torch),
                        options={"integration_method": method, "degree": 2})
    assert tm.fast_path is jm.fast_path
    Ys, Us = [], []
    for s in range(3):
        U, Y = dae_trajectory(6, seed=s)
        Ys.append(Y)
        Us.append(U)
    Ys, Us = np.stack(Ys), np.stack(Us)
    xj, sj = jm.estimate_batch(Ys, Us)
    xt, st = tm.estimate_batch(Ys, Us)
    st = to_numpy(st)
    np.testing.assert_allclose(xt, np.asarray(xj), rtol=0, atol=1e-8)
    assert st.converged.all() and np.array_equal(st.converged, np.asarray(sj.converged))
    assert np.abs(st.iterations - np.asarray(sj.iterations)).max() <= 1


# -- on the card ---------------------------------------------------------------

@pytest.mark.cuda
def test_dae_nmpc_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda
    x0s = 0.1 + 0.2 * np.random.default_rng(4).standard_normal((64, 1))
    sols = []
    for device in ("cpu", "cuda"):
        tn = port_dae_colloc(device=device)
        riccati_lq_cuda.launches = 0
        sols.append(to_numpy(tn.solve_batch_fn()(*tn.prepare_batch(x0s))))
        assert (riccati_lq_cuda.launches > 0) == (device == "cuda")
    np.testing.assert_array_equal(sols[0].iterations, sols[1].iterations)
    np.testing.assert_allclose(sols[1].U, sols[0].U, rtol=0, atol=1e-9)


@pytest.mark.cuda
def test_dae_simulate_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    outs = []
    for device in ("cpu", "cuda"):
        m = branch_model(torch)
        m.setup(dt=0.1, device=device, dtype=F64)
        outs.append(m.simulate(x0=np.array([[1.0], [0.5]]), z0=np.array([[-1.0], [0.7]]),
                               steps=5))
    _same(outs[1], outs[0], ("x", "z"))
