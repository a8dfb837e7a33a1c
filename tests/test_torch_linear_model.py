"""PyTorch port: the linear-model family (state space, discrete-time models,
is_linear, jacobians, linearize, discretize) against the JAX package
(CPU, float64)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hilo_mpc_tpu import Model as JaxModel
from hilo_mpc_tpu.library import cstr_schaffner_and_zeitz as jax_cstr
from hilo_mpc_tpu_torch import Model
from hilo_mpc_tpu_torch.core.integrators import IntegratorSpec, make_step
from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz as torch_cstr
from hilo_mpc_tpu_torch.utils.interop import linear_model_from

torch.set_num_threads(1)
CPU = "cpu"
F64 = torch.float64
CSTR_P = [1.0] * 6


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=float), dtype=F64)


def report(what, actual, desired):
    """Largest absolute deviation over the pairs of arrays, printed so that
    ``pytest -rP`` shows the sizes ROADMAP.md §C records."""
    dev = max(float(np.max(np.abs(np.asarray(a, float) - np.asarray(b, float)),
                           initial=0.0)) for a, b in zip(actual, desired))
    print(f"{what}: max abs deviation {dev:.3e}")
    return dev


def random_state_space(seed, nx=3, nu=2, ny=2):
    rng = np.random.default_rng(seed)
    return (np.eye(nx) + 0.1 * rng.standard_normal((nx, nx)),
            rng.standard_normal((nx, nu)), rng.standard_normal((ny, nx)),
            rng.standard_normal((ny, nu)))


def jax_pendulum():
    m = JaxModel(name="pend")
    m.set_dynamical_states(["phi", "omega"])
    m.set_inputs("tau")
    m.set_dynamical_equations(
        lambda x, u: jnp.array([x[1], -jnp.sin(x[0]) - 0.2 * x[1] + u[0]]))
    return m


def torch_pendulum():
    """Forced damped pendulum; an equilibrium at x = [pi/2, 0], u = 1."""
    m = Model(name="pend")
    m.set_dynamical_states(["phi", "omega"])
    m.set_inputs("tau")
    m.set_dynamical_equations(lambda x, u: torch.stack(
        [x[..., 1], -torch.sin(x[..., 0]) - 0.2 * x[..., 1] + u[..., 0]], dim=-1))
    return m


def test_state_space_matches_jax():
    A, B, C, D = random_state_space(0)
    mj = JaxModel(discrete=True)
    mj.set_state_space(A=A, B=B, C=C, D=D)
    mt = Model(discrete=True).set_state_space(A=A, B=B, C=C, D=D)
    for attr in ("dynamical_states", "inputs", "measurements"):
        assert getattr(mt, attr) == getattr(mj, attr)
    for key in "ABCD":
        np.testing.assert_array_equal(getattr(mt, key), getattr(mj, key))
    rng = np.random.default_rng(1)
    X, U = rng.standard_normal((5, 3)), rng.standard_normal((5, 2))
    ft = mt.ode_fn()(_t(X), _t([]), _t(U), _t([]), 0.0).numpy()
    yt = mt.meas_fn()(_t(X), _t([]), _t(U), _t([]), 0.0).numpy()
    for i in range(5):
        args = (jnp.asarray(X[i]), jnp.zeros(0), jnp.asarray(U[i]), jnp.zeros(0), 0.0)
        np.testing.assert_allclose(ft[i], np.asarray(mj.ode_fn()(*args)), atol=1e-14)
        np.testing.assert_allclose(yt[i], np.asarray(mj.meas_fn()(*args)), atol=1e-14)
    # the setters redeclare one matrix and keep the others
    mt.A = 2 * A
    np.testing.assert_array_equal(mt.A, 2 * A)
    np.testing.assert_array_equal(mt.B, B)


@pytest.mark.parametrize("kw", [
    dict(A=np.ones((2, 3))),
    dict(A=np.eye(2), B=np.ones((3, 1))),
    dict(A=np.eye(2), C=np.ones((1, 3))),
    dict(A=np.eye(2), B=np.ones((2, 1)), D=np.ones((1, 2))),
    dict(A=np.eye(2), B=np.ones((2, 1)), C=np.ones((2, 2)), D=np.ones((1, 1))),
], ids=["A_square", "B_rows", "C_cols", "D_cols", "D_rows"])
def test_state_space_validation_matches_jax(kw):
    with pytest.raises(ValueError) as ej:
        JaxModel().set_state_space(**kw)
    with pytest.raises(ValueError) as et:
        Model().set_state_space(**kw)
    assert str(et.value) == str(ej.value)


def test_discrete_simulate_matches_jax():
    A, B, C, D = random_state_space(2)
    mj = JaxModel(discrete=True, dtype=jnp.float64)
    mj.set_state_space(A=A, B=B, C=C, D=D)
    mj.setup(dt=0.1, integration_method="rk4")      # discrete wins over rk4
    mt = linear_model_from(mj)
    mt.setup(dt=0.1, integration_method="rk4", device=CPU, dtype=F64)
    assert mt._int_spec.method == "discrete"
    U = np.random.default_rng(3).standard_normal((10, 2))
    for m in (mj, mt):
        m.set_initial_conditions([1.0, -0.5, 0.2])
    oj, ot = mj.simulate(u=U, steps=10), mt.simulate(u=U, steps=10)
    report("discrete state-space simulate x, y", [ot["x"], ot["y"]],
           [oj["x"], oj["y"]])
    for key in ("x", "y"):
        np.testing.assert_allclose(ot[key], np.asarray(oj[key]), atol=1e-12)
    # x+ = A x + B u, step by step
    x = np.array([1.0, -0.5, 0.2])
    for k in range(10):
        x = A @ x + B @ U[k]
        np.testing.assert_allclose(ot["x"][k], x, atol=1e-12)
    x0s = np.random.default_rng(4).standard_normal((4, 3))
    batched = mt.simulate(x0=x0s, u=U, steps=10)
    ref = mj.simulate(x0=x0s, u=U, steps=10)
    np.testing.assert_allclose(batched["x"], np.asarray(ref["x"]), atol=1e-12)


def test_discrete_step_factory():
    step = make_step(lambda x, z, u, p, t: 2 * x + u, None, 1, 0,
                     IntegratorSpec(method="discrete"))
    x, z = step(_t([1.0]), _t([]), _t([0.5]), _t([]), 0.0, 0.1)
    assert x.item() == 2.5 and z.numel() == 0


def _cubic(torch_side):
    if torch_side:
        m = Model()
        m.set_dynamical_states("x")
        m.set_dynamical_equations(lambda x: -x ** 3)
        return m
    m = JaxModel()
    m.set_dynamical_states("x")
    m.set_dynamical_equations(lambda x: -x ** 3)
    return m


def _affine(torch_side):
    """x' = Mx + Bu + c, declared by a callable (probed, not declared)."""
    M = np.array([[0.0, 1.0], [-2.0, -0.3]])
    if torch_side:
        m = Model()
        m.set_dynamical_states(["a", "b"])
        m.set_inputs("u")
        Mt = _t(M)
        m.set_dynamical_equations(lambda x, u: x @ Mt.T.to(x.dtype) + torch.cat(
            [torch.zeros_like(u), u], dim=-1) + 0.5)
        return m
    m = JaxModel()
    m.set_dynamical_states(["a", "b"])
    m.set_inputs("u")
    m.set_dynamical_equations(
        lambda x, u: jnp.asarray(M) @ x + jnp.concatenate([jnp.zeros(1), u]) + 0.5)
    return m


LINEARITY = {
    "state_space": (lambda ts: (Model() if ts else JaxModel()).set_state_space(
        A=[[0.0, 1.0], [0.0, 0.0]], B=[[0.0], [1.0]]), True),
    "affine_callable": (_affine, True),
    "cstr": (lambda ts: torch_cstr() if ts else jax_cstr(), False),
    "cubic": (_cubic, False),
}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", sorted(LINEARITY))
def test_is_linear_matches_jax(case, dtype):
    """The probe runs in the model's dtype with that dtype's tolerances: a
    float32 model of a linear map reads as linear."""
    build, expected = LINEARITY[case]
    assert build(False).is_linear is expected
    mt = build(True)
    mt._dtype = getattr(torch, dtype)
    assert mt.is_linear is expected


def test_jacobians_cstr_matches_jax():
    mj, mt = jax_cstr(), torch_cstr()
    mj._dtype = jnp.float64
    mj.set_initial_parameter_values(CSTR_P)
    mt.set_initial_parameter_values(CSTR_P)
    mt.setup(dt=0.1, device=CPU, dtype=F64)
    rng = np.random.default_rng(5)
    for _ in range(3):
        x = np.array([0.2, 0.1]) + 0.1 * rng.standard_normal(2)
        u = rng.standard_normal(1)
        report("CSTR jacobians (A, B)", mt.jacobians(x, u), mj.jacobians(x, u))
        for a, b in zip(mt.jacobians(x, u), mj.jacobians(x, u)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-10)


def _cstr_equilibrium(x1=0.3):
    """A CSTR equilibrium at x_1 = x1: x_2 from dx_1/dt = 0, then u."""
    from scipy.optimize import brentq
    r = lambda x2: (1 - x1) * np.exp(-1.0 / (1.0 + x2))
    x2 = brentq(lambda x2: -x1 + r(x2), -0.5, 5.0, xtol=1e-15)
    return np.array([x1, x2]), np.array([x2 - r(x2)])


@pytest.mark.parametrize("model", ["cstr", "pendulum"])
def test_linearize_matches_jax(model):
    if model == "cstr":
        mj, mt = jax_cstr(), torch_cstr()
        x_eq, u_eq = _cstr_equilibrium()
        for m in (mj, mt):
            m.set_initial_parameter_values(CSTR_P)
    else:
        mj, mt = jax_pendulum(), torch_pendulum()
        x_eq, u_eq = np.array([np.pi / 2, 0.0]), np.array([1.0])
    lj = mj.linearize(x_eq=x_eq, u_eq=u_eq)
    lt = mt.linearize(x_eq=x_eq, u_eq=u_eq)
    for attr in ("dynamical_states", "inputs", "measurements", "discrete"):
        assert getattr(lt, attr) == getattr(lj, attr)
    report(f"{model} linearize (A, B, C, D)", [getattr(lt, k) for k in "ABCD"],
           [getattr(lj, k) for k in "ABCD"])
    for key in "ABCD":
        np.testing.assert_allclose(getattr(lt, key), getattr(lj, key),
                                   rtol=0, atol=1e-10)
    assert lt.is_linear and lt.linearize() is lt
    # deferred: simulate raises until the equilibrium is set
    dj, dt_ = mj.linearize(), mt.linearize()
    dt_.setup(dt=0.01, device=CPU, dtype=F64)
    dt_.set_initial_conditions(np.zeros(2))
    with pytest.raises(RuntimeError, match="equilibrium"):
        dt_.simulate(u=0.1, steps=1)
    for m in (dj, dt_):
        with pytest.raises(ValueError, match="not an equilibrium"):
            m.set_equilibrium_point(x_eq + 0.1, u_eq)
        m.set_equilibrium_point(x_eq, u_eq)
    for key in "ABCD":
        np.testing.assert_allclose(getattr(dt_, key), getattr(dj, key), atol=1e-10)
    out = dt_.simulate(u=np.zeros((3, 1)), steps=3)
    assert np.all(np.isfinite(out["x"]))


def test_discretize_matches_jax():
    """One RK4 step as a discrete model: rollouts and the discrete
    linearization agree with the JAX package."""
    mj, mt = jax_cstr(), torch_cstr()
    mj._dtype = jnp.float64
    for m in (mj, mt):
        m.set_initial_parameter_values(CSTR_P)
    dj, dt_ = mj.discretize("rk4"), mt.discretize("rk4")
    assert dt_.discrete and not mt.discrete
    dj.setup(dt=0.1)
    dt_.setup(dt=0.1, device=CPU, dtype=F64)
    U = np.random.default_rng(6).standard_normal((8, 1))
    for m in (dj, dt_):
        m.set_initial_conditions([0.2, 0.1])
    oj, ot = dj.simulate(u=U, steps=8), dt_.simulate(u=U, steps=8)
    report("CSTR discretize(rk4) rollout", [ot["x"]], [oj["x"]])
    np.testing.assert_allclose(ot["x"], np.asarray(oj["x"]), rtol=0, atol=1e-12)
    # the continuous model's own RK4 rollout is the same map
    mt.setup(dt=0.1, integration_method="rk4", device=CPU, dtype=F64)
    mt.set_initial_conditions([0.2, 0.1])
    np.testing.assert_allclose(mt.simulate(u=U, steps=8)["x"], ot["x"], atol=1e-15)
    x_eq, u_eq = _cstr_equilibrium()
    lj = dj.linearize(x_eq=x_eq, u_eq=u_eq)
    lt = dt_.linearize(x_eq=x_eq, u_eq=u_eq)
    assert lt.discrete
    for key in "AB":
        np.testing.assert_allclose(getattr(lt, key), getattr(lj, key), atol=1e-10)
    with pytest.raises(RuntimeError, match="already discrete"):
        dt_.discretize()
