"""PyTorch port: DSL, integrators and Model against the JAX package (CPU, f64)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hilo_mpc_tpu.library import cstr_schaffner_and_zeitz as jax_cstr
from hilo_mpc_tpu_torch.core.integrators import IntegratorSpec, make_step
from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz as torch_cstr
from hilo_mpc_tpu_torch.utils.parsing import parse_equations

torch.set_num_threads(1)
CPU = "cpu"
F64 = torch.float64


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=float), dtype=F64)


def _random_point(seed):
    rng = np.random.default_rng(seed)
    x = np.array([0.2, 0.1]) + 0.05 * rng.standard_normal(2)
    u = rng.standard_normal(1)
    p = 1.0 + 0.1 * rng.standard_normal(6)
    return x, u, p


def test_dsl_parse_matches_jax():
    mt, mj = torch_cstr(), jax_cstr()
    for attr in ("dynamical_states", "inputs", "parameters", "measurements"):
        assert getattr(mt, attr) == getattr(mj, attr)
    x, u, p = _random_point(0)
    ft = mt.ode_fn()(_t(x), _t([]), _t(u), _t(p), 0.0).numpy()
    fj = np.asarray(mj.ode_fn()(jnp.asarray(x), jnp.zeros(0), jnp.asarray(u),
                                jnp.asarray(p), 0.0))
    np.testing.assert_allclose(ft, fj, rtol=0, atol=1e-14)
    yt = mt.meas_fn()(_t(x), _t([]), _t(u), _t(p), 0.0).numpy()
    np.testing.assert_allclose(yt, [x[1]], rtol=0, atol=0)


def test_dsl_is_batch_first_and_transformable():
    """One call evaluates a batch; torch.func Jacobians match jax.jacfwd."""
    mt, mj = torch_cstr(), jax_cstr()
    pts = [_random_point(s) for s in range(5)]
    X = _t([a[0] for a in pts])
    U = _t([a[1] for a in pts])
    P = _t([a[2] for a in pts])
    f = mt.ode_fn()
    batched = f(X, X[..., :0], U, P, 0.0)
    assert batched.shape == (5, 2)
    for i in range(5):
        np.testing.assert_allclose(batched[i].numpy(),
                                   f(X[i], X[i, :0], U[i], P[i], 0.0).numpy(),
                                   rtol=0, atol=0)
    Jt = torch.func.vmap(torch.func.jacfwd(
        lambda x, u, p: f(x, x[:0], u, p, 0.0), argnums=(0, 1)))(X, U, P)
    for i, (x, u, p) in enumerate(pts):
        Jj = jax.jacfwd(lambda xx, uu: mj.ode_fn()(xx, jnp.zeros(0), uu,
                                                   jnp.asarray(p), 0.0),
                        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(u))
        for a, b in zip(Jt, Jj):
            np.testing.assert_allclose(a[i].numpy(), np.asarray(b), atol=1e-13)


@pytest.mark.parametrize("expr,expected", [
    ("sqrt(4) + exp(0)", 3.0), ("fmax(x, 2)", 2.0), ("atan2(x, 1)", np.arctan(1.0)),
    ("erf(x)", 0.8427007929497149), ("abs(-x) * pi", np.pi)])
def test_dsl_function_table(expr, expected):
    parsed = parse_equations(f"dx/dt = {expr}")
    out = parsed.ode(_t([1.0]), _t([]), _t([]), _t([]), 0.0)
    assert out.shape == (1,)
    np.testing.assert_allclose(out.numpy(), [expected], rtol=1e-12)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rk4_rollout_matches_jax(seed):
    """20 RK4 steps of the CSTR from a random state under random inputs and
    parameters: the port and hilo_mpc_tpu agree to 1e-12 (f64)."""
    rng = np.random.default_rng(seed)
    x0 = np.array([0.2, 0.1]) + 0.05 * rng.standard_normal(2)
    U = rng.standard_normal((20, 1))
    P = 1.0 + 0.1 * rng.standard_normal((20, 6))
    mj = jax_cstr()
    mj.setup(dt=0.1, integration_method="rk4")
    oj = mj.rollout_fn()(jnp.asarray(x0), jnp.zeros(0), jnp.asarray(U),
                         jnp.asarray(P), 0.0)
    mt = torch_cstr()
    mt.setup(dt=0.1, integration_method="rk4", device=CPU, dtype=F64)
    ot = mt.rollout_fn()(_t(x0), _t([]), _t(U), _t(P), 0.0)
    for key in ("x", "y"):
        np.testing.assert_allclose(ot[key].numpy(), np.asarray(oj[key]),
                                   rtol=0, atol=1e-12)


def test_simulate_batched_matches_unbatched():
    mt = torch_cstr()
    mt.setup(dt=0.1, integration_method="rk4", device=CPU, dtype=F64)
    mt.set_initial_conditions([0.2, 0.1])
    mt.set_initial_parameter_values([1.0] * 6)
    one = mt.simulate(u=np.tile([0.4], (5, 1)), steps=5)
    assert one["x"].shape == (5, 2)
    assert mt.solution["x"].shape == (2, 6)
    x0s = np.array([[0.2, 0.1], [0.25, 0.12], [0.2, 0.1]])
    many = mt.simulate(x0=x0s, u=np.tile([0.4], (5, 1)), steps=5)
    assert many["x"].shape == (3, 5, 2)
    np.testing.assert_allclose(many["x"][0], one["x"], rtol=0, atol=1e-15)
    np.testing.assert_allclose(many["x"][2], one["x"], rtol=0, atol=1e-15)
    # per-scenario inputs: (B, steps, n_u)
    U_b = np.stack([np.full((5, 1), 0.4), np.full((5, 1), -0.2), np.full((5, 1), 0.4)])
    per = mt.simulate(x0=x0s, u=U_b, steps=5)
    np.testing.assert_allclose(per["x"][0], one["x"], rtol=0, atol=1e-15)
    assert not np.allclose(per["x"][1], many["x"][1])


def test_substeps_and_erk_methods():
    mt = torch_cstr()
    spec1 = IntegratorSpec(method="rk4", substeps=1)
    spec2 = IntegratorSpec(method="rk4", substeps=2)
    x, u, p = (_t(a) for a in _random_point(3))
    s1 = make_step(mt.ode_fn(), None, 2, 0, spec1)
    s2 = make_step(mt.ode_fn(), None, 2, 0, spec2)
    half = s1(s1(x, x[:0], u, p, 0.0, 0.05)[0], x[:0], u, p, 0.05, 0.05)[0]
    np.testing.assert_allclose(s2(x, x[:0], u, p, 0.0, 0.1)[0].numpy(),
                               half.numpy(), atol=1e-15)
    with pytest.raises(ValueError):
        make_step(mt.ode_fn(), None, 2, 0, IntegratorSpec(method="nope"))


def test_setup_is_required():
    mt = torch_cstr()
    with pytest.raises(RuntimeError):
        mt.simulate(x0=[0.2, 0.1])


# -- the rest of Model: time variance, trajectory linearization, pickling ------

def _decay_models(time_varying):
    """x' = -a x (+ sin t) with input u, in both packages."""
    from hilo_mpc_tpu import Model as JaxModel
    from hilo_mpc_tpu_torch import Model
    extra = " + sin(t)" if time_varying else ""
    text = f"dx/dt = -a*x(t) + u(k){extra}"
    mj = JaxModel(dtype=jnp.float64)
    mj.set_equations(text)
    mt = Model().set_equations(text)
    return mj, mt


@pytest.mark.parametrize("time_varying", [False, True])
def test_is_time_variant_matches_jax(time_varying):
    mj, mt = _decay_models(time_varying)
    mt.setup(dt=0.1, device=CPU, dtype=F64)
    assert mt.is_time_variant is mj.is_time_variant is time_varying
    assert torch_cstr().is_time_variant is jax_cstr().is_time_variant is False


def test_linearize_trajectory_matches_jax():
    mj, mt = jax_cstr(), torch_cstr()
    p = _random_point(5)[2]
    for m in (mj, mt):
        m.set_initial_parameter_values(p)
    mj.setup(dt=0.1)
    mt.setup(dt=0.1, device=CPU, dtype=F64)
    rng = np.random.default_rng(6)
    X = np.array([0.2, 0.1]) + 0.05 * rng.standard_normal((6, 2))
    U = rng.standard_normal((5, 1))
    At, Bt = mt.linearize_trajectory(X, U, t0=0.3)
    Aj, Bj = mj.linearize_trajectory(X, U, t0=0.3)
    assert At.shape == (5, 2, 2) and Bt.shape == (5, 2, 1)
    np.testing.assert_allclose(At, np.asarray(Aj), rtol=0, atol=1e-13)
    np.testing.assert_allclose(Bt, np.asarray(Bj), rtol=0, atol=1e-13)


def _pickled_models():
    """A DSL model (re-parsed on load), a state-space model (closures rebuilt
    from the matrices) and a DSL DAE with a quadrature, set up and
    simulated before pickling."""
    from hilo_mpc_tpu import Model as JaxModel
    from hilo_mpc_tpu_torch import Model
    dae = """
    dx/dt = -x(t) + z(t) + u(k)
    0 = z(t) - 0.5*x(t)
    int = x(t)**2
    """
    out = {}
    for name, build in (("dsl", lambda M: M().set_equations(
                            "dx/dt = -a*x(t) + u(k)\ny(k) = 2*x(t)")),
                        ("state_space", lambda M: M().set_state_space(
                            A=[[0.0, 1.0], [-2.0, -0.5]], B=[[0.0], [1.0]],
                            C=[[1.0, 0.0]])),
                        ("dae_quadrature", lambda M: M().set_equations(dae))):
        out[name] = (build(lambda: JaxModel(dtype=jnp.float64)), build(Model))
    return out


@pytest.mark.parametrize("kind", ["dsl", "state_space", "dae_quadrature"])
def test_pickle_round_trip_matches_jax(kind):
    """A pickled model keeps its declaration, drops its step (rebuilt by
    setup()) and simulates as before — and as JAX's own round trip."""
    import pickle
    mj, mt = _pickled_models()[kind]
    p = [0.7] if mt.n_p else None
    z0 = [0.5] if mt.n_z else None
    for m, kw in ((mj, {}), (mt, dict(device=CPU, dtype=F64))):
        m.setup(dt=0.1, **kw)
        m.set_initial_conditions([1.0] * m.n_x, z0=z0)
        if p:
            m.set_initial_parameter_values(p)
        m.simulate(u=np.full((3, m.n_u), 0.2), steps=3)
    tj, tt = pickle.loads(pickle.dumps(mj)), pickle.loads(pickle.dumps(mt))
    assert not tt.is_setup() and tt._step is None
    for attr in ("dynamical_states", "algebraic_states", "inputs", "parameters",
                 "measurements", "n_q"):
        assert getattr(tt, attr) == getattr(mt, attr) == getattr(tj, attr), attr
    np.testing.assert_array_equal(tt.solution["x"], mt.solution["x"])
    tj.setup(dt=0.1)
    tt.setup(dt=0.1, device=CPU, dtype=F64)
    x0 = np.array([0.4] * tt.n_x)
    u = np.full((4, tt.n_u), -0.1)
    kw = dict(x0=x0, u=u, steps=4, store=False, **({"z0": [0.2]} if z0 else {}))
    out_t, out_j = tt.simulate(**kw), tj.simulate(**kw)
    for k in ("x", "y", "z", "q"):
        np.testing.assert_allclose(out_t[k], np.asarray(out_j[k]), rtol=0, atol=1e-12,
                                   err_msg=k)
    np.testing.assert_array_equal(out_t["x"], mt.simulate(**kw)["x"])


def test_summary_and_iteration():
    """The summary table and the (kind, names) iteration, as JAX's."""
    from hilo_mpc_tpu import Model as JaxModel
    from hilo_mpc_tpu_torch import Model
    text = "dx/dt = -x(t) + z(t)\n0 = z(t) - 0.5*x(t)"
    mj = JaxModel(name="dae").set_equations(text)
    mt = Model(name="dae").set_equations(text)
    assert str(mt) == str(mj)
    assert dict(mt) == dict(mj)
