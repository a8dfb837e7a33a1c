"""PyTorch port: the implicit integrators of core/integrators.py against the
JAX package (CPU, float64).

- The collocation basis (Radau IIA and Gauss-Legendre, degrees 1-5): nodes
  and the C, D, B matrices to 1e-13.
- ``newton_solve``: the value after its Newton steps, and the implicit
  derivative under ``jvp``, ``vmap`` of ``jvp`` (the Jacobian) and ``grad``,
  against ``lax.custom_root`` on √a and on a 2-D system, to 1e-12.
- The collocation step against ``make_collocation_step`` (each JAX step
  vmapped over a batch of 4): decay, the stiff λ = -500 with 10 Newton
  steps, the index-1 DAE of tests/test_integrators.py:91-98 and Legendre
  nodes; its derivative with respect to a parameter; the ERK and discrete
  steps with algebraic states; the ``cvodes``/``idas`` mapping; substeps
  carrying z; a float32 step stays float32; on a card, the step against the
  CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, jvp, vmap

from hilo_mpc_tpu.core import integrators as JI
from hilo_mpc_tpu_torch.core import integrators as TI
from hilo_mpc_tpu_torch.core.integrators import IntegratorSpec, make_step

torch.set_num_threads(1)
F64 = torch.float64
TOL = dict(rtol=0, atol=1e-12)
B = 4


def _t(a, dtype=F64):
    return torch.as_tensor(np.asarray(a, dtype=float), dtype=dtype)


@pytest.mark.parametrize("scheme", ["radau", "legendre"])
@pytest.mark.parametrize("degree", [1, 2, 3, 4, 5])
def test_collocation_basis_matches_jax(scheme, degree):
    np.testing.assert_allclose(TI.collocation_points(degree, scheme),
                               JI.collocation_points(degree, scheme), rtol=0, atol=1e-13)
    for a, b in zip(TI.collocation_coefficients(degree, scheme),
                    JI.collocation_coefficients(degree, scheme)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-13)
    C, D, Bq, taus = TI.collocation_coefficients(degree, scheme)
    # the quadrature weights integrate polynomials of degree < d exactly
    np.testing.assert_allclose(Bq.sum(), 1.0, atol=1e-13)
    if scheme == "radau":
        assert taus[-1] == pytest.approx(1.0)


# -- newton_solve against lax.custom_root -------------------------------------

def _sqrt_res(lib):
    return lambda w, a: w * w - a


def _system_res(lib):
    stack = jnp.stack if lib is jnp else torch.stack

    def res(w, a):
        return stack([w[..., 0] ** 2 + w[..., 1] - a[..., 0],
                      w[..., 0] + w[..., 1] ** 3 - a[..., 1]], -1)
    return res


NEWTON_PROBLEMS = {
    # (residual factory, a, w0, iterations)
    "sqrt": (_sqrt_res, [4.0], [1.0], 8),
    "system_2d": (_system_res, [1.3, 0.7], [0.8, 0.5], 8),
}


def _newton_pair(name):
    mk, a, w0, iters = NEWTON_PROBLEMS[name]
    rj, rt = mk(jnp), mk(torch)

    def fj(aa):
        return JI.newton_solve(lambda w: rj(w, aa), jnp.asarray(w0), iters=iters)

    def ft(aa):
        return TI.newton_solve(rt, _t(w0), aa, iters=iters)
    return fj, ft, np.asarray(a)


@pytest.mark.parametrize("mode", ["value", "jvp", "vmap_jvp", "grad"])
@pytest.mark.parametrize("name", sorted(NEWTON_PROBLEMS))
def test_newton_solve_implicit_derivatives_match_custom_root(name, mode):
    fj, ft, a = _newton_pair(name)
    aj, at = jnp.asarray(a), _t(a)
    if mode == "value":
        out_j, out_t = fj(aj), ft(at)
    elif mode == "jvp":
        v = np.linspace(0.3, 1.1, a.size)
        out_j = jax.jvp(fj, (aj,), (jnp.asarray(v),))[1]
        out_t = jvp(ft, (at,), (_t(v),))[1]
    elif mode == "vmap_jvp":
        out_j = jax.jacfwd(fj)(aj)
        eye = torch.eye(a.size, dtype=F64)
        out_t = vmap(lambda v: jvp(ft, (at,), (v,))[1])(eye).T
    else:
        out_j = jax.grad(lambda aa: fj(aa).sum())(aj)
        out_t = grad(lambda aa: ft(aa).sum())(at)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)


def test_newton_solve_derivative_is_the_implicit_one():
    """d√a/da = 1/(2√a), whatever the Newton steps did; the steps run once
    under vmap of tangents (the primal carries no tangent batch)."""
    calls = []

    def res(w, a):
        calls.append(w.shape)
        return w * w - a

    a = _t([4.0, 9.0])
    J = vmap(lambda v: jvp(lambda aa: TI.newton_solve(res, _t([1.0, 1.0]), aa),
                           (a,), (v,))[1])(torch.eye(2, dtype=F64))
    np.testing.assert_allclose(J.numpy(), np.diag([0.25, 1.0 / 6.0]), **TOL)
    assert all(s == (2,) for s in calls), calls


# -- the collocation step -----------------------------------------------------

def _decay(lam, lib):
    return lambda x, z, u, p, t: lam * x


def _dae_ode(lib):
    return lambda x, z, u, p, t: -x + z


def _dae_alg(lib):
    sin = jnp.sin if lib is jnp else torch.sin
    return lambda x, z, u, p, t: z - sin(x)


def _forced_ode(lib):
    cos = jnp.cos if lib is jnp else torch.cos
    # time-varying, with an input and a parameter: every argument reaches f;
    # t is batch-first, (...) against x's (..., nx)
    return lambda x, z, u, p, t: p[..., :1] * x + u[..., :1] * cos(t[..., None] + x)


COLLOCATION_CASES = {
    # (ode, alg, nx, nz, degree, scheme, iterations, dt)
    "decay": (lambda lib: _decay(-1.3, lib), None, 1, 0, 3, "radau", 8, 0.2),
    "stiff": (lambda lib: _decay(-500.0, lib), None, 1, 0, 3, "radau", 10, 0.1),
    "dae_index1": (_dae_ode, _dae_alg, 1, 1, 3, "radau", 12, 0.05),
    "legendre": (_forced_ode, None, 1, 0, 3, "legendre", 8, 0.1),
    "radau_degree5": (_forced_ode, None, 1, 0, 5, "radau", 8, 0.1),
}


def _batch(nx, nz, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.5, 1.5, (B, nx)), rng.uniform(0.5, 1.0, (B, nz)),
            rng.standard_normal((B, 1)), rng.uniform(-1.0, -0.5, (B, 1)),
            rng.uniform(0.0, 1.0, B))


def _run_pair(jstep, tstep, nx, nz, dt, seed=0):
    x, z, u, p, t = _batch(nx, nz, seed)
    xj, zj = jax.vmap(lambda *a: jstep(*a, dt))(*map(jnp.asarray, (x, z, u, p, t)))
    xt, zt = tstep(*map(_t, (x, z, u, p, t)), dt)
    return (xt, zt), (xj, zj)


@pytest.mark.parametrize("case", sorted(COLLOCATION_CASES))
def test_collocation_step_matches_jax(case):
    ode, alg, nx, nz, d, scheme, iters, dt = COLLOCATION_CASES[case]
    jstep = JI.make_collocation_step(ode(jnp), alg and alg(jnp), nx=nx, nz=nz,
                                     degree=d, scheme=scheme, newton_iters=iters)
    tstep = TI.make_collocation_step(ode(torch), alg and alg(torch), nx=nx, nz=nz,
                                     degree=d, scheme=scheme, newton_iters=iters)
    (xt, zt), (xj, zj) = _run_pair(jstep, tstep, nx, nz, dt)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), **TOL)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), **TOL)
    if case == "dae_index1":
        np.testing.assert_allclose(zt.numpy(), np.sin(xt.numpy()), atol=1e-9)
    if case == "stiff":
        # L-stable: a few steps at λ·dt = -50 decay instead of blowing up
        x = xt
        for _ in range(4):
            x, _ = tstep(x, zt, _t(np.zeros((B, 1))), _t(np.zeros((B, 1))), 0.0, dt)
        assert float(x.abs().max()) < 1.0


def test_collocation_step_derivative_matches_jax():
    """The step's Jacobian in (x, p) through the Newton solve (jvp under
    vmap, as the interior point linearizes) against jax.jacfwd, per
    scenario."""
    ode = _forced_ode
    jstep = JI.make_collocation_step(ode(jnp), nx=1, degree=2)
    tstep = TI.make_collocation_step(ode(torch), nx=1, degree=2)
    x, z, u, p, t = _batch(1, 0, seed=3)
    zt = _t(np.zeros((B, 0)))

    def ft(xx, pp):
        return tstep(xx, zt, _t(u), pp, _t(t), 0.1)[0]
    xt_, pt_ = _t(x), _t(p)
    basis = torch.eye(2, dtype=F64)[:, None, :].expand(2, B, 2)
    J = vmap(lambda v: jvp(ft, (xt_, pt_), (v[..., :1], v[..., 1:]))[1])(basis)
    for i in range(B):
        Jj = jax.jacfwd(lambda xx, pp: jstep(xx, jnp.zeros(0), jnp.asarray(u[i]), pp,
                                             t[i], 0.1)[0], argnums=(0, 1))(
            jnp.asarray(x[i]), jnp.asarray(p[i]))
        np.testing.assert_allclose(J[:, i, 0].numpy(),
                                   np.concatenate([np.asarray(a)[0] for a in Jj]), **TOL)


@pytest.mark.parametrize("degree", [2, 3])
def test_collocation_jacobian_under_vmap_of_jacfwd(degree):
    """vmap over scenarios of jacfwd through a collocation step whose Newton
    has more than 3 unknowns (a 2-state model): the tangents' solve is LU
    and triangular solves, because torch.linalg.solve gives wrong tangents
    in this composition (NaN and other scenarios' values); against jacfwd of
    each scenario alone and jax.jacfwd."""
    def rows(x, u, p):
        return [-x[..., 0] + u[..., 0] * x[..., 1] ** 2, -x[..., 1] * x[..., 0] + p[..., 0]]
    tstep = TI.make_collocation_step(
        lambda x, z, u, p, t: torch.stack(rows(x, u, p), dim=-1), nx=2, degree=degree)
    jstep = JI.make_collocation_step(
        lambda x, z, u, p, t: jnp.stack(rows(x, u, p), axis=-1), nx=2, degree=degree)
    rng = np.random.default_rng(11)
    x = rng.uniform(-0.5, 0.5, (B, 2))
    u, p = rng.standard_normal((B, 1)), rng.standard_normal((B, 1))
    z0 = torch.zeros(0, dtype=F64)

    def f(xx, uu, pp):
        return tstep(xx, z0, uu, pp, 0.0, 0.1)[0]
    J = vmap(torch.func.jacfwd(f, argnums=(0, 1)))(_t(x), _t(u), _t(p))
    for i in range(B):
        Ji = torch.func.jacfwd(f, argnums=(0, 1))(_t(x[i]), _t(u[i]), _t(p[i]))
        Jj = jax.jacfwd(lambda xx, uu: jstep(xx, jnp.zeros(0), uu, jnp.asarray(p[i]),
                                             0.0, 0.1)[0], argnums=(0, 1))(
            jnp.asarray(x[i]), jnp.asarray(u[i]))
        for a, b, c in zip(J, Ji, Jj):
            np.testing.assert_allclose(a[i].numpy(), b.numpy(), **TOL)
            np.testing.assert_allclose(a[i].numpy(), np.asarray(c), **TOL)


# -- algebraic states in the ERK and discrete steps ---------------------------

@pytest.mark.parametrize("method", ["rk4", "euler", "midpoint"])
def test_erk_step_with_algebraic_states_matches_jax(method):
    jstep = JI.make_erk_step(_dae_ode(jnp), _dae_alg(jnp), nz=1, method=method)
    tstep = TI.make_erk_step(_dae_ode(torch), _dae_alg(torch), nz=1, method=method)
    (xt, zt), (xj, zj) = _run_pair(jstep, tstep, 1, 1, 0.05, seed=1)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), **TOL)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), **TOL)
    np.testing.assert_allclose(zt.numpy(), np.sin(xt.numpy()), atol=1e-12)


def test_discrete_step_with_algebraic_states_matches_jax():
    f = lambda lib: (lambda x, z, u, p, t: 0.9 * x + 0.1 * z + u)  # noqa: E731
    jstep = JI.make_discrete_step(f(jnp), _dae_alg(jnp), nz=1)
    tstep = TI.make_discrete_step(f(torch), _dae_alg(torch), nz=1)
    (xt, zt), (xj, zj) = _run_pair(jstep, tstep, 1, 1, 0.1, seed=2)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), **TOL)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), **TOL)


@pytest.mark.parametrize("method", ["cvodes", "idas", "irk"])
def test_sundials_names_map_to_collocation(method):
    """'cvodes' and 'idas' build Radau collocation of degree max(d, 3);
    'irk' is collocation of the given degree and scheme — as the JAX
    make_step dispatches."""
    spec = IntegratorSpec(method=method, degree=2, scheme="legendre")
    jstep = JI.make_step(_dae_ode(jnp), _dae_alg(jnp), 1, 1,
                         JI.IntegratorSpec(method=method, degree=2, scheme="legendre"))
    tstep = make_step(_dae_ode(torch), _dae_alg(torch), 1, 1, spec)
    (xt, zt), (xj, zj) = _run_pair(jstep, tstep, 1, 1, 0.1)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), **TOL)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), **TOL)
    want = (TI.make_collocation_step(_dae_ode(torch), _dae_alg(torch), nx=1, nz=1,
                                     degree=3, scheme="radau")
            if method != "irk" else
            TI.make_collocation_step(_dae_ode(torch), _dae_alg(torch), nx=1, nz=1,
                                     degree=2, scheme="legendre"))
    (xw, _), _ = _run_pair(jstep, want, 1, 1, 0.1)
    np.testing.assert_array_equal(xt.numpy(), xw.numpy())


def test_substeps_carry_the_algebraic_state():
    spec = IntegratorSpec(method="collocation", degree=2, substeps=3)
    jstep = JI.make_step(_dae_ode(jnp), _dae_alg(jnp), 1, 1,
                         JI.IntegratorSpec(method="collocation", degree=2, substeps=3))
    tstep = make_step(_dae_ode(torch), _dae_alg(torch), 1, 1, spec)
    (xt, zt), (xj, zj) = _run_pair(jstep, tstep, 1, 1, 0.15)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), **TOL)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), **TOL)
    np.testing.assert_allclose(zt.numpy(), np.sin(xt.numpy()), atol=1e-10)


FLOAT32_STEPS = {
    "collocation": lambda: TI.make_collocation_step(_dae_ode(torch), _dae_alg(torch),
                                                    nx=1, nz=1, degree=3),
    "erk_dae": lambda: TI.make_erk_step(_dae_ode(torch), _dae_alg(torch), nz=1),
    "discrete_dae": lambda: TI.make_discrete_step(_dae_ode(torch), _dae_alg(torch), nz=1),
}


@pytest.mark.parametrize("kind", sorted(FLOAT32_STEPS))
def test_float32_step_stays_float32(kind):
    step = FLOAT32_STEPS[kind]()
    x, z, u, p, t = _batch(1, 1)
    f32 = torch.float32
    x32, z32 = step(_t(x, f32), _t(z, f32), _t(u, f32), _t(p, f32), _t(t, f32), 0.05)
    assert x32.dtype == f32 and z32.dtype == f32
    x64, z64 = step(_t(x), _t(z), _t(u), _t(p), _t(t), 0.05)
    np.testing.assert_allclose(x32.numpy(), x64.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(z32.numpy(), z64.numpy(), rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dae_index1", "legendre"])
def test_collocation_step_on_card_matches_cpu(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ode, alg, nx, nz, d, scheme, iters, dt = COLLOCATION_CASES[case]
    step = TI.make_collocation_step(ode(torch), alg and alg(torch), nx=nx, nz=nz,
                                    degree=d, scheme=scheme, newton_iters=iters)
    args = _batch(nx, nz)
    xc, zc = step(*map(_t, args), dt)
    xg, zg = step(*[_t(a).cuda() for a in args], dt)
    np.testing.assert_allclose(xg.cpu().numpy(), xc.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(zg.cpu().numpy(), zc.numpy(), rtol=0, atol=1e-12)
